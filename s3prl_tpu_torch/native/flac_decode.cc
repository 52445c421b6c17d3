// First-party FLAC decoder (container + all subframe types), no third-party
// dependencies (a copy of s3prl_tpu/native/flac_decode.cc; bound by
// s3prl_tpu_torch/data/flac.py). Replaces the torchaudio/sox decode path the reference uses
// for LibriSpeech-style corpora (s3prl/run_downstream.py:157; SURVEY §2.9
// plans a native reader). Implements the public FLAC format spec
// (datatracker.ietf.org/doc/rfc9639): STREAMINFO metadata, frame headers,
// constant / verbatim / fixed / LPC subframes, rice-coded residual
// partitions, stereo decorrelation (left-side / right-side / mid-side) and
// wasted bits. CRCs are parsed but not verified (decode speed; corrupt input
// yields an error from structural checks instead).
//
// C ABI (ctypes): flac_info() reads STREAMINFO; flac_decode() fills an
// int32 interleaved buffer and returns per-channel frame count.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t byte = 0;
  int bit = 0;  // bits consumed of data[byte], MSB first
  bool error = false;

  bool eof() const { return byte >= size; }

  uint64_t bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= size) {
        error = true;
        return 0;
      }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      v = (v << take) | ((data[byte] >> shift) & ((1u << take) - 1));
      bit += take;
      n -= take;
      if (bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }

  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n == 0) return 0;
    if (v & (1ull << (n - 1))) return (int64_t)(v | (~0ull << n));
    return (int64_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!error && bits(1) == 0) {
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        error = true;
        return 0;
      }
    }
    return q;
  }

  void align() {
    if (bit != 0) {
      bit = 0;
      ++byte;
    }
  }
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

// stop_after_info: return once STREAMINFO is parsed (the spec mandates it
// is the first metadata block) — lets flac_info() work from a truncated
// header read even when later blocks (PICTURE, big VORBIS_COMMENT) exceed
// the buffer. The decoder passes false and skips ALL blocks to reach the
// first frame.
bool parse_metadata(Reader& r, StreamInfo* info, bool stop_after_info = false) {
  if (r.size < 4 || memcmp(r.data, "fLaC", 4) != 0) return false;
  r.byte = 4;
  bool last = false;
  bool have_info = false;
  while (!last && !r.error) {
    last = r.bits(1);
    uint32_t type = (uint32_t)r.bits(7);
    uint32_t len = (uint32_t)r.bits(24);
    if (type == 0) {  // STREAMINFO
      r.bits(16);  // min block size
      r.bits(16);  // max block size
      r.bits(24);  // min frame size
      r.bits(24);  // max frame size
      info->sample_rate = (uint32_t)r.bits(20);
      info->channels = (int)r.bits(3) + 1;
      info->bps = (int)r.bits(5) + 1;
      info->total_samples = r.bits(36);
      r.byte += 16;  // md5
      have_info = true;
      if (stop_after_info) break;
    } else {
      r.byte += len;
    }
    r.bit = 0;
  }
  return have_info && !r.error && info->sample_rate > 0;
}

// frame-header UTF-8-style coded number (up to 56 bits)
bool coded_number(Reader& r) {
  uint32_t b0 = (uint32_t)r.bits(8);
  int extra = 0;
  if (b0 < 0x80) extra = 0;
  else if (b0 >= 0xC0 && b0 < 0xE0) extra = 1;
  else if (b0 < 0xF0) extra = 2;
  else if (b0 < 0xF8) extra = 3;
  else if (b0 < 0xFC) extra = 4;
  else if (b0 < 0xFE) extra = 5;
  else if (b0 == 0xFE) extra = 6;
  else return false;
  for (int i = 0; i < extra; ++i) {
    if ((r.bits(8) & 0xC0) != 0x80) return false;
  }
  return !r.error;
}

bool decode_residual(Reader& r, int order, uint32_t block_size,
                     std::vector<int64_t>& out) {
  uint32_t method = (uint32_t)r.bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t po = (uint32_t)r.bits(4);
  uint32_t partitions = 1u << po;
  if (block_size % partitions != 0) return false;
  uint32_t idx = order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = block_size >> po;
    if (p == 0) {
      if (count < (uint32_t)order) return false;
      count -= order;
    }
    uint32_t param = (uint32_t)r.bits(param_bits);
    if (param == escape) {
      int raw = (int)r.bits(5);
      for (uint32_t i = 0; i < count; ++i) out[idx++] = raw ? r.sbits(raw) : 0;
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint64_t q = r.unary();
        uint64_t u = (q << param) | r.bits((int)param);
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (r.error) return false;
  }
  return true;
}

bool decode_subframe(Reader& r, uint32_t block_size, int bps,
                     std::vector<int64_t>& s) {
  if (r.bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = (uint32_t)r.bits(6);
  int wasted = 0;
  if (r.bits(1)) wasted = 1 + (int)r.unary();
  bps -= wasted;
  s.assign(block_size, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = r.sbits(bps);
    for (uint32_t i = 0; i < block_size; ++i) s[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) s[i] = r.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = (int)(type & 7);
    for (int i = 0; i < order; ++i) s[i] = r.sbits(bps);
    if (!decode_residual(r, order, block_size, s)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      switch (order) {
        case 0: break;
        case 1: s[i] += s[i - 1]; break;
        case 2: s[i] += 2 * s[i - 1] - s[i - 2]; break;
        case 3: s[i] += 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
        case 4: s[i] += 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4]; break;
      }
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (int)(type & 31) + 1;
    for (int i = 0; i < order; ++i) s[i] = r.sbits(bps);
    int precision = (int)r.bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    int shift = (int)r.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = r.sbits(precision);
    if (!decode_residual(r, order, block_size, s)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * s[i - 1 - j];
      s[i] += pred >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) s[i] <<= wasted;
  }
  return !r.error;
}

const uint32_t kBlockSizes[16] = {0,   192,  576,  1152, 2304, 4608, 0, 0,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

}  // namespace

extern "C" {

int flac_info(const char* path, long long* num_samples, int* channels,
              int* sample_rate, int* bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)(fsize < 65536 ? fsize : 65536));
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  Reader r{buf.data(), got};
  StreamInfo info;
  if (!parse_metadata(r, &info, /*stop_after_info=*/true)) return -2;
  *num_samples = (long long)info.total_samples;
  *channels = info.channels;
  *sample_rate = (int)info.sample_rate;
  *bits = info.bps;
  return 0;
}

// Decodes up to `capacity` per-channel frames into `out` (int32,
// interleaved). Returns frames decoded, or a negative error code.
long long flac_decode(const char* path, int32_t* out, long long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)fsize);
  size_t got = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (got != (size_t)fsize) return -1;

  Reader r{buf.data(), got};
  StreamInfo info;
  if (!parse_metadata(r, &info)) return -2;

  long long written = 0;
  std::vector<std::vector<int64_t>> ch((size_t)info.channels);
  while (!r.eof() && written < capacity) {
    // frame sync: 14 bits 0b11111111111110
    if (r.bit != 0) r.align();
    if (r.byte + 2 > r.size) break;
    uint32_t sync = (uint32_t)r.bits(14);
    if (r.error) break;
    if (sync != 0x3FFE) return -3;
    r.bits(1);  // reserved
    r.bits(1);  // blocking strategy
    uint32_t bs_code = (uint32_t)r.bits(4);
    uint32_t sr_code = (uint32_t)r.bits(4);
    uint32_t ch_code = (uint32_t)r.bits(4);
    uint32_t ss_code = (uint32_t)r.bits(3);
    r.bits(1);  // reserved
    if (!coded_number(r)) return -3;
    uint32_t block_size;
    if (bs_code == 6) block_size = (uint32_t)r.bits(8) + 1;
    else if (bs_code == 7) block_size = (uint32_t)r.bits(16) + 1;
    else block_size = kBlockSizes[bs_code];
    if (block_size == 0) return -3;
    if (sr_code == 12) r.bits(8);
    else if (sr_code == 13 || sr_code == 14) r.bits(16);
    r.bits(8);  // header CRC-8 (unverified)

    int bps = info.bps;
    switch (ss_code) {  // frame may override the sample size
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: break;  // 0 = from STREAMINFO
    }

    int nch = info.channels;
    int assign = (int)ch_code;
    if (assign >= 8 && assign <= 10) nch = 2;
    else if (assign < 8) nch = assign + 1;
    else return -3;
    if (nch != info.channels) return -4;

    for (int c = 0; c < nch; ++c) {
      int cbps = bps;
      if ((assign == 8 && c == 1) || (assign == 9 && c == 0) ||
          (assign == 10 && c == 1))
        cbps += 1;  // side channel carries one extra bit
      if (!decode_subframe(r, block_size, cbps, ch[(size_t)c])) return -5;
    }
    r.align();
    r.bits(16);  // frame CRC-16 (unverified)
    if (r.error) return -5;

    // stereo decorrelation
    if (assign == 8) {  // left/side
      for (uint32_t i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (assign == 9) {  // side/right
      for (uint32_t i = 0; i < block_size; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (assign == 10) {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t s = ch[1][i];
        int64_t m = (ch[0][i] << 1) | (s & 1);
        ch[0][i] = (m + s) >> 1;
        ch[1][i] = (m - s) >> 1;
      }
    }

    long long n = block_size;
    if (written + n > capacity) n = capacity - written;
    for (long long i = 0; i < n; ++i)
      for (int c = 0; c < info.channels; ++c)
        out[(written + i) * info.channels + c] = (int32_t)ch[(size_t)c][(size_t)i];
    written += n;
  }
  return written;
}

}  // extern "C"
