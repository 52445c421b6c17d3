// CTC prefix beam search with optional word n-gram LM (ARPA).
//
// A copy of s3prl_tpu/native/ctc_beam.cc: the replacement for the
// reference's flashlight-text + KenLM decode path (reference:
// s3prl/downstream/asr/w2l_decoder.py, s3prl/nn/beam_decoder.py): log-probs
// come off the card, this CPU-side decoder runs the
// label-synchronous prefix beam search (Hannun et al. 2014) and rescores
// word boundaries with an n-gram LM loaded from a standard ARPA file.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 ctc_beam.cc -o libctc_beam.so
// Binding: ctypes (s3prl_tpu_torch/nn/beam_decoder.py, built by
// s3prl_tpu_torch/native/__init__.py into build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -1e30f;

inline float LogAdd(float a, float b) {
  if (a < b) std::swap(a, b);
  if (b <= kNegInf) return a;
  return a + std::log1p(std::exp(b - a));
}

// ---------------------------------------------------------------------------
// ARPA n-gram LM
// ---------------------------------------------------------------------------

struct NgramLM {
  // n-gram "w1 w2 ... wn" -> (log10 prob, log10 backoff)
  std::unordered_map<std::string, std::pair<float, float>> table;
  int order = 0;

  bool Load(const std::string& path) {
    std::ifstream in(path);
    if (!in) return false;
    std::string line;
    int cur_order = 0;
    while (std::getline(in, line)) {
      if (line.rfind("\\", 0) == 0) {
        if (line.find("-grams:") != std::string::npos) {
          cur_order = std::stoi(line.substr(1));
          order = std::max(order, cur_order);
        } else if (line.find("\\end\\") != std::string::npos) {
          break;
        }
        continue;
      }
      if (cur_order == 0 || line.empty()) continue;
      std::istringstream ss(line);
      float logp;
      if (!(ss >> logp)) continue;
      std::string words, w;
      for (int i = 0; i < cur_order; ++i) {
        if (!(ss >> w)) break;
        if (!words.empty()) words += ' ';
        words += w;
      }
      float backoff = 0.0f;
      ss >> backoff;  // absent -> stays 0
      table[words] = {logp, backoff};
    }
    return order > 0;
  }

  // log10 P(word | context words), with backoff.
  float Score(const std::vector<std::string>& context, const std::string& word) const {
    int max_ctx = order - 1;
    int start = std::max<int>(0, (int)context.size() - max_ctx);
    // try longest context first
    for (int s = start; s <= (int)context.size(); ++s) {
      std::string key;
      for (size_t i = s; i < context.size(); ++i) {
        if (!key.empty()) key += ' ';
        key += context[i];
      }
      if (!key.empty()) key += ' ';
      key += word;
      auto it = table.find(key);
      if (it != table.end()) {
        // add backoff weights of the skipped shorter contexts? standard
        // Katz backoff accumulates backoffs from the longer contexts that
        // were NOT found; we approximate by summing backoffs of the
        // contexts between `start` and `s`.
        float bo = 0.0f;
        for (int t = start; t < s; ++t) {
          std::string ctx_key;
          for (size_t i = t; i < context.size(); ++i) {
            if (!ctx_key.empty()) ctx_key += ' ';
            ctx_key += context[i];
          }
          auto cit = table.find(ctx_key);
          if (cit != table.end()) bo += cit->second.second;
        }
        return it->second.first + bo;
      }
    }
    auto unk = table.find("<unk>");
    return unk != table.end() ? unk->second.first : -10.0f;
  }
};

// ---------------------------------------------------------------------------
// Prefix beam search
// ---------------------------------------------------------------------------

struct Prefix {
  std::vector<int> tokens;
  float p_blank = kNegInf;     // prob ending in blank
  float p_no_blank = kNegInf;  // prob ending in non-blank
  float lm_score = 0.0f;       // accumulated LM log10 score
  std::vector<std::string> words;  // completed words (for LM context)
  std::string cur_word;

  float Total(float lm_weight) const {
    return LogAdd(p_blank, p_no_blank) + lm_weight * lm_score * 2.302585f;
  }
};

struct PrefixKey {
  size_t operator()(const std::vector<int>& v) const {
    size_t h = 1469598103934665603ull;
    for (int x : v) {
      h ^= (size_t)x;
      h *= 1099511628211ull;
    }
    return h;
  }
};

NgramLM* g_lm = nullptr;

}  // namespace

extern "C" {

int ctc_load_lm(const char* arpa_path) {
  auto* lm = new NgramLM();
  if (!lm->Load(arpa_path)) {
    delete lm;
    return -1;
  }
  delete g_lm;
  g_lm = lm;
  return g_lm->order;
}

void ctc_free_lm() {
  delete g_lm;
  g_lm = nullptr;
}

// log_probs: [T, V] natural-log posteriors. vocab: V null-separated token
// strings ("<pad>" at blank_id; the space token marks word boundaries).
// Returns the number of output tokens written to out_tokens (cap max_out).
int ctc_beam_decode(const float* log_probs, int T, int V, int blank_id,
                    int space_id, const char* vocab_buf, int beam_size,
                    float lm_weight, float word_score, int* out_tokens,
                    int max_out) {
  // vocab_buf: V newline-separated token strings (for LM word assembly)
  std::vector<std::string> vocab;
  if (vocab_buf) {
    std::istringstream vs(vocab_buf);
    std::string tok;
    while (std::getline(vs, tok)) vocab.push_back(tok);
  }
  std::vector<Prefix> beams(1);
  beams[0].p_blank = 0.0f;  // log 1

  for (int t = 0; t < T; ++t) {
    const float* row = log_probs + (size_t)t * V;

    // consider only the top-K tokens of this frame for speed
    int k = std::min(V, std::max(beam_size * 2, 16));
    std::vector<int> idx(V);
    for (int i = 0; i < V; ++i) idx[i] = i;
    std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                      [&](int a, int b) { return row[a] > row[b]; });

    std::unordered_map<std::vector<int>, Prefix, PrefixKey> next;
    next.reserve(beams.size() * (k + 1));

    auto merge = [&](std::vector<int>&& key, const Prefix& base, float add_blank,
                     float add_no_blank, int new_token, bool word_end) {
      auto it = next.find(key);
      if (it == next.end()) {
        Prefix p;
        p.tokens = key;
        p.lm_score = base.lm_score;
        p.words = base.words;
        p.cur_word = base.cur_word;
        if (new_token >= 0) {
          if (word_end) {
            if (!p.cur_word.empty()) {
              if (g_lm) p.lm_score += g_lm->Score(p.words, p.cur_word) + word_score;
              p.words.push_back(p.cur_word);
              p.cur_word.clear();
            }
          } else if (new_token < (int)vocab.size()) {
            p.cur_word += vocab[new_token];
          }
        }
        it = next.emplace(std::move(key), std::move(p)).first;
      }
      if (add_blank > kNegInf) it->second.p_blank = LogAdd(it->second.p_blank, add_blank);
      if (add_no_blank > kNegInf)
        it->second.p_no_blank = LogAdd(it->second.p_no_blank, add_no_blank);
    };

    for (const auto& beam : beams) {
      float p_total = LogAdd(beam.p_blank, beam.p_no_blank);
      // extend with blank
      merge(std::vector<int>(beam.tokens), beam, p_total + row[blank_id], kNegInf,
            -1, false);
      int last = beam.tokens.empty() ? -1 : beam.tokens.back();
      for (int j = 0; j < k; ++j) {
        int c = idx[j];
        if (c == blank_id) continue;
        float pc = row[c];
        if (pc < -14.0f) continue;
        if (c == last) {
          // repeat: extends the same prefix only from blank state
          merge(std::vector<int>(beam.tokens), beam, kNegInf,
                beam.p_no_blank + pc, -1, false);
          std::vector<int> nk = beam.tokens;
          nk.push_back(c);
          merge(std::move(nk), beam, kNegInf, beam.p_blank + pc, c, c == space_id);
        } else {
          std::vector<int> nk = beam.tokens;
          nk.push_back(c);
          merge(std::move(nk), beam, kNegInf, p_total + pc, c, c == space_id);
        }
      }
    }

    beams.clear();
    beams.reserve(next.size());
    for (auto& kv : next) beams.push_back(std::move(kv.second));
    std::sort(beams.begin(), beams.end(), [&](const Prefix& a, const Prefix& b) {
      return a.Total(lm_weight) > b.Total(lm_weight);
    });
    if ((int)beams.size() > beam_size) beams.resize(beam_size);
  }

  // finalize: score the trailing word
  for (auto& b : beams) {
    if (!b.cur_word.empty() && g_lm) {
      b.lm_score += g_lm->Score(b.words, b.cur_word) + word_score;
      b.cur_word.clear();
    }
  }
  std::sort(beams.begin(), beams.end(), [&](const Prefix& a, const Prefix& b) {
    return a.Total(lm_weight) > b.Total(lm_weight);
  });

  const auto& best = beams.front().tokens;
  int n = std::min<int>(best.size(), max_out);
  std::memcpy(out_tokens, best.data(), n * sizeof(int));
  return n;
}

}  // extern "C"
