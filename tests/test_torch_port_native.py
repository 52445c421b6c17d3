"""The port's native host libraries vs the JAX package's (CPU): the FLAC
decoder (native/flac_decode.cc, data/flac.py) and the CTC prefix beam
decoder (native/ctc_beam.cc, nn/beam_decoder.py), each built by g++ from
the port's own copy of the source into build/.

FLAC files are written by the JAX package (its `write_flac`, and the
hand-made frames of tests/test_flac.py: constant and LPC subframes, the
three stereo decorrelation modes) and decoded by both packages: the
samples are compared bit for bit, `load_wav`'s floats exactly. The beam
decoder gives the same ids as the JAX one on seeded log-probs, without and
with an ARPA LM written here."""

import numpy as np
import pytest

import s3prl_tpu.data.audio as jax_audio
import s3prl_tpu.data.flac as jax_flac
import s3prl_tpu_torch.data.audio as port_audio
import s3prl_tpu_torch.data.flac as port_flac
from s3prl_tpu.data.encoder import CharacterTokenizer as JaxCharacterTokenizer
from s3prl_tpu.nn.beam_decoder import BeamDecoder as JaxBeamDecoder
from s3prl_tpu_torch import native
from s3prl_tpu_torch.data.encoder import CharacterTokenizer
from s3prl_tpu_torch.nn.beam_decoder import BeamDecoder

_BitWriter, _crc8, _crc16 = jax_flac._BitWriter, jax_flac._crc8, jax_flac._crc16


def _same_decode(path):
    """Both packages decode `path` to the same samples, rate and depth;
    returns the port's samples."""
    got, want = port_flac.load_flac(path), jax_flac.load_flac(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[0].dtype == want[0].dtype
    assert port_flac.flac_info(path) == jax_flac.flac_info(path)
    return got[0]


def _written(tmp_path, case):
    """(path, the samples written) for one of tests/test_flac.py's
    round-trip cases, written by the JAX package's write_flac."""
    rng = np.random.RandomState(0)
    if case == "mono":
        t = np.arange(2000)
        wav, kw = (np.sin(t * 0.05) * 8000 + rng.randn(2000) * 50).astype(np.int32), {}
    elif case == "stereo-multiblock":
        wav, kw = (rng.randn(1000, 2) * 3000).astype(np.int32), {"block_size": 192}
    elif case == "verbatim-extremes":
        wav, kw = rng.randint(-32768, 32767, size=500).astype(np.int32), {"block_size": 128}
    elif case == "single-sample-block":
        wav, kw = (rng.randn(257) * 1000).astype(np.int32), {"block_size": 256}
    else:  # constant-ish, compresses far better than 2x, total_samples zeroed
        wav, kw = np.zeros(200_000, np.int32), {"block_size": 4096}
        wav[::3] = 100
    path = tmp_path / f"{case}.flac"
    jax_flac.write_flac(path, wav, 16000, bps=16, **{"block_size": 256, **kw})
    if case == "unknown-total":
        raw = bytearray(path.read_bytes())
        raw[8 + 13] &= 0xF0
        raw[8 + 14:8 + 18] = bytes(4)
        path.write_bytes(bytes(raw))
    return path, wav


@pytest.mark.parametrize("case", ["mono", "stereo-multiblock", "verbatim-extremes",
                                  "single-sample-block", "unknown-total"])
def test_written_flac_decodes_bit_equal(tmp_path, case):
    path, wav = _written(tmp_path, case)
    got = _same_decode(path)
    np.testing.assert_array_equal(got, wav.reshape(len(wav), -1))


def _frame(tmp_path, name, channels, ch_code, write_subframes, n=64):
    """One hand-made frame after a STREAMINFO (tests/test_flac.py's
    `_handcrafted`)."""
    head = _BitWriter()
    head.bytes += b"fLaC"
    for value, bits in ((1, 1), (0, 7), (34, 24), (n, 16), (n, 16), (0, 24), (0, 24),
                        (16000, 20), (channels - 1, 3), (15, 5), (n, 36)):
        head.write(value, bits)
    for _ in range(16):
        head.write(0, 8)
    w = _BitWriter()
    for value, bits in ((0x3FFE, 14), (0, 2), (7, 4), (0, 4), (ch_code, 4), (0, 4), (0, 8),
                        (n - 1, 16)):
        w.write(value, bits)
    w.write(_crc8(bytes(w.bytes)), 8)
    write_subframes(w)
    w.align()
    w.write(_crc16(bytes(w.bytes)), 16)
    path = tmp_path / f"{name}.flac"
    path.write_bytes(bytes(head.bytes) + bytes(w.bytes))
    return path


def _constant(w):
    for value, bits in ((0, 1), (0, 6), (0, 1), (-1234 & 0xFFFF, 16)):
        w.write(value, bits)


def _lpc(rng, n=64):
    """An order-2 LPC subframe (coefficients 3, -1, shift 1) and its
    samples."""
    res = rng.randint(-10, 10, size=n).astype(np.int64)
    s = np.zeros(n, np.int64)
    s[0], s[1] = 100, -50
    for i in range(2, n):
        s[i] = res[i] + ((3 * s[i - 1] - s[i - 2]) >> 1)

    def write(w):
        for value, bits in ((0, 1), (33, 6), (0, 1), (int(s[0]) & 0xFFFF, 16),
                            (int(s[1]) & 0xFFFF, 16), (14, 4), (1, 5), (3, 15),
                            (-1 & 0x7FFF, 15), (0, 2), (0, 4), (6, 4)):
            w.write(value, bits)
        for v in res[2:]:
            u = int(2 * abs(v) - (v < 0))
            w.write(0, u >> 6)
            w.write(1, 1)
            w.write(u, 6)

    return write, s


def _stereo(rng, mode, n=64):
    """Two verbatim subframes in a decorrelation mode, and (left, right)."""
    left = rng.randint(-5000, 5000, size=n).astype(np.int64)
    right = rng.randint(-5000, 5000, size=n).astype(np.int64)
    side = left - right
    code, chans = {"left_side": (8, ((left, 16), (side, 17))),
                   "right_side": (9, ((side, 17), (right, 16))),
                   "mid_side": (10, (((left + right) >> 1, 16), (side, 17)))}[mode]

    def write(w):
        for data, bits in chans:
            w.write(0, 1)
            w.write(1, 6)
            w.write(0, 1)
            for v in data:
                w.write(int(v) & ((1 << bits) - 1), bits)

    return code, write, np.stack([left, right], 1)


@pytest.mark.parametrize("case", ["constant", "lpc", "left_side", "right_side", "mid_side"])
def test_handmade_frames_decode_bit_equal(tmp_path, case):
    rng = np.random.RandomState(4)
    if case == "constant":
        path, want = _frame(tmp_path, case, 1, 0, _constant), np.full((64, 1), -1234)
    elif case == "lpc":
        write, s = _lpc(rng)
        path, want = _frame(tmp_path, case, 1, 0, write), s[:, None]
    else:
        code, write, want = _stereo(rng, case)
        path = _frame(tmp_path, case, 2, code, write)
    np.testing.assert_array_equal(_same_decode(path), want)


@pytest.mark.parametrize("channels,rate", [(1, 16000), (2, 16000), (1, 22050), (2, 8000)])
def test_load_wav_of_a_flac_matches_jax(tmp_path, channels, rate):
    """The port's load_wav of a FLAC (mono mix, 16 kHz resampling, crops)
    equals the JAX package's, and audio_info too. The port's write_flac
    writes the file, so its copy of the writer is also held to the JAX
    decoder."""
    rng = np.random.RandomState(channels * rate)
    pcm = (rng.randn(rate // 2, channels) * 3000).astype(np.int32)
    path = tmp_path / "a.flac"
    port_flac.write_flac(path, pcm, rate, block_size=1024)
    assert path.read_bytes() == _port_equals_jax_writer(tmp_path, pcm, rate)
    for kw in ({}, {"target_sample_rate": 16000}, {"start_sec": 0.1, "end_sec": 0.3}):
        got, sr = port_audio.load_wav(path, **kw)
        want, want_sr = jax_audio.load_wav(path, **kw)
        assert sr == want_sr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert port_audio.audio_info(path) == jax_audio.audio_info(path)


def _port_equals_jax_writer(tmp_path, pcm, rate):
    jax_flac.write_flac(tmp_path / "jax.flac", pcm, rate, block_size=1024)
    return (tmp_path / "jax.flac").read_bytes()


def test_libraries_build_from_the_port_sources():
    """g++ builds each library from s3prl_tpu_torch/native/ into build/ at
    the root of the checkout; the port never reads s3prl_tpu/native/."""
    for name in ("flac_decode", "ctc_beam"):
        lib = native.build(name)
        assert lib.exists() and lib.name == f"lib{name}.so"
        assert lib.parent.parent == native.BUILD_ROOT
        assert native.BUILD_ROOT.parts[-3:] == ("build", "s3prl_tpu_torch", "native")
        assert (native.SRC / f"{name}.cc").exists()
        assert native.SRC.parent.name == "s3prl_tpu_torch"
    assert native.library("ctc_beam") is native.library("ctc_beam")


LINES = ["hello world", "abc def", "a cab bead"]


def _decoders(**kw):
    return (BeamDecoder(CharacterTokenizer.from_text(LINES), **kw),
            JaxBeamDecoder(JaxCharacterTokenizer.from_text(LINES), **kw))


def _log_probs(rng, T, V, scale):
    logits = rng.randn(T, V).astype(np.float32) * scale
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


@pytest.mark.parametrize("beam", [1, 4, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_decoder_matches_jax(seed, beam):
    port, ref = _decoders(beam_size=beam)
    rng = np.random.RandomState(seed)
    V = port.tokenizer.vocab_size
    for T, scale in ((1, 1.0), (12, 2.0), (40, 4.0)):
        lp = _log_probs(rng, T, V, scale)
        for length in (None, max(T // 2, 1)):
            ids = port.decode_ids(lp, length)
            assert ids == ref.decode_ids(lp, length)
            assert port.decode(lp, length) == ref.decode(lp, length)
            assert all(0 < i < V for i in ids)


def test_beam_decoder_with_an_arpa_lm_matches_jax(tmp_path):
    """A bigram ARPA LM: the same ids as the JAX decoder on seeded
    log-probs over words, and the LM flips a near tie toward its word."""
    arpa = tmp_path / "lm.arpa"
    arpa.write_text(
        "\\data\\\nngram 1=5\nngram 2=2\n\n\\1-grams:\n-0.5 <s> -0.3\n-0.7 </s>\n"
        "-0.05 AB -0.2\n-3.0 AC -0.2\n-2.0 <unk>\n\n\\2-grams:\n-0.1 <s> AB\n-0.2 AB AC\n\n"
        "\\end\\\n")
    port, ref = _decoders(beam_size=8, lm_path=arpa, lm_weight=1.0, word_score=-0.5)
    tok = port.tokenizer
    a, b, c, space = (tok._index[t] for t in ("A", "B", "C", "<space>"))
    lp = np.full((3, tok.vocab_size), -15.0, np.float32)
    lp[0, a], lp[1, b], lp[1, c], lp[2, space] = -0.01, -0.75, -0.65, -0.01
    assert port.decode(lp) == ref.decode(lp) == "AB"
    rng = np.random.RandomState(3)
    for T in (6, 25):
        lp = _log_probs(rng, T, tok.vocab_size, 3.0)
        assert port.decode_ids(lp) == ref.decode_ids(lp)
