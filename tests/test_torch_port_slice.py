"""The HuBERT-Large-style extraction slice of s3prl_tpu_torch vs s3prl_tpu (CPU).

A tiny trunk of the same family (layer-norm extractor, pre-LN encoder,
normalize=True) is initialised in JAX, its parameters perturbed so that no
bias or norm is trivial, and carried to the port with
`trunk_state_dict_from_jax`. The same numpy batch goes through
`Upstream.apply_standardized` of both packages. Tolerances: f32 per-layer
hidden states at atol 5e-4 over valid frames (the ROADMAP bar); bf16 and
int8 per-layer cosine > 0.999 over valid frames (the JAX package's quality
gate for its reduced-precision paths); lengths exactly equal. Every test
runs with the JAX package's default knobs (the `S3PRL_*` variables that
change its serving path are removed).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu.upstream.convert import trunk_params_from_torch
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.kernels import wrappers
from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn, fused_int8_ffn
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.ops.quant import int8_matmul
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax
from test_torch_port_hub_names import NOT_YET

TINY = dict(
    extractor_mode="layer_norm",
    conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    layer_norm_first=True, dropout=0.0, attention_dropout=0.0,
    dropout_input=0.0, normalize=True,
)
JCFG, PCFG = JaxConfig(**TINY), Wav2Vec2Config(**TINY)
STRIDE = 20
JAX_KNOBS = ("S3PRL_GELU", "S3PRL_STATIC_ACT", "S3PRL_INT8_AV", "S3PRL_ATTN_BLOCK")


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    for knob in JAX_KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def jax_params():
    """Random JAX trunk params, every leaf perturbed by numpy noise."""
    wavs = jnp.zeros((1, 3200), jnp.float32)
    params = JaxTrunk(JCFG).init(jax.random.key(0), wavs, jnp.asarray([3200]),
                                 deterministic=True)["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)


def _batch(seed, lens, T=None):
    rng = np.random.RandomState(seed)
    T = T or max(lens)
    wavs = np.zeros((len(lens), T), np.float32)
    for i, n in enumerate(lens):
        wavs[i, :n] = rng.randn(n)
    return wavs, np.asarray(lens, np.int32)


def _run_jax(params, wavs, lens, dtype=jnp.float32, flash=False, quantize=False):
    trunk = JaxTrunk(JCFG, dtype=dtype, use_flash=flash, quantize=quantize)
    up = JaxUpstream(
        name="tiny", params={"params": params},
        apply_fn=lambda v, w, l, train, rngs: trunk.apply(v, w, l, deterministic=True),
        num_layers=JCFG.encoder_layers + 1, hidden_size=JCFG.encoder_embed_dim,
        downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def _port(params, dtype=torch.float32, flash=False, quantize=False):
    model = Wav2Vec2Trunk(PCFG, dtype=dtype, use_flash=flash, quantize=quantize,
                          device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(trunk_state_dict_from_jax(params, PCFG))  # builds the int8 cache
    return Upstream(name="tiny", model=model.eval(),
                    num_layers=PCFG.encoder_layers + 1,
                    hidden_size=PCFG.encoder_embed_dim, downsample_rate=STRIDE)


def _run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _valid_frames(h_lens, T):
    return [min(int(n), T) for n in h_lens]


def _layer_cosines(got, want, h_lens):
    """Per-layer cosine over the valid frames of every utterance."""
    valid = list(enumerate(_valid_frames(h_lens, got.shape[2])))
    return [_cos(np.concatenate([got[layer, b, :n] for b, n in valid]),
                 np.concatenate([want[layer, b, :n] for b, n in valid]))
            for layer in range(got.shape[0])]


def test_slice_f32_matches_jax(jax_params):
    wavs, lens = _batch(1, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens)
    got, got_lens = _run_port(_port(jax_params), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 3, 320, 128)
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       err_msg=f"layer {layer} utterance {b}")


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_slice_bf16_flash_matches_jax_kernels(jax_params, monkeypatch, route):
    """JAX runs K3/K4/K5 (interpret mode); the port runs its kernel wrappers
    (plain versions on CPU) or, unpatched, its plain module path."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    if route == "kernels":
        monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    wavs, lens = _batch(2, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens, jnp.bfloat16, flash=True)
    got, got_lens = _run_port(_port(jax_params, torch.bfloat16, flash=True), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            cos = _cos(got[layer, b, :n], want[layer, b, :n])
            assert cos > 0.999, (layer, b, cos)


@pytest.mark.parametrize("lens,T", [([500, 300, 1], 500), ([1, 1], 1), ([6399, 6401], 6401)],
                         ids=["sub-min-second", "one-sample", "off-by-one"])
def test_slice_lengths_match_jax(jax_params, lens, T):
    wavs, lens = _batch(3, lens, T)
    want, want_lens = _run_jax(jax_params, wavs, lens)
    got, got_lens = _run_port(_port(jax_params), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
        np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=5e-4)


def test_state_dict_round_trip_is_exact(jax_params):
    sd = trunk_state_dict_from_jax(jax_params, PCFG)
    up = _port(jax_params)
    for tree in (trunk_params_from_torch(sd, JCFG),
                 trunk_params_from_torch(up.model.state_dict(), JCFG)):
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(jax_params))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


def _refuse(*args, **kwargs):
    raise AssertionError("a whole-block kernel beyond MAX_BLOCK_T")


def _long_input(seed, T=513):
    x = torch.from_numpy(np.random.RandomState(seed).randn(2, T, 128).astype(np.float32))
    kv = torch.tensor([T, T // 3], dtype=torch.int32)
    return x.bfloat16(), kv, torch.arange(T)[None, :] >= kv[:, None]


def test_kernel_route_refuses_long_utterances(jax_params, monkeypatch):
    """Beyond MAX_BLOCK_T the bf16 kernel route refuses K4 and serves the
    utterance as the JAX package does (transformer.py:525-526): LN, then
    SelfAttention through K7, then K5."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    monkeypatch.setattr(port_transformer, "fused_attention_block_bf16", _refuse)
    calls = []
    k7 = port_fa.fused_qkv_attention_reference
    monkeypatch.setattr(port_fa, "fused_qkv_attention_reference",
                        lambda *a: calls.append(1) or k7(*a))
    layer = _port(jax_params, torch.bfloat16, flash=True).model.encoder.layers[0]
    x, kv, pad = _long_input(10)
    got = layer(x, kv, pad)
    assert calls == [1]
    ln1, ln2 = layer.self_attn_layer_norm, layer.final_layer_norm
    h = x + layer.self_attn(port_transformer._layer_norm(x, ln1), pad)
    want = fused_bf16_ffn(h, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight, layer.fc2.bias,
                          ln=(ln2.weight, ln2.bias), residual=True)
    assert torch.equal(got, want)


def test_cpu_run_counts_no_launch(jax_params):
    before = [w.launches for w in wrappers()]
    wavs, lens = _batch(4, [3200, 1600])
    _run_port(_port(jax_params, torch.bfloat16, flash=True), wavs, lens)
    assert [w.launches for w in wrappers()] == before


def test_registry_refuses_what_is_not_ported(monkeypatch, tmp_path):
    with pytest.raises(KeyError):
        hub.load("no_such_upstream")
    native = tmp_path / "params.msgpack"  # the JAX package's own pretraining checkpoint
    native.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="msgpack.*Queue 1 item 9"):
        hub.load("hubert_large_ll60k", ckpt=str(native), device="cpu")
    with pytest.raises(NotImplementedError, match="download= is not ported"):
        hub.load("hubert_large_ll60k", download=True, device="cpu")
    with pytest.raises(NotImplementedError, match="layer_type 'trf_adp'"):
        Wav2Vec2Trunk(Wav2Vec2Config(layer_type="trf_adp"), device="meta")
    # every name of the JAX hub (none left to port, pinned in
    # test_torch_port_hub_names.py)
    assert hub.options() == sorted(set(jax_hub.options()) - set(NOT_YET))
    assert len(hub.options()) == 209
    # quantize=True loads (the entry at the tiny width: same code path)
    monkeypatch.setattr(port_registry, "HUBERT_LARGE", PCFG)
    up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True, quantize=True,
                  device="cpu")
    layer = up.model.encoder.layers[0]
    assert layer.quantize and layer.fc1.weight.dtype == torch.float32
    assert layer.qpair("fc1")[0].dtype == torch.int8


@pytest.mark.parametrize("name", ["hubert_large_ll60k", "wavlm_large", "hubert", "hubert_base",
                                  "wavlm", "wavlm_base", "wavlm_base_plus", "wav2vec2",
                                  "wav2vec2_base_960", "wav2vec2_large_ll60k",
                                  "wav2vec2_large_lv60_cv_swbd_fsh", "data2vec",
                                  "data2vec_base_960", "data2vec_large_ll60k", "unispeech_sat",
                                  "unispeech_sat_base", "unispeech_sat_base_plus",
                                  "unispeech_sat_large", "xls_r_1b", "contentvec"])
def test_hub_load_without_device_needs_cuda(monkeypatch, name):
    """An entry builds on the card unless device= says otherwise: without
    CUDA it raises and names device="cpu", it never builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hub.load(name, dtype=torch.bfloat16, flash=True, quantize=True)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import s3prl_tpu_torch.hub, s3prl_tpu_torch.upstream.convert\n"
        "import s3prl_tpu_torch.kernels.conv_frontend, s3prl_tpu_torch.kernels.ffn\n"
        "import s3prl_tpu_torch.kernels.flash_attention, s3prl_tpu_torch.ops.quant\n"
        "import s3prl_tpu_torch.kernels, s3prl_tpu_torch.models.transformer\n"
        "import s3prl_tpu_torch.models.wavlm, s3prl_tpu_torch.kernels.ln_gelu\n"
        "import s3prl_tpu_torch.kernels.posconv\n"
        "import s3prl_tpu_torch.main, s3prl_tpu_torch.problem, s3prl_tpu_torch.train\n"
        "import s3prl_tpu_torch.nn, s3prl_tpu_torch.task, s3prl_tpu_torch.data.loader\n"
        "import s3prl_tpu_torch.data.dataset, s3prl_tpu_torch.util.pseudo_data\n"
        "import s3prl_tpu_torch.data.corpus.voxceleb1, s3prl_tpu_torch.data.corpus.iemocap\n"
        "import s3prl_tpu_torch.data.corpus.speech_commands\n"
        "import s3prl_tpu_torch.data.corpus.fluent_commands\n"
        "import s3prl_tpu_torch.data.corpus.librispeech, s3prl_tpu_torch.data.corpus.snips\n"
        "import s3prl_tpu_torch.data.flac, s3prl_tpu_torch.data.bpe, s3prl_tpu_torch.native\n"
        "import s3prl_tpu_torch.nn.beam_decoder, s3prl_tpu_torch.ops.ctc, s3prl_tpu_torch.metric\n"
        "import s3prl_tpu_torch.problem.asr, s3prl_tpu_torch.task.speech2text_ctc\n"
        "import s3prl_tpu_torch.nn.speaker, s3prl_tpu_torch.task.speaker_verification\n"
        "import s3prl_tpu_torch.task.diarization, s3prl_tpu_torch.metric.diarization\n"
        "import s3prl_tpu_torch.problem.asv, s3prl_tpu_torch.problem.diarization\n"
        "import s3prl_tpu_torch.data.corpus.kaldi_diar\n"
        "import s3prl_tpu_torch.ops.dtw, s3prl_tpu_torch.problem.frame_probe\n"
        "import s3prl_tpu_torch.problem.qbe, s3prl_tpu_torch.problem.qbe_embedding\n"
        "import s3prl_tpu_torch.task.qbe_embedding, s3prl_tpu_torch.task.hear\n"
        "import s3prl_tpu_torch.problem.hear, s3prl_tpu_torch.task.mos_prediction\n"
        "import s3prl_tpu_torch.problem.mos\n"
        "import s3prl_tpu_torch.ops.audio, s3prl_tpu_torch.models.baseline\n"
        "import s3prl_tpu_torch.metric.quality, s3prl_tpu_torch.metric.bleu\n"
        "import s3prl_tpu_torch.task.enhancement, s3prl_tpu_torch.problem.enhancement\n"
        "import s3prl_tpu_torch.ops.attention, s3prl_tpu_torch.models.decoder\n"
        "import s3prl_tpu_torch.task.speech_translation, s3prl_tpu_torch.problem.translation\n"
        "import s3prl_tpu_torch.models.mockingjay, s3prl_tpu_torch.models.apc\n"
        "import s3prl_tpu_torch.models.npc, s3prl_tpu_torch.models.mos\n"
        "import s3prl_tpu_torch.problem.slu\n"
        "import s3prl_tpu_torch.models.taco2ar, s3prl_tpu_torch.ops.vocoder\n"
        "import s3prl_tpu_torch.task.voice_conversion, s3prl_tpu_torch.problem.vc\n"
        "import s3prl_tpu_torch.run_downstream, s3prl_tpu_torch.train.hub_export\n"
        "import s3prl_tpu_torch.submit\n"
        "import s3prl_tpu_torch.models.distiller, s3prl_tpu_torch.models.lighthubert\n"
        "import s3prl_tpu_torch.models.multires_hubert\n"
        "import s3prl_tpu_torch.upstream.aliases, s3prl_tpu_torch.upstream.convert_zoo\n"
        "import s3prl_tpu_torch.models.wav2vec1, s3prl_tpu_torch.models.cpc\n"
        "import s3prl_tpu_torch.models.decoar, s3prl_tpu_torch.models.byol\n"
        "import s3prl_tpu_torch.models.ast, s3prl_tpu_torch.models.passt\n"
        "import s3prl_tpu_torch.models.audio_cnn, s3prl_tpu_torch.models.roberta\n"
        "import s3prl_tpu_torch.models.pase, s3prl_tpu_torch.nn.specaug\n"
        "import s3prl_tpu_torch.upstream.convert_hf\n"
        "assert len(s3prl_tpu_torch.hub.options()) == 209\n"
        "assert len(s3prl_tpu_torch.kernels.wrappers()) == 19\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 's3prl_tpu', 'transformers')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_slice_int8_matches_jax(jax_params, monkeypatch, route):
    """int8 W8A8 serving (bf16, flash, quantize). `kernels`: both packages
    patched, JAX runs K1/K2/K3-tanh in interpret mode and the port its
    kernel wrappers (plain versions on CPU); `plain`: JAX runs QuantDense
    around interpreted K7, the port its int8_matmul module path."""
    if route == "kernels":
        monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
        monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    wavs, lens = _batch(5, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens, jnp.bfloat16, flash=True, quantize=True)
    got, got_lens = _run_port(_port(jax_params, torch.bfloat16, flash=True, quantize=True),
                              wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


def test_slice_int8_quality_against_f32(jax_params, monkeypatch):
    """The port's int8 serving route against its own f32 model on the same
    weights: per-layer cosine > 0.999 (the JAX package's int8 gate,
    tests/test_quant.py:82-124)."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    wavs, lens = _batch(6, [6400, 4800])
    want, want_lens = _run_port(_port(jax_params), wavs, lens)
    got, got_lens = _run_port(_port(jax_params, torch.bfloat16, flash=True, quantize=True),
                              wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


def test_int8_route_refuses_long_utterances(jax_params, monkeypatch):
    """Beyond MAX_BLOCK_T int8 quant serving refuses K1 and serves the
    utterance as the JAX package does (transformer.py:481-492): the f32 LN
    rounded to bf16, int8_matmul QKV, K6, then K2."""
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    monkeypatch.setattr(port_transformer, "fused_attention_block", _refuse)
    layer = _port(jax_params, torch.bfloat16, flash=True, quantize=True).model.encoder.layers[0]
    x, kv, pad = _long_input(11)
    got = layer(x, kv, pad)
    attn, ln1, ln2 = layer.self_attn, layer.self_attn_layer_norm, layer.final_layer_norm
    h = port_transformer._layer_norm(x, ln1)
    assert h.dtype == torch.bfloat16
    qkv = int8_matmul(h, attn.qpair("qkv"), attn.qkv_bias, out_dtype=torch.bfloat16)
    y = port_fa.fused_qkv_attention_outproj_reference(
        qkv, x, attn.qpair("out_proj"), attn.out_proj.bias, kv, layer.num_heads)
    want = fused_int8_ffn(y, layer.qpair("fc1"), layer.fc1.bias, layer.qpair("fc2"),
                          layer.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
    assert torch.equal(got, want)


def test_int8_state_dict_round_trip_is_exact(jax_params):
    """The int8 model keeps the fairseq keys (its cache is not saved) and
    its f32 weights, so the JAX tree comes back bit for bit."""
    sd = _port(jax_params, quantize=True).model.state_dict()
    assert sd.keys() == trunk_state_dict_from_jax(jax_params, PCFG).keys()
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jax_params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(trunk_params_from_torch(sd, JCFG)):
        np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))
