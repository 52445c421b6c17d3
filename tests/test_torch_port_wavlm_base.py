"""The post-LN Base slice of s3prl_tpu_torch vs s3prl_tpu (CPU): WavLM-Base.

A tiny WavLM of the WavLM-Base family (the default extractor, erf GELU;
post-LN gated layers, the encoder LayerNorm before them; 2 layers, C 128,
H 2, FFN 256, 32 buckets up to distance 80; normalize=False), initialised in
JAX with every leaf perturbed and carried to the port with
`wavlm_state_dict_from_jax`; the same numpy batch through both packages'
`apply_standardized`. Tolerances as in test_torch_port_base.py: f32 at atol
5e-4 over valid frames, bf16 and int8 per-layer cosine > 0.999 on the same
route in both packages, lengths exactly equal, the weight round trip exact
(the pos-conv kernel, which the JAX converter folds from weight_g and
weight_v, at rtol 1e-6). Every test runs with the JAX package's default
knobs (``wavlm_fuse`` sets its JAX switch, S3PRL_WAVLM_FUSE, itself).
"""

import numpy as np
import pytest
import torch

import jax

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.models.wavlm as port_wavlm
from s3prl_tpu.models.wavlm import WavLMConfig as JaxConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.upstream.convert import wavlm_params_from_torch
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.convert import wavlm_state_dict_from_jax
from test_torch_port_base import (PRECISION, TINY, assert_cos, assert_f32_close, jax_init,
                                  kernels_on, port_upstream, run_jax, run_port, spy)
from test_torch_port_slice import _batch, _jax_defaults  # noqa: F401 (fixture)

WAVLM_TINY = dict(TINY, num_buckets=32, max_distance=80)
JCFG, PCFG = JaxConfig(**WAVLM_TINY), WavLMConfig(**WAVLM_TINY)
LENS = [3200, 1501, 1]  # T' = 160 frames


@pytest.fixture(scope="module")
def params():
    return jax_init(JaxWavLM(JCFG))


def _jax(params, wavs, lens, precision="f32"):
    dtype, _, flash, quantize = PRECISION[precision]
    return run_jax(JaxWavLM(JCFG, dtype=dtype, use_flash=flash, quantize=quantize), params,
                   wavs, lens)


def _port(params, precision="f32", **options):
    _, dtype, flash, quantize = PRECISION[precision]
    model = WavLMModel(PCFG, dtype=dtype, use_flash=flash, quantize=quantize, device="meta",
                       **options)
    return port_upstream(model, wavlm_state_dict_from_jax(params, PCFG))


def test_wavlm_base_f32_matches_jax(params):
    wavs, lens = _batch(41, LENS)
    want, want_lens = _jax(params, wavs, lens)
    got, got_lens = run_port(_port(params), wavs, lens)
    assert got.shape == (3, 3, 160, 128)
    assert_f32_close(got, want, got_lens, want_lens)


ROUTES = {  # route -> (precision, MAX_KERNEL_T, the port's plain version that must run or None)
    "bf16-plain": ("bf16", None, None),
    "bf16-k9": ("bf16", 2048, "gated_bias_attention_reference"),
    "bf16-k10": ("bf16", 128, "gated_online_flash_attention_reference"),
    "int8-plain": ("int8", None, None),
    "int8-k9": ("int8", 2048, "gated_bias_attention_reference"),
    "int8-k10": ("int8", 128, "gated_online_flash_attention_reference"),
}


@pytest.mark.parametrize("route", ROUTES)
def test_wavlm_base_reduced_precision_matches_jax(params, monkeypatch, route):
    """The kernel routes (both packages patched; MAX_KERNEL_T = 128 sends
    the 160 frames to K10): the gated attention on raw x, then the stock LN,
    and under int8 K2 bare (the JAX post-LN FFN, wavlm.py:230-236) before
    the second LN; `plain`: both packages' module paths."""
    precision, max_kernel_t, plain = ROUTES[route]
    if max_kernel_t is not None:
        kernels_on(monkeypatch, MAX_KERNEL_T=max_kernel_t)
        calls = spy(monkeypatch, port_fa, plain)
        ffn = spy(monkeypatch, port_wavlm, "fused_int8_ffn")
    wavs, lens = _batch(42, LENS)
    want, want_lens = _jax(params, wavs, lens, precision)
    got, got_lens = run_port(_port(params, precision), wavs, lens)
    assert_cos(got, want, got_lens, want_lens)
    if max_kernel_t is not None:
        assert len(calls) == 2 and len(ffn) == (2 if precision == "int8" else 0)


@pytest.mark.parametrize("max_kernel_t", [2048, 128])
def test_wavlm_base_fuse_matches_jax(params, monkeypatch, max_kernel_t):
    """``wavlm_fuse`` / S3PRL_WAVLM_FUSE=1 on the post-LN layer: int8_matmul
    QKV on raw x, K11 (beyond a patched MAX_KERNEL_T its hand-over to K9 ->
    K10), the stock LN, K2 bare, the stock LN (wavlm.py:232-233)."""
    monkeypatch.setenv("S3PRL_WAVLM_FUSE", "1")
    kernels_on(monkeypatch, MAX_KERNEL_T=max_kernel_t)
    jax_calls = spy(monkeypatch, jax_fa, "gated_bias_attention_outproj")
    port_calls = spy(monkeypatch, port_wavlm, "gated_bias_attention_outproj")
    plain = spy(monkeypatch, port_fa, "gated_bias_attention_outproj_reference"
                if max_kernel_t == 2048 else "gated_online_flash_attention_reference")
    wavs, lens = _batch(43, LENS)
    want, want_lens = _jax(params, wavs, lens, "int8")
    got, got_lens = run_port(_port(params, "int8", wavlm_fuse=True), wavs, lens)
    assert_cos(got, want, got_lens, want_lens)
    assert len(jax_calls) == len(port_calls) == len(plain) == 2


def test_wavlm_base_state_dict_round_trip_is_exact(params):
    """The f32 and int8 models' state_dicts (the group-norm keys, the one
    ``encoder.layer_norm`` that the JAX tree holds as ``enc_layer_norm``),
    the pos-conv split into weight_g / weight_v, map back to the JAX tree:
    exact but for the pos-conv kernel, which the JAX converter folds again."""
    sd = wavlm_state_dict_from_jax(params, PCFG)
    assert "feature_extractor.conv_layers.0.2.weight" in sd and "encoder.layer_norm.bias" in sd
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    for quantize in (False, True):
        port_sd = port_upstream(WavLMModel(PCFG, quantize=quantize, device="meta"),
                                sd).model.state_dict()
        assert port_sd.keys() == sd.keys()
        w = port_sd.pop("encoder.pos_conv.0.weight")  # as Microsoft's checkpoints hold it
        port_sd["encoder.pos_conv.0.weight_g"] = w.norm(dim=(0, 1), keepdim=True)
        port_sd["encoder.pos_conv.0.weight_v"] = w
        tree = wavlm_params_from_torch(port_sd, JCFG)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            key = jax.tree_util.keystr(path)
            if "pos_conv" in key and "kernel" in key:
                np.testing.assert_allclose(leaf, flat_b[path], rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(leaf, flat_b[path], err_msg=key)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_train_mode_post_ln_gated_layer_takes_module_path(params, monkeypatch, precision):
    """A post-LN gated layer in train() mode calls neither K2 nor K11 and
    its values equal the eval-mode module path's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a forward-only kernel in train() mode")

    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    monkeypatch.setattr(port_wavlm, "fused_int8_ffn", refuse)
    monkeypatch.setattr(port_wavlm, "gated_bias_attention_outproj", refuse)
    up = _port(params, precision, **({"wavlm_fuse": True} if precision == "int8" else {}))
    layer = up.model.encoder.layers[0].train()
    x = torch.from_numpy(np.random.RandomState(44).randn(2, 50, 128).astype(np.float32))
    x = x.bfloat16()
    kv = torch.tensor([50, 20], dtype=torch.int32)
    pad = torch.arange(50)[None, :] >= kv[:, None]
    args = up.model.encoder._layer_args(50, x.device)
    with torch.no_grad():
        got = layer(x, kv, pad, *args)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: False)
    with torch.no_grad():
        assert torch.equal(got, layer.eval()(x, kv, pad, *args))
