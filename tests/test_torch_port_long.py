"""Long utterances (T > MAX_BLOCK_T frames) in s3prl_tpu_torch vs s3prl_tpu (CPU).

K6 `fused_qkv_attention_outproj`, K7 `fused_qkv_attention` and K8
`online_flash_attention`: the port's wrappers on CPU tensors (their plain
versions) against the JAX functions with their Pallas kernels in interpret
mode, on the same numpy inputs; then the tiny HuBERT-Large-style trunk of
`test_torch_port_slice.py` through those routes, with MAX_BLOCK_T and
MAX_KERNEL_T patched down in both packages. Tolerances:
- bf16 outputs (K6, K7, K8): cosine > 0.99999 and every element within
  max(1e-2, one bf16 step at the larger of the two values). The plain
  versions keep the Pallas cast points, so only the order of f32 sums
  differs: a value can round one step apart, a value near 0 that comes
  from cancelling sums more than a step (by < 1e-5 here), and K6 beyond
  MAX_KERNEL_T quantizes a bf16 context, where one step moves a code;
- f32 outputs (K7, K8 with f32 inputs): atol 1e-5 (sum order only);
- the trunk: per-layer cosine > 0.999 over valid frames (the JAX package's
  gate for its reduced-precision paths), lengths exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
from test_torch_port_slice import (  # noqa: F401 (fixtures)
    _batch, _jax_defaults, _layer_cosines, _port, _run_jax, _run_port, jax_params)

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    cos = got.ravel() @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want))
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    bound = np.maximum(np.exp2(np.floor(np.log2(mag)) - 7), 1e-2)
    err = np.abs(got - want)
    assert cos > 0.99999 and (err <= bound).all(), (cos, err.max())


def _qkv(seed, B, T, C, scale=1.0):
    return np.random.RandomState(seed).randn(B, T, 3 * C).astype(np.float32) * scale


def test_thresholds_are_the_jax_packages():
    assert (port_fa.MAX_BLOCK_T, port_fa.MAX_KERNEL_T) == (jax_fa.MAX_BLOCK_T,
                                                           jax_fa.MAX_KERNEL_T) == (512, 2048)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k7_plain_matches_interpreted_pallas(dtype):
    """K7 whole-T: mixed kv_lens including 1, head dim 64."""
    jdt, tdt = DTYPES[dtype]
    B, T, H = 3, 77, 2
    qkv = _qkv(0, B, T, H * 64)
    kv = np.array([77, 40, 1], np.int32)
    want = jax_fa.fused_qkv_attention(jnp.asarray(qkv, jdt), jnp.asarray(kv), H, interpret=True)
    got = port_fa.fused_qkv_attention(torch.from_numpy(qkv).to(tdt), torch.from_numpy(kv), H)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("Dh", [64, 32])
def test_k7_hands_over_to_k8_beyond_max_kernel_t(monkeypatch, Dh):
    """Beyond MAX_KERNEL_T (patched to 128 in both packages) K7 splits the
    heads, pre-scales q in bf16 (exactly for Dh = 64, rounded for Dh = 32,
    as jnp's weakly typed scalar) and runs K8."""
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_KERNEL_T", 128)
    calls = []
    plain = port_fa.online_flash_attention_reference
    monkeypatch.setattr(port_fa, "online_flash_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    B, T, H = 2, 300, 2
    qkv = _qkv(1, B, T, H * Dh)
    kv = np.array([300, 1], np.int32)
    want = jax_fa.fused_qkv_attention(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(kv), H,
                                      interpret=True)
    got = port_fa.fused_qkv_attention(torch.from_numpy(qkv).bfloat16(), torch.from_numpy(kv), H)
    assert calls == [1]
    _close(got, want, "bf16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_plain_matches_interpreted_pallas(dtype):
    """T = 1,100 > 1,024: the Pallas kernel loops over two key blocks."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(2)
    B, H, T = 2, 2, 1100
    q, k, v = (rng.randn(B, H, T, 64).astype(np.float32) * s for s in (0.3, 0.3, 1.0))
    kv = np.array([1100, 1], np.int32)
    want = jax_fa.online_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                         jnp.asarray(kv), interpret=True)
    got = port_fa.online_flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                         torch.from_numpy(kv))
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("route,max_kernel_t", [("whole", 2048), ("online", 64)])
def test_k6_plain_matches_interpreted_pallas(monkeypatch, route, max_kernel_t):
    """K6 below MAX_KERNEL_T (f32 context, f32 row-quant, int8 out-proj +
    bias + residual in f32) and above a patched one (K7 -> K8, then
    residual + int8_matmul); raw f32 weights, quantized inside both."""
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    rng = np.random.RandomState(3)
    B, T, H, C = 3, 77, 2, 128
    qkv = _qkv(4, B, T, C)
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    wo = rng.randn(C, C).astype(np.float32) / np.sqrt(C)  # JAX layout [C_in, C_out]
    bo = rng.randn(C).astype(np.float32) * 0.02
    kv = np.array([77, 40, 1], np.int32)
    want = jax_fa.fused_qkv_attention_outproj(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jnp.asarray(wo),
        jnp.asarray(bo), jnp.asarray(kv), H, interpret=True)
    got = port_fa.fused_qkv_attention_outproj(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(x).bfloat16(),
        torch.from_numpy(wo.T.copy()), torch.from_numpy(bo), torch.from_numpy(kv), H)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16")


@pytest.mark.parametrize("C", [768, 1024])
def test_k6_panel_f32_rule_plain_matches(C):
    """The plain counterpart of csrc/int8_panel.cu's f32-row rule, which K6
    takes on the card (`int8_panel_reference`), on K6's f32 context: its
    codes and scales equal `quantize_rows`' and its out-proj equals K6's
    plain tail (`_outproj_reference`) bit for bit; the whole of it against
    the JAX kernel at the bar of `test_k6_plain_matches_interpreted_pallas`."""
    from s3prl_tpu_torch.kernels import _common
    from s3prl_tpu_torch.ops.quant import as_quantized_cols, quantize_rows

    rng = np.random.RandomState(5)
    B, T, H = 2, 65, C // 64
    qkv = _qkv(6, B, T, C)
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    wo = rng.randn(C, C).astype(np.float32) / np.sqrt(C)  # JAX layout [C_in, C_out]
    bo = rng.randn(C).astype(np.float32) * 0.02
    kv = np.array([65, 33], np.int32)
    qkv_t, x_t = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(x).bfloat16()
    wo_q, wo_s = as_quantized_cols(torch.from_numpy(wo.T.copy()))
    ctx = port_fa.attention_reference(qkv_t, torch.from_numpy(kv), H,
                                      out_dtype=torch.float32).reshape(B * T, C)
    got, q, s = _common.int8_panel_reference(ctx, wo_q, wo_s, torch.from_numpy(bo),
                                             residual=x_t.view(B * T, C))
    q_ref, s_ref = quantize_rows(ctx)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref[:, 0])
    want = port_fa._outproj_reference(ctx.view(B, T, C), x_t, (wo_q, wo_s),
                                      torch.from_numpy(bo), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(B, T, C), want)
    jax_want = jax_fa.fused_qkv_attention_outproj(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jnp.asarray(wo),
        jnp.asarray(bo), jnp.asarray(kv), H, interpret=True)
    _close(got.view(B, T, C), jax_want, "bf16")


ROUTES = {  # path-route -> (quantize, MAX_KERNEL_T, the port's plain version that must run)
    "int8-k6": (True, 2048, "fused_qkv_attention_outproj_reference"),
    "int8-k8": (True, 128, "online_flash_attention_reference"),
    "bf16-k7": (False, 2048, "fused_qkv_attention_reference"),
    "bf16-k8": (False, 128, "online_flash_attention_reference"),
}


@pytest.mark.parametrize("route", ROUTES)
def test_long_slice_matches_jax(jax_params, monkeypatch, route):
    """The tiny trunk at T' = 320 frames with MAX_BLOCK_T = 64 in both
    packages: int8 through K6 (or K8 with MAX_KERNEL_T = 128) and K2, bf16
    through K7 (or K8) and K5; JAX in interpret mode, the port's wrappers
    on CPU tensors."""
    quantize, max_kernel_t, plain = ROUTES[route]
    for fa in (jax_fa, port_fa):
        monkeypatch.setattr(fa, "MAX_BLOCK_T", 64)
        monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    calls = []
    fn = getattr(port_fa, plain)
    monkeypatch.setattr(port_fa, plain, lambda *a: calls.append(1) or fn(*a))
    wavs, lens = _batch(9, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens, jnp.bfloat16, flash=True,
                               quantize=quantize)
    got, got_lens = _run_port(_port(jax_params, torch.bfloat16, flash=True, quantize=quantize),
                              wavs, lens)
    assert len(calls) == 2  # one per layer
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 3, 320, 128)
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss


def test_train_mode_bf16_flash_layer_takes_module_path(jax_params, monkeypatch):
    """A bf16 flash layer in train() mode runs the module path (LN,
    SelfAttention with K7's plain version, erf FFN), never the forward-only
    K4/K5, as the JAX package's `deterministic` gates them
    (s3prl_tpu/models/transformer.py:496-502, :540-546); gradients flow."""
    def refuse(*args, **kwargs):
        raise AssertionError("a forward-only block kernel in train() mode")

    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    monkeypatch.setattr(port_transformer, "fused_attention_block_bf16", refuse)
    monkeypatch.setattr(port_transformer, "fused_bf16_ffn", refuse)
    layer = _port(jax_params, torch.bfloat16, flash=True).model.encoder.layers[0].train()
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 50, 128).astype(np.float32))
    x = x.bfloat16()
    kv = torch.tensor([50, 20], dtype=torch.int32)
    pad = torch.arange(50)[None, :] >= kv[:, None]
    got = layer(x, kv, pad)
    got.float().sum().backward()
    assert layer.fc1.weight.grad is not None and layer.self_attn.qkv_weight.grad is not None
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: False)
    with torch.no_grad():
        assert torch.equal(got.detach(), layer.eval()(x, kv, pad))
