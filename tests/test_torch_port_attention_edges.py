"""Attention at kv_lens on the 64-key tile edges, s3prl_tpu_torch vs s3prl_tpu (CPU).

The port's attention kernels walk the keys in tiles of 64 and skip the
tiles wholly past kv_len, so the lengths 1, 63, 64, 65, 127, 128 and T
(one per utterance of B = 7) are where a tile is cut, skipped or masked in
part. Here the port's wrappers on CPU tensors (their plain versions, which
the card holds its kernels against) meet the JAX functions with their
Pallas kernels in interpret mode, on the same numpy inputs:

- K7 `fused_qkv_attention` at T = 65, 127, 129, bf16 and f32;
- K6 `fused_qkv_attention_outproj` at T = 65, 129;
- K8 `online_flash_attention` at T = 129 and 1,100 (two of the Pallas
  kernel's 1,024-key blocks), bf16 and f32;
- K4 `fused_attention_block_bf16` and K1 `fused_attention_block` at
  T = 127.

Tolerances are those of the files the cases come from:
`test_torch_port_long.py` (K6, K7, K8) and `test_torch_port_kernels.py`
(K1, K4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu_torch.kernels.flash_attention as port_fa
from s3prl_tpu_torch.ops.quant import as_quantized_cols
from test_torch_port_kernels import (  # noqa: F401 (fixture)
    INT8_ATOL, _attn_inputs, _bf16_pair, _cos, _jax_defaults, _np)
from test_torch_port_long import DTYPES, _close, _qkv

B = 7
KV_EDGES = (1, 63, 64, 65, 127, 128)


def _edge_kv(T):
    """One kv_len per utterance: the tile edges, then T (capped at T)."""
    return np.array([min(n, T) for n in KV_EDGES + (T,)], np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [65, 127, 129])
def test_k7_at_tile_edges(T, dtype):
    jdt, tdt = DTYPES[dtype]
    H = 2
    qkv, kv = _qkv(10, B, T, H * 64), _edge_kv(T)
    want = jax_fa.fused_qkv_attention(jnp.asarray(qkv, jdt), jnp.asarray(kv), H, interpret=True)
    got = port_fa.fused_qkv_attention(torch.from_numpy(qkv).to(tdt), torch.from_numpy(kv), H)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("T", [65, 129])
def test_k6_at_tile_edges(T):
    rng = np.random.RandomState(11)
    H, C = 2, 128
    qkv, kv = _qkv(12, B, T, C), _edge_kv(T)
    x = rng.randn(B, T, C).astype(np.float32) * 0.5
    wo = rng.randn(C, C).astype(np.float32) / np.sqrt(C)  # JAX layout [C_in, C_out]
    bo = rng.randn(C).astype(np.float32) * 0.02
    want = jax_fa.fused_qkv_attention_outproj(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jnp.asarray(wo),
        jnp.asarray(bo), jnp.asarray(kv), H, interpret=True)
    got = port_fa.fused_qkv_attention_outproj(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(x).bfloat16(),
        torch.from_numpy(wo.T.copy()), torch.from_numpy(bo), torch.from_numpy(kv), H)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [129, 1100])
def test_k8_at_tile_edges(T, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(B, 1, T, 64).astype(np.float32) * s for s in (0.3, 0.3, 1.0))
    kv = _edge_kv(T)
    want = jax_fa.online_flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                         jnp.asarray(kv), interpret=True)
    got = port_fa.online_flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                         torch.from_numpy(kv))
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("kernel", ["K4", "K1"])
def test_attention_blocks_at_tile_edges(kernel):
    """K4 (bf16) and K1 (int8 W8A8, dynamic scales) at T = 127: the cosine
    over each utterance's valid rows, and K1 within INT8_ATOL everywhere."""
    T, C, H = 127, 128, 2
    x, wq, bq, wo, bo, g, be = _attn_inputs(14, B, T, C)
    kv = _edge_kv(T)
    jx, tx = _bf16_pair(x)
    jax_fn = jax_fa.fused_attention_block_bf16 if kernel == "K4" else jax_fa.fused_attention_block
    want = jax_fn(jx, jnp.asarray(wq), jnp.asarray(bq), (jnp.asarray(g), jnp.asarray(be)),
                  jnp.asarray(wo), jnp.asarray(bo), jnp.asarray(kv), H, interpret=True)
    t = torch.from_numpy
    if kernel == "K4":
        got = port_fa.fused_attention_block_bf16(
            tx, t(wq.T.copy()).bfloat16(), t(bq), (t(g), t(be)), t(wo.T.copy()).bfloat16(),
            t(bo), t(kv), H)
    else:
        got = port_fa.fused_attention_block(
            tx, as_quantized_cols(t(wq.T.copy())), t(bq), (t(g), t(be)),
            as_quantized_cols(t(wo.T.copy())), t(bo), t(kv), H)
        np.testing.assert_allclose(_np(got), _np(want), atol=INT8_ATOL, rtol=0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, C)
    for i, n in enumerate(kv):
        assert _cos(_np(got)[i, :n], _np(want)[i, :n]) > 0.9995, i
