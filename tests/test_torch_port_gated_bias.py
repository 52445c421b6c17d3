"""WavLM's gated-bias attention with the bias in the bytes it needs (CPU).

The bf16 WavLM hands K9 and K10 (`csrc/gated_attention.cu`) its pos_bias as
a bf16 buffer [H, T, Tp], Tp = T rounded up to 8, viewed as [:, :, :T]
(`WavLMEncoder._layer_args`); ``wavlm_fuse`` (K11) an f32 buffer with Tp =
T rounded up to 4, viewed likewise; the f32 model keeps the contiguous f32
bias. Here, against the JAX package on the same numpy inputs:
- the port's K9 and K10 wrappers on CPU tensors (their plain versions)
  given the padded bf16 bias, against JAX `gated_bias_attention` given the
  same bf16 bias through its CPU route (Pallas in interpret mode), at T =
  65 and 130 (K9; K10 with MAX_KERNEL_T patched to 64 in both packages),
  kv_lens [1, 63, 64, 65, T]: f32 q, k, v at atol 2e-5 over valid rows (the
  bar of tests/test_kernels.py:15-33), bf16 at cosine > 0.9999 (as
  tests/test_torch_port_wavlm.py);
- the plain versions given the padded bf16 bias and the contiguous f32 one
  of the same values: equal bit for bit (bf16 -> f32 is exact);
- `_layer_args`' three forms, each equal to the f32 gather of the rounded
  table;
- a tiny WavLM (tests/test_torch_port_wavlm.py's) at T' = 150 frames, so
  that the buffer is padded, bf16 and int8 through both packages' kernel
  routes: per-layer cosine > 0.999 over valid frames, lengths equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.wavlm as port_wavlm
from s3prl_tpu.models.wavlm import relative_position_buckets as jax_buckets
from test_torch_port_slice import _batch, _cos, _layer_cosines
from test_torch_port_wavlm import (  # noqa: F401 (fixtures)
    PCFG, _jax_defaults, _kernels_on, _max_kernel_t, _port, _run_jax, _run_port, _spy,
    jax_params)

KV_EDGES = (1, 63, 64, 65)


def _padded(bias: np.ndarray) -> torch.Tensor:
    """bias [H, T, T] f32 -> bf16 in a [H, T, Tp] buffer (Tp = T rounded up
    to 8, the padding NaN), viewed as [:, :, :T]."""
    H, T, _ = bias.shape
    buf = torch.full((H, T, -(-T // 8) * 8), float("nan"), dtype=torch.bfloat16)
    buf[:, :, :T] = torch.from_numpy(bias)
    return buf[:, :, :T]


def _inputs(seed, T, H=2, Dh=64):
    """q (pre-scaled), k, v; a pos_bias from the bucket table of a random
    [64, H] table, as the padded bf16 view; gates in (1, 3); kv_lens
    [1, 63, 64, 65, T]."""
    rng = np.random.RandomState(seed)
    kv = np.array([*KV_EDGES, T], np.int32)
    B = len(kv)
    q, k, v = (rng.randn(B, H, T, Dh).astype(np.float32) * s for s in (Dh ** -0.5, 1, 1))
    table = rng.randn(64, H).astype(np.float32)
    pos_bias = _padded(np.ascontiguousarray(table[jax_buckets(T, 64, 160)].transpose(2, 0, 1)))
    gate = 1.0 + 2.0 * rng.rand(B, H, T).astype(np.float32)
    return q, k, v, pos_bias, gate, kv


ROUTES = {"k9": (2048, "gated_bias_attention_reference"),
          "k10": (64, "gated_online_flash_attention_reference")}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [65, 130])
@pytest.mark.parametrize("route", ROUTES)
def test_padded_bf16_bias_matches_jax(monkeypatch, route, T, dtype):
    max_kernel_t, plain = ROUTES[route]
    _max_kernel_t(monkeypatch, max_kernel_t)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v, pos_bias, gate, kv = _inputs(31, T)
    assert pos_bias.stride(1) == -(-T // 8) * 8
    calls = _spy(monkeypatch, port_fa, plain)
    want = jax_fa.gated_bias_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        jnp.asarray(pos_bias.float().numpy(), jnp.bfloat16), jnp.asarray(gate), jnp.asarray(kv),
        interpret=True)
    got = port_fa.gated_bias_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                       pos_bias, torch.from_numpy(gate), torch.from_numpy(kv))
    assert len(calls) == 1 and calls[0][0][3] is pos_bias and got.dtype == tdt
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    for b, n in enumerate(kv):  # valid query rows
        if dtype == "f32":
            np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=2e-5, rtol=0)
        else:
            assert _cos(got[b, :, :n], want[b, :, :n]) > 0.9999, b


@pytest.mark.parametrize("route", ROUTES)
def test_padded_bf16_bias_equals_f32_bias_bit_for_bit(monkeypatch, route):
    _max_kernel_t(monkeypatch, ROUTES[route][0])
    q, k, v, pos_bias, gate, kv = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                   for a in _inputs(32, 130))
    f32 = pos_bias.float().contiguous()
    assert f32.stride(1) == 130 and pos_bias.stride(1) == 136
    q, k, v = (t.bfloat16() for t in (q, k, v))
    assert torch.equal(port_fa.gated_bias_attention(q, k, v, pos_bias, gate, kv),
                       port_fa.gated_bias_attention(q, k, v, f32, gate, kv))


FORMS = {  # name -> (model dtype, use_flash, wavlm_fuse, the bias dtype, padded)
    "flash-bf16": (torch.bfloat16, True, False, torch.bfloat16, True),
    "flash-bf16-wavlm_fuse": (torch.bfloat16, True, True, torch.float32, True),
    "flash-f32": (torch.float32, True, False, torch.float32, False),
    "no-flash-bf16": (torch.bfloat16, False, False, torch.bfloat16, False),
    "no-flash-f32": (torch.float32, False, False, torch.float32, False),
}


@pytest.mark.parametrize("form", FORMS)
def test_layer_args_form(form):
    """The bias in the form its layers' kernels read, holding the values of
    the f32 gather of the table rounded to the model dtype."""
    dtype, flash, fuse, want_dtype, padded = FORMS[form]
    enc = port_wavlm.WavLMEncoder(PCFG, dtype, use_flash=flash, quantize=fuse, device="cpu",
                                  wavlm_fuse=fuse)
    T = 149
    (pos_bias,) = enc._layer_args(T, torch.device("cpu"))
    H = PCFG.encoder_attention_heads
    assert pos_bias.shape == (H, T, T) and pos_bias.dtype == want_dtype
    if padded:  # T = 149 rounded up to 8 (bf16) or to 4 (f32): 152
        assert pos_bias.stride() == (T * 152, 152, 1)
        assert pos_bias.untyped_storage().nbytes() == H * T * 152 * pos_bias.element_size()
    else:
        assert pos_bias.is_contiguous()
    table = enc.layers[0].self_attn.relative_attention_bias.weight.detach()
    buckets = torch.from_numpy(jax_buckets(T, PCFG.num_buckets, PCFG.max_distance))
    want = table.t().to(dtype).float()[:, buckets]
    assert torch.equal(pos_bias.float(), want)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_tiny_wavlm_with_padded_bias_matches_jax(jax_params, monkeypatch, precision):
    """T' = 150 frames (Tp = 152): both packages' kernel routes (K9), the
    port's plain K9 given the padded bf16 bias in both layers."""
    _kernels_on(monkeypatch)
    calls = _spy(monkeypatch, port_fa, "gated_bias_attention_reference")
    wavs, lens = _batch(33, [3000, 1700])
    want, want_lens = _run_jax(jax_params, wavs, lens, precision)
    got, got_lens = _run_port(_port(jax_params, precision), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 2, 150, 128)
    assert len(calls) == 2 and calls[0][0][3] is calls[1][0][3]
    pos_bias = calls[0][0][3]
    assert pos_bias.dtype == torch.bfloat16 and pos_bias.stride(1) == 152
    coss = _layer_cosines(got, want, got_lens)
    assert min(coss) > 0.999, coss
