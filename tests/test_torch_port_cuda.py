"""CUDA kernels of s3prl_tpu_torch against their plain PyTorch versions on
the card (same CUDA inputs through both). Needs an NVIDIA GPU with nvcc;
skipped elsewhere. On the GPU machine (no jax there, so without the suite's
conftest):

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_port_cuda.py

Tolerances: f32 outputs at atol 1e-4 (sum order only); bf16 outputs at
cosine > 0.9995 and every element within max(3e-2, one bf16 step at the
plain value) of it (one step is 0.03125 where outputs reach |v| >= 4): the
kernel and the plain version sum in other orders, so a value near a
rounding boundary can land one step apart. int8 sums are exact in any
order: the int8 GEMM equals torch._int_mm bit for bit, and the quantizers
equal their plain versions wherever their f32 inputs agree. The
long-utterance wrappers (K6, K7) are held against the plain versions of
the route they take, run by the same wrapper on CPU copies of the inputs:
beyond MAX_KERNEL_T that route is K8's; so are WavLM's gated-bias wrappers
(K9, and K10 beyond MAX_KERNEL_T), and K11 (K9 -> K10 and stock ops
beyond MAX_KERNEL_T). Launch counts are listed in `wrappers()` order:
conv0, K1, K2, K4, K5, K6, K7, K8, K9, K10, K11, K12, K13a, K13b, K14, K15
K16a, K16b, K17 (trailing zeros may be left out). The front-end kernels'
int8 codes equal their plain versions' except at most 0.1% one step apart,
and their scales agree at rtol 1e-5: the f32 conv and LN sums run in
another order. K16b's activation codes and scales equal their plain
version's exactly (the same f32 values, an IEEE division), both the
quantizer's and the ones K16b's conv kernel quantizes into its windows.
"""

import copy

import numpy as np
import pytest
import torch

from s3prl_tpu_torch.kernels import _build, _common
from s3prl_tpu_torch.kernels import conv_frontend as cf
from s3prl_tpu_torch.kernels.conv_frontend import (
    conv0_ln_gelu, conv0_ln_gelu_q8, conv0_ln_gelu_q8_reference, conv0_ln_gelu_reference,
    conv_gemm_weight, fused_conv_ln_gelu, fused_conv_ln_gelu_reference, fused_int8_conv_ln_gelu,
    fused_int8_conv_ln_gelu_reference, quantize_conv_taps)
from s3prl_tpu_torch.kernels.ffn import (
    fused_bf16_ffn, fused_bf16_ffn_reference, fused_int8_ffn, fused_int8_ffn_reference)
from s3prl_tpu_torch.kernels import flash_attention as fa
from s3prl_tpu_torch.kernels import wrappers
from s3prl_tpu_torch.kernels.flash_attention import (
    attention_reference, fused_attention_block, fused_attention_block_bf16,
    fused_attention_block_bf16_reference, fused_attention_block_reference,
    fused_qkv_attention, fused_qkv_attention_outproj, gated_bias_attention,
    gated_bias_attention_reference, gated_online_flash_attention,
    gated_online_flash_attention_reference, online_flash_attention,
    online_flash_attention_reference, quantize_context_reference)
from s3prl_tpu_torch.kernels.ffn import fused_int8_linear, fused_int8_linear_reference
from s3prl_tpu_torch.kernels.ln_gelu import ln_gelu, ln_gelu_reference
from s3prl_tpu_torch.kernels import posconv as pc
from s3prl_tpu_torch.ops.quant import as_quantized_cols, int_mm, quantize_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)


def _close_bf16(got, want):
    a = got.float().flatten().cpu().numpy().astype(np.float64)
    b = want.float().flatten().cpu().numpy().astype(np.float64)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    err = np.abs(a - b)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
    assert cos > 0.9995 and (err <= np.maximum(step, 3e-2)).all(), (cos, err.max())


def _block_weights(rng, dev, C, N):
    w = _t(rng.randn(N, C) / np.sqrt(C), dev, torch.bfloat16)
    b = _t(rng.randn(N) * 0.02, dev)
    return w, b


def _ln(rng, dev, C):
    return (_t(1.0 + 0.1 * rng.randn(C), dev), _t(0.1 * rng.randn(C), dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv0_ln_gelu_kernel(dev, dtype):
    rng = np.random.RandomState(0)
    wavs = _t(rng.randn(3, 16007), dev, dtype)  # ragged last frame block
    weight = _t(rng.randn(512, 1, 10) / np.sqrt(10), dev, dtype)
    g, b = _ln(rng, dev, 512)
    before = conv0_ln_gelu.launches
    got = conv0_ln_gelu(wavs, weight, g, b)
    torch.cuda.synchronize()
    assert conv0_ln_gelu.launches == before + 1
    want = conv0_ln_gelu_reference(wavs, weight, g, b)
    assert got.shape == want.shape == (3, (16007 - 10) // 5 + 1, 512)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("M,N,K", [(77, 40, 24), (300, 384, 200), (129, 136, 64)])
@pytest.mark.parametrize("mode", ["bias", "gelu", "residual", "f32"])
def test_gemm_kernel_ragged_edges(dev, M, N, K, mode):
    rng = np.random.RandomState(1)
    a = _t(rng.randn(M, K) * 0.5, dev, torch.bfloat16)
    w, bias = _block_weights(rng, dev, K, N)
    res = _t(rng.randn(M, N) * 0.5, dev, torch.bfloat16) if mode == "residual" else None
    got = _common.gemm(a, w, bias, residual=res, gelu=mode == "gelu",
                       out_f32=mode == "f32")
    want = a.float() @ w.float().t() + bias
    if mode == "gelu":
        want = torch.nn.functional.gelu(want)
    if res is not None:
        want = want + res.float()
    if mode == "f32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _close_bf16(got, want.to(torch.bfloat16))


def _linear_f32(a2, w, bias=None, gelu=False, res=None):
    """F.linear in f32 math on the bf16 operands, then erf GELU, then the
    residual: what `gemm` computes before its one cast."""
    y = torch.nn.functional.linear(a2.float(), w.float(), bias)
    if gelu:
        y = torch.nn.functional.gelu(y)
    return y if res is None else y + res.float()


def _check_gemm(a, w, bias=None, gelu=False, res=None, out_f32=False):
    got = _common.gemm(a, w, bias, residual=res, gelu=gelu, out_f32=out_f32)
    torch.cuda.synchronize()
    want = _linear_f32(a.reshape(-1, a.shape[-1]), w, bias, gelu, res)
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    if out_f32:  # f32 sums in another order
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _close_bf16(got, want.to(torch.bfloat16))


# (M, N, K) on and beside the bf16 wgmma core's tile edges (128 rows, 256
# columns, 64-element K stages), and the main path's widths
GEMM_BF16_EDGES = [(M, N, K) for M in (1, 127, 128, 129, 300) for N in (8, 256, 264)
                   for K in (8, 64, 72, 1000)] + [(257, 1024, 4096), (200, 4096, 1024),
                                                  (130, 3072, 1024)]


@pytest.mark.parametrize("M,N,K", GEMM_BF16_EDGES)
def test_gemm_bf16_tile_edges(dev, M, N, K):
    """`gemm` (csrc/gemm_bf16.cu) against F.linear in f32 math, bare (bf16
    out) and with every epilogue flag (bias, GELU, residual, f32 out)."""
    rng = np.random.RandomState(M * 7 + N * 3 + K)
    a = _t(rng.randn(M, K) * 0.5, dev, torch.bfloat16)
    w, bias = _block_weights(rng, dev, K, N)
    res = _t(rng.randn(M, N) * 0.5, dev, torch.bfloat16)
    _check_gemm(a, w)
    _check_gemm(a, w, bias, gelu=True, res=res, out_f32=True)


@pytest.mark.parametrize("out_f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "res"])
@pytest.mark.parametrize("gelu", [False, True], ids=["", "gelu"])
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
def test_gemm_bf16_epilogue_flags(dev, bias, gelu, residual, out_f32):
    """Every set of epilogue flags on a ragged M, N and K."""
    rng = np.random.RandomState(4)
    M, N, K = 300, 264, 200
    a = _t(rng.randn(M, K) * 0.5, dev, torch.bfloat16)
    w, b = _block_weights(rng, dev, K, N)
    res = _t(rng.randn(M, N) * 0.5, dev, torch.bfloat16) if residual else None
    _check_gemm(a, w, b if bias else None, gelu=gelu, res=res, out_f32=out_f32)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("B,T", [(1, 3), (2, 130), (3, 257), (2, 999)])
def test_gemm_bf16_row_groups(dev, B, T, k):
    """Row-group views [B, T', k * 512] with lda = 2C read in place from x
    [B, T, 512], as K14's stride-2 im2col rows: k = 1 rows apart, k = 2 rows
    that abut, k = 3 rows that overlap (three tensor maps, one per tap);
    T' not a multiple of the 128-row tile; f32 out (K14) and bf16 with a
    bias."""
    from s3prl_tpu_torch.kernels.conv_frontend import _im2col

    rng = np.random.RandomState(B * T + k)
    x = _t(rng.randn(B, T, 512), dev, torch.bfloat16)
    t_out = (T - k) // 2 + 1
    rows = _im2col(x, k, t_out)
    assert rows.stride(1) == 1024 and rows.shape[-1] == k * 512
    w, bias = _block_weights(rng, dev, k * 512, 512)
    _check_gemm(rows, w, out_f32=True)
    _check_gemm(rows, w, bias, gelu=True)


def test_gemm_refuses_rows_its_maps_cannot_split(dev):
    """Overlapping rows whose shared run (gcd of the row stride and K) is
    not a multiple of a 64-element stage: the kernel's tensor maps cannot
    read them, so the wrapper raises before any launch."""
    x = _t(np.random.RandomState(5).randn(1, 9, 72), dev, torch.bfloat16)
    rows = x.as_strided((1, 4, 216), (9 * 72, 144, 1))
    w, _ = _block_weights(np.random.RandomState(6), dev, 216, 64)
    with pytest.raises(ValueError, match="overlap"):
        _common.gemm(rows, w, out_f32=True)


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layernorm_kernel(dev, src):
    rng = np.random.RandomState(2)
    x = _t(rng.randn(333, 1024) * 2 + 0.5, dev, src)
    g, b = _ln(rng, dev, 1024)
    got = _common.layer_norm(x, g, b)
    want = torch.nn.functional.layer_norm(x.float(), (1024,), g, b, eps=1e-5)
    _close_bf16(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("out_f32", [False, True], ids=["bf16", "f32"])
def test_attention_kernel_ragged(dev, out_f32):
    """The attention launch alone at a ragged T with kv_len 1 and a full
    row, with the bf16 output and K6's f32 one."""
    rng = np.random.RandomState(3)
    B, T, H = 3, 131, 4
    qkv = _t(rng.randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    kv = torch.tensor([131, 70, 1], dtype=torch.int32, device=dev)
    out = fa._attention(qkv, kv, H, out_f32=out_f32)
    want = attention_reference(qkv, kv, H, out_dtype=out.dtype)
    _close_bf16(out.view(B, T, -1), want)


# (postnorm, C, H): pre-LN and postnorm at C 256, postnorm at the Base models'
# width (C 768, H 12: HuBERT-Base's route)
BLOCK_FORMS = pytest.mark.parametrize("postnorm,C,H", [(False, 256, 4), (True, 256, 4),
                                                       (True, 768, 12)],
                                      ids=["preln", "postnorm", "postnorm-C768"])


@BLOCK_FORMS
@pytest.mark.parametrize("T", [499, 64])
def test_attention_block_kernel(dev, postnorm, C, H, T):
    rng = np.random.RandomState(4)
    B = 4
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    wq, bq = _block_weights(rng, dev, C, 3 * C)
    wo, bo = _block_weights(rng, dev, C, C)
    ln = _ln(rng, dev, C)
    kv = torch.tensor([T, T, (T * 5) // 8, 1], dtype=torch.int32, device=dev)
    before = fused_attention_block_bf16.launches
    got = fused_attention_block_bf16(x, wq, bq, ln, wo, bo, kv, H, postnorm=postnorm)
    torch.cuda.synchronize()
    assert fused_attention_block_bf16.launches == before + 1
    want = fused_attention_block_bf16_reference(x, wq, bq, ln, wo, bo, kv, H,
                                                postnorm=postnorm)
    _close_bf16(got, want)


@pytest.mark.parametrize("ln,residual,postnorm,C,F", [
    (True, True, False, 256, 1024), (False, False, False, 256, 1024),
    (True, False, False, 256, 1024), (False, True, False, 256, 1024),
    (True, True, True, 256, 1024), (True, True, True, 768, 3072)])
def test_ffn_kernel(dev, ln, residual, postnorm, C, F):
    rng = np.random.RandomState(5)
    B, T = 2, 123
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    w1, b1 = _block_weights(rng, dev, C, F)
    w2, b2 = _block_weights(rng, dev, F, C)
    norm = _ln(rng, dev, C) if ln else None
    before = fused_bf16_ffn.launches
    got = fused_bf16_ffn(x, w1, b1, w2, b2, ln=norm, residual=residual,
                         postnorm=postnorm)
    torch.cuda.synchronize()
    assert fused_bf16_ffn.launches == before + 1
    want = fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln=norm,
                                    residual=residual, postnorm=postnorm)
    _close_bf16(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 8, 256, dtype=torch.float16, device=dev)
    w = torch.zeros(1024, 256, dtype=torch.bfloat16, device=dev)
    b = torch.zeros(1024, device=dev)
    with pytest.raises(TypeError):
        fused_bf16_ffn(x, w, b, w.t().contiguous(), torch.zeros(256, device=dev))
    wav = torch.zeros(1, 1600, device=dev)
    with pytest.raises(ValueError):  # 256 channels: the kernel takes 512
        conv0_ln_gelu(wav, torch.zeros(256, 1, 10, device=dev),
                      torch.ones(256, device=dev), torch.zeros(256, device=dev))
    with pytest.raises(ValueError):  # CPU weights beside a CUDA input
        conv0_ln_gelu(wav, torch.zeros(512, 1, 10), torch.ones(512),
                      torch.zeros(512))


TINY_LAYERS = ((512, 10, 5), (64, 3, 2), (64, 2, 2))
FRONT_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 2, 2))  # the front-end kernels take 512


def _tiny_trunk_pair(dtype, flash, dev, quantize=False, layers=TINY_LAYERS, conv_pos=(16, 4),
                     **fuse):
    """One seed's tiny HuBERT-Large-style trunk on the CPU and on the card
    (conv0 keeps the kernel's 512 channels; head dim 64); ``conv_pos``: the
    pos-conv's (k, groups); ``fuse``: its fused int8 projection, front-end
    and pos-conv options."""
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    cfg = Wav2Vec2Config(
        extractor_mode="layer_norm", conv_feature_layers=layers,
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_pos=conv_pos[0], conv_pos_groups=conv_pos[1],
        layer_norm_first=True, normalize=True)
    return [_trunk_upstream("tiny", cfg, dtype=dtype, flash=flash, quantize=quantize, seed=3,
                            device=d, **fuse)
            for d in ("cpu", dev)]


def _tiny_batch():
    rng = np.random.RandomState(6)
    lens = np.array([6400, 3001, 1])
    wavs = rng.randn(3, 6400).astype(np.float32) * (np.arange(6400) < lens[:, None])
    return torch.from_numpy(wavs), torch.from_numpy(lens)


def _tiny_wavlm_pair(dev, quantize, layers=TINY_LAYERS, conv_pos=(16, 4), **fuse):
    """One seed's tiny WavLM-Large-style model on the CPU and on the card
    (conv0 keeps the kernel's 512 channels; head dim 64)."""
    from s3prl_tpu_torch.models.wavlm import WavLMConfig
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    cfg = WavLMConfig(
        extractor_mode="layer_norm", conv_feature_layers=layers,
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_pos=conv_pos[0], conv_pos_groups=conv_pos[1],
        layer_norm_first=True, normalize=True, dropout_input=0.0, num_buckets=32,
        max_distance=80)
    return [_trunk_upstream("tiny", cfg, dtype=torch.bfloat16, flash=True, quantize=quantize,
                            seed=3, device=d, **fuse)
            for d in ("cpu", dev)]


def _trunk_on_card_vs_cpu(dev, monkeypatch, quantize, launches, wavs=None, lens=None,
                          pair=None):
    """The tiny trunk's routing (or `pair`'s, a (CPU, card) pair of one
    seed's models) on the card against the same seed's model on the CPU,
    whose kernel route runs the wrappers' plain versions: the launch counts
    of one forward (in `wrappers()` order) and per-layer cosine > 0.999 over
    the valid frames of all utterances, the JAX package's bar for bf16
    paths (a length-1 utterance's early layers are exactly 0 on both sides
    under zero-initialised biases)."""
    import s3prl_tpu_torch.models.transformer as port_transformer

    cpu, gpu = pair or _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=quantize)
    if wavs is None:
        wavs, lens = _tiny_batch()
    for w in wrappers():
        w.launches = 0
    hs_gpu, hl_gpu = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers()] == launches + [0] * (len(wrappers()) - len(launches))
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    hs_cpu, hl_cpu = cpu.apply_standardized(wavs, lens)
    assert hl_gpu.tolist() == hl_cpu.tolist()
    valid = list(enumerate(hl_cpu.tolist()))
    for layer in range(hs_cpu.shape[0]):
        a = torch.cat([hs_gpu[layer, b, :n].cpu() for b, n in valid]).double().flatten()
        c = torch.cat([hs_cpu[layer, b, :n] for b, n in valid]).double().flatten()
        assert float(a @ c / (a.norm() * c.norm())) > 0.999, layer


def test_tiny_trunk_bf16_kernels_match_cpu(dev, monkeypatch):
    """The bf16 routing on the card: K3 + K4 + K5 launches."""
    _trunk_on_card_vs_cpu(dev, monkeypatch, False, [1, 0, 0, 2, 2, 0, 0, 0, 0, 0])


def test_tiny_trunk_f32_matches_cpu(dev):
    """f32 on the card: K3's f32 kernel plus stock ops (TF32 off) against the
    CPU at atol 5e-4, the f32 parity bar."""
    cpu, gpu = _tiny_trunk_pair(torch.float32, False, dev)
    wavs, lens = _tiny_batch()
    hs_gpu, _ = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    hs_cpu, hl = cpu.apply_standardized(wavs, lens)
    for b, n in enumerate(hl.tolist()):
        torch.testing.assert_close(hs_gpu[:, b, :n].cpu(), hs_cpu[:, b, :n], atol=5e-4, rtol=0)


def test_f32_flash_on_the_card_needs_k7(dev):
    _, gpu = _tiny_trunk_pair(torch.float32, True, dev)
    wavs, lens = _tiny_batch()
    with pytest.raises(NotImplementedError, match="K7"):
        gpu.apply_standardized(wavs.to(dev), lens.to(dev))


def _int8(rng, dev, *shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)).to(dev)


# M, N, K on and beside the wgmma core's tile edges (128 rows, 256 columns,
# 128-byte K stages; K down to one 16-byte step)
GEMM_EDGES = [(M, N, K) for M in (1, 17, 127, 128, 129, 255, 257) for N in (8, 136, 264)
              for K in (16, 48, 1152, 2048)]


@pytest.mark.parametrize("M,N,K", [(77, 40, 32), (300, 384, 208), (129, 136, 64),
                                   (4 * 499, 3072, 1024)] + GEMM_EDGES)
def test_gemm_s8_equals_int_mm(dev, M, N, K):
    """int32 sums are exact in any order: the kernel equals torch._int_mm
    bit for bit, ragged tiles included."""
    rng = np.random.RandomState(7)
    a, w = _int8(rng, dev, M, K), _int8(rng, dev, N, K)
    got = _common.gemm_s8(a, w)
    assert got.dtype == torch.int32 and torch.equal(got, int_mm(a, w))


def test_gemm_s8_column_ranges(dev):
    """A K range of wider matrices (K2's fc2 chunks): row strides and
    offsets, still exact."""
    rng = np.random.RandomState(8)
    a, w = _int8(rng, dev, 150, 4096), _int8(rng, dev, 264, 4096)
    for lo, hi in ((0, 2048), (2048, 4096), (1024, 1040)):
        got = _common.gemm_s8(a[:, lo:hi], w[:, lo:hi])
        assert torch.equal(got, int_mm(a[:, lo:hi].contiguous(), w[:, lo:hi].contiguous()))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T_out", [1, 63, 129, 499])
def test_gemm_s8_row_groups(dev, B, T_out):
    """A row-group view [B, T', K] with lda = 2C (a stride-2 conv tap's rows
    read in place from x [B, T, C], as K13b reads them; T' not a multiple of
    the 128-row tile): every group is tiled on its own, so no tile mixes two
    utterances; bit for bit against torch._int_mm on a contiguous copy, and
    the linear epilogue's rows keep their scales."""
    rng = np.random.RandomState(17)
    C, N = 512, 264
    for offset in (0, 1):
        T = 2 * T_out + offset
        x = _int8(rng, dev, B, T, C)
        rows = x.as_strided((B, T_out, C), (T * C, 2 * C, 1), offset * C)
        w = _int8(rng, dev, N, C)
        want = int_mm(rows.reshape(B * T_out, C).contiguous(), w)
        assert torch.equal(_common.gemm_s8(rows, w), want)
        rs, cs = _t(rng.rand(B * T_out) * 0.01, dev), _t(rng.rand(N) * 0.01, dev)
        got = _common.gemm_s8(rows, w, mode=_common.GEMM_LINEAR, row_scale=rs, col_scale=cs,
                              out_f32=True)
        assert torch.equal(got, want.float() * rs[:, None] * cs)


def test_gemm_s8_linear_f32_equals_plain_chain(dev):
    """GEMM_LINEAR with f32 out and no GELU rounds every step as the plain
    f32 chain does (one __fmul_rn / __fadd_rn each, in the Pallas order), so
    the two are equal bit for bit, in place (acc_in is out) too."""
    rng = np.random.RandomState(18)
    M, N, K = 300, 264, 1152
    a, w = _int8(rng, dev, M, K), _int8(rng, dev, N, K)
    rs, cs = _t(rng.rand(M) * 0.01, dev), _t(rng.rand(N) * 0.01, dev)
    bias, prev = _t(rng.randn(N) * 0.1, dev), _t(rng.randn(M, N), dev)
    res = _t(rng.randn(M, N), dev, torch.bfloat16)
    lin = int_mm(a, w).float() * rs[:, None] * cs
    kw = dict(mode=_common.GEMM_LINEAR, row_scale=rs, col_scale=cs, out_f32=True)
    assert torch.equal(_common.gemm_s8(a, w, **kw), lin)
    assert torch.equal(_common.gemm_s8(a, w, bias=bias, **kw), lin + bias)
    got = _common.gemm_s8(a, w, bias=bias, acc_in=prev, residual=res, **kw)
    assert torch.equal(got, ((prev + lin) + bias) + res.float())
    out = prev.clone()
    _common.gemm_s8(a, w, acc_in=out, out=out, **kw)  # in place, as K2's chunks
    assert torch.equal(out, prev + lin)
    out = prev.clone()
    _common.gemm_s8(a, w, bias=bias, acc_in=out, residual=res, out=out, **kw)
    assert torch.equal(out, ((prev + lin) + bias) + res.float())


def test_gemm_s8_epilogues(dev):
    """Each epilogue against its plain formula on the same exact sums."""
    rng = np.random.RandomState(9)
    M, N, K = 203, 264, 128
    a, w = _int8(rng, dev, M, K), _int8(rng, dev, N, K)
    rs, cs = _t(rng.rand(M) * 0.01, dev), _t(rng.rand(N) * 0.01, dev)
    bias, prev = _t(rng.randn(N) * 0.1, dev), _t(rng.randn(M, N), dev)
    res = _t(rng.randn(M, N), dev, torch.bfloat16)
    acc = int_mm(a, w)
    bf = torch.bfloat16
    got = _common.gemm_s8(a, w, mode=_common.GEMM_QKV, row_scale=rs, col_scale=cs, bias=bias)
    want = acc.to(bf) * (rs[:, None] * cs).to(bf) + bias.to(bf)
    _close_bf16(got, want)
    lin = acc.float() * rs[:, None] * cs
    got = _common.gemm_s8(a, w, mode=_common.GEMM_LINEAR, row_scale=rs, col_scale=cs,
                          bias=bias, gelu=True, out_f32=True)
    torch.testing.assert_close(got, _common.gelu_tanh(lin + bias), atol=1e-5, rtol=1e-5)
    got = _common.gemm_s8(a, w, mode=_common.GEMM_LINEAR, row_scale=rs, col_scale=cs,
                          bias=bias, acc_in=prev, residual=res)
    _close_bf16(got, ((prev + lin) + bias + res.float()).to(bf))
    out = prev.clone()
    _common.gemm_s8(a, w, mode=_common.GEMM_LINEAR, row_scale=rs, col_scale=cs,
                    acc_in=out, out_f32=True, out=out)  # in place, as K2's chunks
    torch.testing.assert_close(out, prev + lin, atol=1e-5, rtol=1e-5)


def test_quant_rows_kernel_rounds_ties_half_to_even(dev):
    x = torch.tensor([[127, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5] * 4], device=dev)
    q, s = _common.quant_rows(x)
    assert float(s[0]) == 1.0
    assert q[0].tolist() == torch.round(x[0]).to(torch.int8).tolist()
    assert q[0, :8].tolist() == [127, 2, -2, 4, -4, 0, 0, 2]


@pytest.mark.parametrize("ln", [False, True], ids=["plain", "ln"])
def test_quant_rows_kernel(dev, ln):
    """Codes and scales against quantize_rows of the same f32 values; with
    the LN prologue the two sum the statistics in other orders, so a code
    at a .5 tie may land one step apart (share printed, bounded)."""
    rng = np.random.RandomState(10)
    x = _t(rng.randn(333, 1024) * 2 + 0.5, dev, torch.bfloat16)
    norm = _ln(rng, dev, 1024) if ln else None
    q, s = _common.quant_rows(x, ln=norm)
    xf = _common.layer_norm_f32(x, norm) if ln else x.float()
    want_q, want_s = quantize_rows(xf)
    torch.testing.assert_close(s, want_s[:, 0], atol=0, rtol=1e-6)
    diff = (q.int() - want_q.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    if not ln:
        assert torch.equal(q, want_q) and torch.equal(s, want_s[:, 0])


def test_quant_rows_kernel_column_range(dev):
    rng = np.random.RandomState(11)
    h = _t(rng.randn(77, 4096), dev)
    q = torch.zeros(77, 4096, dtype=torch.int8, device=dev)
    scale = torch.empty(2, 77, device=dev)
    for i, (lo, hi) in enumerate(((0, 2048), (2048, 4096))):
        _common.quant_rows(h, lo=lo, hi=hi, q=q, scale=scale[i])
        want_q, want_s = quantize_rows(h[:, lo:hi])
        assert torch.equal(q[:, lo:hi], want_q) and torch.equal(scale[i], want_s[:, 0])


def test_quant_rows_bf16_kernel(dev):
    """K1's bf16 context quantization equals its plain version exactly."""
    rng = np.random.RandomState(12)
    x = _t(rng.randn(500, 1024) * np.exp(rng.randn(500, 1)), dev, torch.bfloat16)
    x[3] = 0  # the bf16(1e-6) floor
    q, s = _common.quant_rows_bf16(x)
    want_q, want_s = quantize_context_reference(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s[:, 0])


def test_conv0_ln_gelu_tanh_kernel(dev):
    rng = np.random.RandomState(13)
    wavs = _t(rng.randn(3, 16007), dev, torch.bfloat16)
    weight = _t(rng.randn(512, 1, 10) / np.sqrt(10), dev, torch.bfloat16)
    g, b = _ln(rng, dev, 512)
    got = conv0_ln_gelu(wavs, weight, g, b, gelu_mode="tanh")
    _close_bf16(got, conv0_ln_gelu_reference(wavs, weight, g, b, gelu_mode="tanh"))


def _qpair(rng, dev, C, N):
    w = _t(rng.randn(N, C) / np.sqrt(C), dev)
    return as_quantized_cols(w), _t(rng.randn(N) * 0.02, dev)


@BLOCK_FORMS
@pytest.mark.parametrize("T", [499, 64])
def test_int8_attention_block_kernel(dev, postnorm, C, H, T):
    rng = np.random.RandomState(14)
    B = 4
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    wq, bq = _qpair(rng, dev, C, 3 * C)
    wo, bo = _qpair(rng, dev, C, C)
    ln = _ln(rng, dev, C)
    kv = torch.tensor([T, T, (T * 5) // 8, 1], dtype=torch.int32, device=dev)
    before = fused_attention_block.launches
    got = fused_attention_block(x, wq, bq, ln, wo, bo, kv, H, postnorm=postnorm)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    _close_bf16(got, fused_attention_block_reference(x, wq, bq, ln, wo, bo, kv, H,
                                                     postnorm=postnorm))


@pytest.mark.parametrize("ln,residual,postnorm,C,F,B,T", [
    (True, True, False, 256, 1024, 2, 123), (False, False, False, 256, 1024, 2, 123),
    (True, False, False, 256, 1024, 2, 123), (False, True, False, 256, 1024, 2, 123),
    (True, True, True, 256, 1024, 2, 123), (True, True, False, 128, 4096, 2, 123),
    (True, True, False, 128, 3200, 2, 123), (False, False, False, 128, 3200, 7, 61),
    (True, True, False, 256, 4096, 7, 61), (True, True, True, 768, 3072, 2, 123),
    (False, False, False, 768, 3072, 2, 123)])
def test_int8_ffn_kernel(dev, ln, residual, postnorm, C, F, B, T):
    """K2 against its plain version; F = 3,200 runs a full 2,048-wide chunk
    and a 1,152-wide one (the fc2 chunks are column ranges of h8 and w2);
    at the Base models' C 768, F 3,072 postnorm (HuBERT-Base) and bare
    (WavLM-Base)."""
    rng = np.random.RandomState(15)
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    w1, b1 = _qpair(rng, dev, C, F)
    w2, b2 = _qpair(rng, dev, F, C)
    norm = _ln(rng, dev, C) if ln else None
    before = fused_int8_ffn.launches
    got = fused_int8_ffn(x, w1, b1, w2, b2, ln=norm, residual=residual, postnorm=postnorm)
    torch.cuda.synchronize()
    assert fused_int8_ffn.launches == before + 1
    _close_bf16(got, fused_int8_ffn_reference(x, w1, b1, w2, b2, ln=norm, residual=residual,
                                              postnorm=postnorm))


def test_tiny_trunk_int8_kernels_match_cpu(dev, monkeypatch):
    """The int8 routing on the card: K3-tanh + K1 + K2 launches."""
    _trunk_on_card_vs_cpu(dev, monkeypatch, True, [1, 2, 2, 0, 0, 0, 0, 0, 0, 0])


def test_int8_on_the_card_serves_k6_beyond_512_frames(dev, monkeypatch):
    """549 frames at the real thresholds: K6 in place of K1."""
    wavs = torch.from_numpy(np.random.RandomState(16).randn(2, 11000).astype(np.float32))
    lens = torch.tensor([11000, 7000])
    _trunk_on_card_vs_cpu(dev, monkeypatch, True, [1, 0, 2, 0, 0, 2, 0, 0, 0, 0], wavs, lens)


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("max_kernel_t", [2048, 128], ids=["k6k7", "k8"])
def test_tiny_trunk_long_routes_match_cpu(dev, monkeypatch, quantize, max_kernel_t):
    """T' = 320 frames with MAX_BLOCK_T = 64 (and MAX_KERNEL_T = 128 for
    K8): int8 through K6 or K8 and K2, bf16 through K7 or K8 and K5."""
    monkeypatch.setattr(fa, "MAX_BLOCK_T", 64)
    monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    k6_k7_k8 = {(True, 2048): [2, 0, 0], (True, 128): [0, 0, 2],
                (False, 2048): [0, 2, 0], (False, 128): [0, 0, 2]}[quantize, max_kernel_t]
    k2, k5 = (2, 0) if quantize else (0, 2)
    _trunk_on_card_vs_cpu(dev, monkeypatch, quantize, [1, 0, k2, 0, k5] + k6_k7_k8 + [0, 0])


LONG_T = [513, 1499, 2048, 2049, 2999]
EDGE_T = [65, 127]  # key tiles of 64 with a ragged last tile, beside the long ones


def _long_kv(T, dev):
    return torch.tensor([T, (T * 5) // 8, 1], dtype=torch.int32, device=dev)


def _on_cpu(*args):
    return [a.cpu() if isinstance(a, torch.Tensor) else tuple(t.cpu() for t in a)
            for a in args]


ATTN_T = [1, 63, 64, 65, 127, 499, 513, 1499, 2048]


@pytest.mark.parametrize("out_f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("T,B,H", [(T, B, 2) for T in ATTN_T for B in (1, 3, 7)]
                         + [(499, 32, 16)])
def test_packed_attention_kernel(dev, T, B, H, out_f32):
    """`_attention`, the packed instantiation of gated_attention.cu (K1, K4,
    K6 and K7's attention step), against `attention_reference` on the card,
    with kv_lens on the tile edges (`_edge_kv`), bf16 and f32 out."""
    qkv = _t(np.random.RandomState(23).randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    kv = _edge_kv(B, T, dev)
    got = fa._attention(qkv, kv, H, out_f32=out_f32)
    want = attention_reference(qkv, kv, H, out_dtype=torch.float32 if out_f32 else None)
    assert got.dtype == want.dtype
    _close_bf16(got, want.view(B * T, H * 64))


@pytest.mark.parametrize("out_f32", [False, True], ids=["bf16", "f32"])
def test_packed_attention_kernel_row_without_keys(dev, out_f32):
    """A row with kv_len = 0 runs every key of T, each masked by the
    additive -1e9, as the plain version does: a near-uniform row."""
    B, T, H = 3, 130, 2
    qkv = _t(np.random.RandomState(24).randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    kv = torch.tensor([T, 0, 65], dtype=torch.int32, device=dev)
    got = fa._attention(qkv, kv, H, out_f32=out_f32)
    want = attention_reference(qkv, kv, H, out_dtype=torch.float32 if out_f32 else None)
    _close_bf16(got, want.view(B * T, H * 64))
    mean_v = qkv[1, :, 2 * H * 64:].float().mean(0)  # the uniform row's output
    _close_bf16(got.view(B, T, -1)[1], mean_v.expand(T, -1))


@pytest.mark.parametrize("T", EDGE_T + LONG_T)
def test_k7_kernel(dev, T):
    """K7 against the plain versions of its route on the same inputs (the
    wrapper on CPU copies): the packed instantiation of gated_attention.cu
    up to MAX_KERNEL_T, K8 beyond; kv_lens on the tile edges."""
    rng = np.random.RandomState(17)
    qkv = _t(rng.randn(7, T, 3 * 128), dev, torch.bfloat16)
    kv = _edge_kv(7, T, dev)
    before = fused_qkv_attention.launches, online_flash_attention.launches
    got = fused_qkv_attention(qkv, kv, 2)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (fused_qkv_attention.launches - before[0],
            online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    _close_bf16(got, fused_qkv_attention(*_on_cpu(qkv, kv), 2))


@pytest.mark.parametrize("T", EDGE_T + LONG_T)
def test_k6_kernel(dev, T):
    """K6 (f32 context, f32 row-quant, int8 out-proj + bias + residual)
    against the plain versions of its route; beyond MAX_KERNEL_T it is
    K7 -> K8 and residual + int8_matmul. kv_lens on the tile edges."""
    rng = np.random.RandomState(18)
    qkv = _t(rng.randn(7, T, 3 * 128), dev, torch.bfloat16)
    x = _t(rng.randn(7, T, 128) * 0.5, dev, torch.bfloat16)
    wo, bo = _qpair(rng, dev, 128, 128)
    kv = _edge_kv(7, T, dev)
    before = fused_qkv_attention_outproj.launches, online_flash_attention.launches
    got = fused_qkv_attention_outproj(qkv, x, wo, bo, kv, 2)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (fused_qkv_attention_outproj.launches - before[0],
            online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    _close_bf16(got, fused_qkv_attention_outproj(*_on_cpu(qkv, x, wo, bo, kv), 2))


@pytest.mark.parametrize("T", [65, 499, 1499, 2049])
def test_k6_kernel_on_raw_x_qkv(dev, T):
    """K6 at the Base models' width (C 768, H 12) on the QKV of HuBERT-Base's
    post-LN split route: int8_matmul of the raw unit-scale residual x, the
    residual x itself; against the plain versions of its route (K8 beyond
    MAX_KERNEL_T)."""
    from s3prl_tpu_torch.ops.quant import int8_matmul

    rng = np.random.RandomState(26)
    B, C, H = 3, 768, 12
    x = _t(rng.randn(B, T, C), dev, torch.bfloat16)
    wq, bq = _qpair(rng, dev, C, 3 * C)
    qkv = int8_matmul(x, wq, bq, out_dtype=torch.bfloat16)
    wo, bo = _qpair(rng, dev, C, C)
    kv = _long_kv(T, dev)[:B]
    before = fused_qkv_attention_outproj.launches, online_flash_attention.launches
    got = fused_qkv_attention_outproj(qkv, x, wo, bo, kv, H)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (fused_qkv_attention_outproj.launches - before[0],
            online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    _close_bf16(got, fused_qkv_attention_outproj(*_on_cpu(qkv, x, wo, bo, kv), H))


@pytest.mark.parametrize("T", EDGE_T + LONG_T)
def test_k8_kernel(dev, T):
    """K8 alone against its plain version on the card; q pre-scaled,
    kv_lens on the tile edges."""
    rng = np.random.RandomState(19)
    q, k, v = (_t(rng.randn(7, 2, T, 64) * sc, dev, torch.bfloat16) for sc in (0.125, 1, 1))
    kv = _edge_kv(7, T, dev)
    before = online_flash_attention.launches
    got = online_flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert online_flash_attention.launches == before + 1
    _close_bf16(got, online_flash_attention_reference(q, k, v, kv))


def test_long_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    kv = torch.tensor([600], dtype=torch.int32, device=dev)
    for T in (600, 2100):  # K7's own kernel, and its hand-over to K8
        qkv = torch.zeros(1, T, 384, dtype=torch.bfloat16, device=dev)
        with pytest.raises(NotImplementedError, match="K7"):  # f32 qkv: not ported
            fused_qkv_attention(qkv.float(), kv, 2)
        with pytest.raises(ValueError):  # head dim 32
            fused_qkv_attention(qkv, kv, 4)
        with pytest.raises(TypeError):  # int64 kv_lens
            fused_qkv_attention(qkv, kv.long(), 2)
        with pytest.raises(ValueError):  # kv_lens on the CPU
            fused_qkv_attention(qkv, kv.cpu(), 2)
        (wq, ws), bo = _qpair(np.random.RandomState(20), dev, 128, 128)
        if T <= fa.MAX_KERNEL_T:  # beyond it K6 is K7 + stock ops, which take an f32 residual
            with pytest.raises(TypeError):  # f32 residual
                fused_qkv_attention_outproj(qkv, torch.zeros(1, T, 128, device=dev), (wq, ws),
                                            bo, kv, 2)
        with pytest.raises(ValueError):  # CPU weights
            fused_qkv_attention_outproj(qkv, qkv[..., :128].contiguous(), (wq.cpu(), ws.cpu()),
                                        bo.cpu(), kv, 2)
    q = torch.zeros(1, 2, 2100, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # head dim 32
        online_flash_attention(q, q, q, kv)
    q = torch.zeros(1, 2, 2100, 64, device=dev)
    with pytest.raises(TypeError):  # f32
        online_flash_attention(q, q, q, kv)


GATED_T = [65, 127, 499, 1499, 2048, 2049, 2999]
KV_EDGES = (1, 63, 64, 65, 127, 128)  # kv_lens on and beside the 64-key tile edges


def _edge_kv(B, T, dev):
    """kv_lens [T, 1, 63, 64, 65, 127, 128, T, 1, ...] for B utterances (the
    edges past T left out)."""
    vals = [T] + [n for n in KV_EDGES if n < T]
    return torch.tensor([vals[i % len(vals)] for i in range(B)], dtype=torch.int32, device=dev)


def _bias_form(pos_bias, form):
    """pos_bias [H, T, T] as the kernel may get it: "f32" contiguous (rows T
    elements apart: 4-byte copies at odd T), or a view [:, :, :T] of an
    [H, T, ld] buffer whose padding holds NaN: "f32-padded" and
    "bf16-padded" (ld = T rounded up to 8, the bf16 model's buffer),
    "f32-pad4" (ld = T rounded up to 4, the ``wavlm_fuse`` model's),
    "bf16-wide" (ld 24 more)."""
    if form == "f32":
        return pos_bias.contiguous()
    H, T, _ = pos_bias.shape
    ld = -(-T // (4 if form == "f32-pad4" else 8)) * (4 if form == "f32-pad4" else 8)
    ld += 24 if form == "bf16-wide" else 0
    dtype = torch.float32 if form.startswith("f32") else torch.bfloat16
    buf = torch.full((H, T, ld), float("nan"), dtype=dtype, device=pos_bias.device)
    buf[:, :, :T] = pos_bias
    return buf[:, :, :T]


def _gated_inputs(rng, dev, B, H, T, form="f32", kv=None):
    """K9/K10 inputs: unit-scale q (pre-scaled by 1/8), k, v in bf16; a real
    pos_bias from WavLM's bucket table and a random [320, H] table in
    `form` (`_bias_form`); gates in (1, 3); kv_lens [T, 5T/8, 1] unless
    given."""
    from s3prl_tpu_torch.models.wavlm import bucket_table

    q, k, v = (_t(rng.randn(B, H, T, 64) * sc, dev, torch.bfloat16) for sc in (0.125, 1, 1))
    table = _t(rng.randn(320, H) * 0.5, dev)
    pos_bias = _bias_form(table.t()[:, bucket_table(T, 320, 800, torch.device(dev))], form)
    gate = _t(1 + 2 * rng.rand(B, H, T), dev)
    return q, k, v, pos_bias, gate, _long_kv(T, dev)[:B] if kv is None else kv


@pytest.mark.parametrize("form", ["f32", "f32-padded", "bf16-padded", "bf16-wide"])
@pytest.mark.parametrize("T,B,H", [(T, B, 2) for T in GATED_T for B in (1, 3, 7)]
                         + [(499, 32, 16), (499, 32, 12)])
def test_gated_kernels(dev, T, B, H, form):
    """K9 up to MAX_KERNEL_T, K10 beyond it (through K9's hand-over), each
    against the plain version of its route on the card, with kv_lens on
    the tile edges (`_edge_kv`) and the bias in each form the kernel takes;
    K10 called directly at every T against its own plain version."""
    q, k, v, pos_bias, gate, kv = _gated_inputs(np.random.RandomState(21), dev, B, H, T, form,
                                                _edge_kv(B, T, dev))
    before = gated_bias_attention.launches, gated_online_flash_attention.launches
    got = gated_bias_attention(q, k, v, pos_bias, gate, kv)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (gated_bias_attention.launches - before[0],
            gated_online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    plain = gated_online_flash_attention_reference if online else gated_bias_attention_reference
    _close_bf16(got, plain(q, k, v, pos_bias, gate, kv))
    got = gated_online_flash_attention(q, k, v, pos_bias, gate, kv)  # K10 called directly
    _close_bf16(got, gated_online_flash_attention_reference(q, k, v, pos_bias, gate, kv))


def test_gated_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, k, v, pos_bias, gate, kv = _gated_inputs(np.random.RandomState(22), dev, 2, 2, 130)
    with pytest.raises(TypeError):  # f32 q, k, v
        gated_bias_attention(q.float(), k.float(), v.float(), pos_bias, gate, kv)
    with pytest.raises(ValueError):  # a bf16 pos_bias whose rows are 130 elements apart
        gated_bias_attention(q, k, v, pos_bias.bfloat16(), gate, kv)
    with pytest.raises(TypeError):  # an f16 pos_bias
        gated_bias_attention(q, k, v, pos_bias.half(), gate, kv)
    with pytest.raises(ValueError):  # head dim 32
        gated_bias_attention(*(t[..., :32].contiguous() for t in (q, k, v)), pos_bias, gate, kv)
    with pytest.raises(ValueError):  # a gate per utterance, not per query
        gated_online_flash_attention(q, k, v, pos_bias, gate[..., 0].contiguous(), kv)
    with pytest.raises(ValueError):  # CPU kv_lens beside CUDA tensors
        gated_bias_attention(q, k, v, pos_bias, gate, kv.cpu())
    gate.requires_grad_(True)
    for fn in (gated_bias_attention, gated_online_flash_attention):
        with pytest.raises(RuntimeError, match="forward-only"):  # the kernel has no backward
            fn(q, k, v, pos_bias, gate, kv)
        with torch.no_grad():
            fn(q, k, v, pos_bias, gate, kv)


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("max_kernel_t", [2048, 128], ids=["k9", "k10"])
def test_tiny_wavlm_matches_cpu(dev, monkeypatch, quantize, max_kernel_t):
    """The tiny WavLM on the card (T' = 320 frames): conv0 (erf), K9 (or
    K10 with MAX_KERNEL_T = 128) and, int8 only, K2; nothing else."""
    monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    k9_k10 = [2, 0] if max_kernel_t == 2048 else [0, 2]
    _trunk_on_card_vs_cpu(dev, monkeypatch, quantize,
                          [1, 0, 2 if quantize else 0, 0, 0, 0, 0, 0] + k9_k10,
                          pair=_tiny_wavlm_pair(dev, quantize))


@pytest.mark.parametrize("H", [2, 12])
@pytest.mark.parametrize("T", [499, 1499, 2048, 2049])
def test_k11_kernel(dev, T, H):
    """K11 (gated attention with an f32 context, f32 row-quant, int8
    out-proj + bias + residual) against the plain versions of its route on
    CPU copies of the inputs; beyond MAX_KERNEL_T it is K9 -> K10 and
    residual + int8_matmul, and its launch counts for K10. H 12 is
    WavLM-Base's width."""
    from s3prl_tpu_torch.models.wavlm import bucket_table

    rng = np.random.RandomState(23)
    B = 3
    qkv = _t(rng.randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    x = _t(rng.randn(B, T, H * 64) * 0.5, dev, torch.bfloat16)
    pos_bias = _t(rng.randn(320, H) * 0.5, dev).t()[:, bucket_table(T, 320, 800, dev)].contiguous()
    gate = _t(1 + 2 * rng.rand(B, H, T), dev)
    wo, bo = _qpair(rng, dev, H * 64, H * 64)
    kv = _long_kv(T, dev)
    before = fa.gated_bias_attention_outproj.launches, gated_online_flash_attention.launches
    got = fa.gated_bias_attention_outproj(qkv, x, pos_bias, gate, wo, bo, kv, H)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (fa.gated_bias_attention_outproj.launches - before[0],
            gated_online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, H * 64)
    _close_bf16(got, fa.gated_bias_attention_outproj(*_on_cpu(qkv, x, pos_bias, gate, wo, bo,
                                                              kv), H))


@pytest.mark.parametrize("form", ["f32", "f32-pad4", "f32-padded"])
@pytest.mark.parametrize("T,B,H", [(T, B, 2) for T in (65, 127, 499) for B in (1, 3, 7)]
                         + [(499, 4, 16)])
def test_gated_packed_attention_kernel(dev, T, B, H, form):
    """K11's attention: `_attention` with a bias, the gated packed f32-out
    instantiation of gated_attention.cu, against `attention_reference(...,
    bias=)` on the card, with kv_lens on the 64-key tile edges (`_edge_kv`)
    and the f32 bias unpadded (rows T apart: 4-byte copies at odd T) or
    padded (rows a multiple of 4 or 8 floats apart: 16-byte copies)."""
    from s3prl_tpu_torch.models.wavlm import bucket_table

    rng = np.random.RandomState(27)
    qkv = _t(rng.randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    table = _t(rng.randn(320, H) * 0.5, dev)
    pos_bias = _bias_form(table.t()[:, bucket_table(T, 320, 800, torch.device(dev))], form)
    gate = _t(1 + 2 * rng.rand(B, H, T), dev)
    kv = _edge_kv(B, T, dev)
    got = fa._attention(qkv, kv, H, out_f32=True, bias=(pos_bias, gate))
    torch.cuda.synchronize()
    want = attention_reference(qkv, kv, H, out_dtype=torch.float32, bias=(pos_bias, gate))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B * T, H * 64)
    _close_bf16(got, want.view(B * T, H * 64))


@pytest.mark.parametrize("ln,residual", [(True, False), (False, True), (False, False),
                                         (True, True)], ids=["ln", "res", "plain", "ln-res"])
def test_k12_kernel(dev, ln, residual):
    """K12 against its plain version on the card: 246 rows, C = 256, N = 3C
    with the LN (the QKV projection), N = C otherwise."""
    rng = np.random.RandomState(24)
    B, T, C = 2, 123, 256
    N = 3 * C if ln else C
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    w, b = _qpair(rng, dev, C, N)
    norm = _ln(rng, dev, C) if ln else None
    res = _t(rng.randn(B, T, N) * 0.5, dev, torch.bfloat16) if residual else None
    before = fused_int8_linear.launches
    got = fused_int8_linear(x, w, b, ln=norm, residual=res)
    torch.cuda.synchronize()
    assert fused_int8_linear.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, N)
    _close_bf16(got, fused_int8_linear_reference(x, w, b, ln=norm, residual=res))


# csrc/int8_panel.cu's sets: (row rule, LN, epilogue, residual, f32 out) of
# K1's QKV (pre-LN, postnorm) and out-proj (bf16 out, postnorm's f32 sum)
# and K12's two main-path sets
PANEL_SETS = {"k1-qkv-ln": ("f32", True, "qkv", False, False),
              "k1-qkv-postnorm": ("f32", False, "qkv", False, False),
              "k1-outproj": ("ctx", False, "linear", True, False),
              "k1-outproj-f32": ("ctx", False, "linear", True, True),
              "k12-ln": ("f32", True, "linear", False, False),
              "k12-res": ("f32", False, "linear", True, False)}


@pytest.mark.parametrize("N", [8, 264, 1024, 3072])
@pytest.mark.parametrize("M", [1, 127, 129, 32 * 499])
@pytest.mark.parametrize("C", [768, 1024])
def test_int8_panel_kernel(dev, C, M, N):
    """The panel kernel alone, in every set of PANEL_SETS, on and beside its
    128-row panel and 128-column tiles: in the test mode its codes and
    scales equal quantize_context_reference's or quantize_rows' bit for bit
    (with the LN, of the LN recomputed in f32 from the kernel's statistics,
    which agree with torch's at rtol 1e-5: at a .5 tie torch's LN can put a
    code one step apart, and K1's triple-rounded QKV one bf16 step past the
    rule; `test_k1_k12_launches_by_row_width` and the wrapper tests hold
    that against the plain versions); the output against the plain
    projection of those codes (bf16 under the kernels' rule; f32 at atol
    1e-4)."""
    rng = np.random.RandomState(C + M + N)
    x = _t(rng.randn(M, C) * 0.5, dev, torch.bfloat16)
    (w8, ws), b = _qpair(rng, dev, C, N)
    norm = _ln(rng, dev, C)
    res = _t(rng.randn(M, N) * 0.5, dev, torch.bfloat16)
    mean = x.float().mean(-1)
    rstd = 1.0 / torch.sqrt(((x.float() - mean[:, None]) ** 2).mean(-1) + _common.LN_EPS)
    bf = torch.bfloat16
    for rule, ln, epi, with_res, out_f32 in PANEL_SETS.values():
        got, q, s, stats = _common.int8_panel(
            x, w8, ws, b, ln=norm if ln else None,
            rule=_common.RULE_CTX if rule == "ctx" else _common.RULE_F32,
            mode=_common.GEMM_QKV if epi == "qkv" else _common.GEMM_LINEAR,
            residual=res if with_res else None, out_f32=out_f32, codes=True)
        torch.cuda.synchronize()
        if rule == "ctx":
            xq, xs = quantize_context_reference(x)
        elif ln:
            torch.testing.assert_close(stats[:, 0], mean, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(stats[:, 1], rstd, rtol=1e-5, atol=0)
            xq, xs = quantize_rows((x.float() - stats[:, :1]) * stats[:, 1:]
                                   * norm[0] + norm[1])
        else:
            xq, xs = quantize_rows(x)
        assert torch.equal(q, xq) and torch.equal(s, xs[:, 0])
        if epi == "qkv":
            want = int_mm(xq, w8).to(bf) * (xs * ws).to(bf) + b.to(bf)
        else:
            want = int_mm(xq, w8).float() * xs * ws + b + (res.float() if with_res else 0)
        assert got.shape == (M, N) and got.dtype == (torch.float32 if out_f32 else bf)
        if out_f32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            _close_bf16(got, want.to(bf))


def _launched(monkeypatch, fn):
    """The C entries fn() launches, in order (a spy on `launch` in the
    modules that launch K1's, K6's, K12's and K13b's kernels)."""
    names = []

    def spy(name, *args):
        names.append(name)
        return _build.launch(name, *args)

    monkeypatch.setattr(_common, "launch", spy)
    monkeypatch.setattr(fa, "launch", spy)
    monkeypatch.setattr(cf, "launch", spy)
    fn()
    torch.cuda.synchronize()
    monkeypatch.undo()
    return names


@pytest.mark.parametrize("C", [1024, 1280])
def test_k1_k12_launches_by_row_width(dev, monkeypatch, C):
    """At C <= PANEL_MAX_C K12 is one panel launch and K1 three (panel QKV,
    the attention, panel out-proj; + the LN with postnorm); wider rows take
    quant_rows.cu + gemm_s8.cu for each projection. Both routes against the
    plain versions (C = 1,280: 20 heads of 64, 2 x 77 rows)."""
    rng = np.random.RandomState(26)
    B, T, H = 2, 77, C // 64
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    wq, bq = _qpair(rng, dev, C, 3 * C)
    wo, bo = _qpair(rng, dev, C, C)
    norm = _ln(rng, dev, C)
    res = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    kv = torch.tensor([T, 40], dtype=torch.int32, device=dev)
    panel, attn = "s3_int8_panel", "s3_qkv_attention"
    wide = C > _common.PANEL_MAX_C
    qkv_entries = ["s3_quant_rows", "s3_gemm_s8"] if wide else [panel]
    out_entries = ["s3_quant_rows_bf16", "s3_gemm_s8"] if wide else [panel]
    got = {}
    assert _launched(monkeypatch, lambda: got.setdefault(
        "ln", fused_int8_linear(x, wq, bq, ln=norm))) == qkv_entries
    assert _launched(monkeypatch, lambda: got.setdefault(
        "res", fused_int8_linear(x, wo, bo, residual=res))) == qkv_entries
    _close_bf16(got["ln"], fused_int8_linear_reference(x, wq, bq, ln=norm))
    _close_bf16(got["res"], fused_int8_linear_reference(x, wo, bo, residual=res))
    for postnorm in (False, True):
        y = {}
        assert _launched(monkeypatch, lambda: y.setdefault("y", fused_attention_block(
            x, wq, bq, norm, wo, bo, kv, H, postnorm=postnorm))) == (
            qkv_entries + [attn] + out_entries + ["s3_layernorm"] * postnorm)
        _close_bf16(y["y"], fused_attention_block_reference(x, wq, bq, norm, wo, bo, kv, H,
                                                             postnorm=postnorm))


def test_int8_panel_refuses_what_it_does_not_take(dev):
    rng = np.random.RandomState(27)
    x = _t(rng.randn(10, 1280) * 0.5, dev, torch.bfloat16)
    (w8, ws), b = _qpair(rng, dev, 1280, 64)
    with pytest.raises(ValueError):  # wider than the panel
        _common.int8_panel(x, w8, ws, b)
    (w8, ws), b = _qpair(rng, dev, 1024, 64)
    with pytest.raises(TypeError):  # f16 x
        _common.int8_panel(x[:, :1024].half().contiguous(), w8, ws, b)
    with pytest.raises(ValueError):  # the LN takes the f32 rule
        _common.int8_panel(x[:, :1024].contiguous(), w8, ws, b, ln=_ln(rng, dev, 1024),
                           rule=_common.RULE_CTX)
    x32 = x[:, :1024].float().contiguous()
    for kwargs in (dict(ln=_ln(rng, dev, 1024)), dict(rule=_common.RULE_CTX),
                   dict(mode=_common.GEMM_QKV)):
        with pytest.raises(ValueError):  # f32 rows: the f32 rule, no LN, GEMM_LINEAR
            _common.int8_panel(x32, w8, ws, b, **kwargs)


def test_fused_projection_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.RandomState(25)
    B, T, H = 2, 130, 2
    qkv = _t(rng.randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    x = _t(rng.randn(B, T, H * 64), dev, torch.bfloat16)
    pos_bias = _t(rng.randn(H, T, T), dev)
    gate = _t(1 + 2 * rng.rand(B, H, T), dev)
    wo, bo = _qpair(rng, dev, H * 64, H * 64)
    kv = torch.tensor([T, 70], dtype=torch.int32, device=dev)
    k11 = fa.gated_bias_attention_outproj
    with pytest.raises(TypeError):  # f32 qkv
        k11(qkv.float(), x, pos_bias, gate, wo, bo, kv, H)
    with pytest.raises(TypeError):  # f32 residual
        k11(qkv, x.float(), pos_bias, gate, wo, bo, kv, H)
    with pytest.raises(TypeError):  # bf16 pos_bias
        k11(qkv, x, pos_bias.bfloat16(), gate, wo, bo, kv, H)
    with pytest.raises(ValueError):  # CPU kv_lens beside CUDA tensors
        k11(qkv, x, pos_bias, gate, wo, bo, kv.cpu(), H)
    gate.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):  # the kernel has no backward
        k11(qkv, x, pos_bias, gate, wo, bo, kv, H)
    with torch.no_grad():
        k11(qkv, x, pos_bias, gate, wo, bo, kv, H)
    w, b = _qpair(rng, dev, H * 64, 3 * H * 64)
    with pytest.raises(TypeError):  # f32 x
        fused_int8_linear(x.float(), w, b)
    with pytest.raises(TypeError):  # f32 residual
        fused_int8_linear(x, wo, bo, residual=x.float())
    with pytest.raises(ValueError):  # CPU weights beside a CUDA input
        fused_int8_linear(x, (w[0].cpu(), w[1].cpu()), b.cpu())


@pytest.mark.parametrize("route", ["full_fuse-k7", "full_fuse-k8", "qkv_fuse"])
def test_tiny_trunk_fused_projections_match_cpu(dev, monkeypatch, route):
    """HuBERT's int8 options on the card (T' = 320 frames): ``full_fuse`` at
    the real MAX_BLOCK_T (K12 twice a layer, K7 or, with MAX_KERNEL_T = 128,
    K8, and K2; no K1); ``qkv_fuse`` beyond MAX_BLOCK_T = 64 (K12, K6, K2)."""
    option = route.split("-")[0]
    if route == "full_fuse-k8":
        monkeypatch.setattr(fa, "MAX_KERNEL_T", 128)
    if option == "qkv_fuse":
        monkeypatch.setattr(fa, "MAX_BLOCK_T", 64)
    launches = {"full_fuse-k7": [1, 0, 2, 0, 0, 0, 2, 0, 0, 0, 0, 4],
                "full_fuse-k8": [1, 0, 2, 0, 0, 0, 0, 2, 0, 0, 0, 4],
                "qkv_fuse": [1, 0, 2, 0, 0, 2, 0, 0, 0, 0, 0, 2]}[route]
    _trunk_on_card_vs_cpu(dev, monkeypatch, True, launches,
                          pair=_tiny_trunk_pair(torch.bfloat16, True, dev, quantize=True,
                                                **{option: True}))


@pytest.mark.parametrize("max_kernel_t", [2048, 128], ids=["k11", "k10"])
def test_tiny_wavlm_fuse_matches_cpu(dev, monkeypatch, max_kernel_t):
    """``wavlm_fuse`` on the card (T' = 320 frames): conv0 (erf), K11 (or its
    hand-over to K10 with MAX_KERNEL_T = 128) and K2; no K9."""
    monkeypatch.setattr(fa, "MAX_KERNEL_T", max_kernel_t)
    k10_k11 = [0, 2] if max_kernel_t == 2048 else [2, 0]
    _trunk_on_card_vs_cpu(dev, monkeypatch, True, [1, 0, 2, 0, 0, 0, 0, 0, 0] + k10_k11,
                          pair=_tiny_wavlm_pair(dev, True, wavlm_fuse=True))


# -- the front end: K13a, K13b, K14, K15 and the options -------------------------------

# (T, k) of the mid layers' inputs at 10 s: layer 1 (k=3) and layer 5 (k=2);
# then T' = 1 (odd and even T) and no output row at all (T < k)
MID_SHAPES = [(31999, 3), (1999, 2), (4, 3), (3, 2), (2, 3), (1, 2)]


def _codes_close(got, want):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3, (
        int(d.max()), float((d > 0).float().mean()))


def _mid_weights(rng, dev, k):
    """An f32 nn.Conv1d weight [512, 512, k] and an LN pair."""
    return _t(rng.randn(512, 512, k) / np.sqrt(512 * k), dev), *_ln(rng, dev, 512)


@pytest.mark.parametrize("T,k", MID_SHAPES)
def test_k14_kernel(dev, T, k):
    """K14 on B=2 (rows never cross an utterance: T odd or even) against its
    plain version; the nn.Conv1d weight and the load-time GEMM weight give
    the same result; no output row, no launch."""
    rng = np.random.RandomState(26)
    x = _t(rng.randn(2, T, 512), dev, torch.bfloat16)
    w, g, b = _mid_weights(rng, dev, k)
    wg = conv_gemm_weight(w.bfloat16())
    t_out = max((T - k) // 2 + 1, 0)
    before = fused_conv_ln_gelu.launches
    got = fused_conv_ln_gelu(x, wg, g, b)
    torch.cuda.synchronize()
    assert fused_conv_ln_gelu.launches == before + (t_out > 0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, t_out, 512)
    if t_out:
        _close_bf16(got, fused_conv_ln_gelu_reference(x, wg, g, b))
        assert torch.equal(fused_conv_ln_gelu(x, w.bfloat16(), g, b), got)


@pytest.mark.parametrize("emit_q8", [True, False], ids=["q8", "bf16-out"])
@pytest.mark.parametrize("T,k", MID_SHAPES)
def test_k13b_kernel(dev, T, k, emit_q8):
    """K13b on int8 rows with f32 row scales against its plain version:
    codes and scales (`_codes_close`), or the last layer's bf16 rows."""
    rng = np.random.RandomState(27)
    xq = _int8(rng, dev, 2, T, 512)
    xs = _t(0.01 + 0.05 * rng.rand(2, T, 1), dev)
    w, g, b = _mid_weights(rng, dev, k)
    taps = quantize_conv_taps(w)
    t_out = max((T - k) // 2 + 1, 0)
    before = fused_int8_conv_ln_gelu.launches
    got_q, got_s = fused_int8_conv_ln_gelu(xq, xs, taps, g, b, emit_q8=emit_q8)
    torch.cuda.synchronize()
    assert fused_int8_conv_ln_gelu.launches == before + (t_out > 0)
    assert tuple(got_q.shape) == (2, t_out, 512)
    want_q, want_s = fused_int8_conv_ln_gelu_reference(xq, xs, taps, g, b, emit_q8=emit_q8)
    if emit_q8:
        assert got_q.dtype == torch.int8 and tuple(got_s.shape) == (2, t_out, 1)
        if t_out:
            _codes_close(got_q, want_q)
            torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)
    else:
        assert got_s is None and got_q.dtype == torch.bfloat16
        if t_out:
            _close_bf16(got_q, want_q)


# T' on and beside csrc/int8_conv.cu's 64-row tiles
INT8_CONV_T = [1, 63, 64, 65, 129]


@pytest.mark.parametrize("out", ["q8", "bf16", "f32"])
@pytest.mark.parametrize("t_out", INT8_CONV_T)
@pytest.mark.parametrize("k", [2, 3])
def test_int8_conv_kernel_bit_equal(dev, monkeypatch, k, t_out, out):
    """csrc/int8_conv.cu on B = 3 with random row scales (tap t's scale is
    row 2j + t's): in the test mode its f32 tap sum equals the plain
    version's bit for bit, its LN statistics agree with torch's at rtol
    1e-5, and given them its codes and scales (or bf16 or f32 rows) equal
    the plain LN -> erf GELU -> `quantize_rows` (or cast) bit for bit. The
    wrapper is one launch of the kernel and returns the same rows."""
    emit_q8 = out == "q8"
    out_dtype = torch.float32 if out == "f32" else torch.bfloat16
    rng = np.random.RandomState(40 + 2 * t_out + k)
    T = 2 * (t_out - 1) + k + t_out % 2  # odd and even T
    xq = _int8(rng, dev, 3, T, 512)
    xs = _t(0.01 + 0.05 * rng.rand(3, T, 1), dev)
    w, g, b = _mid_weights(rng, dev, k)
    wq, ws = quantize_conv_taps(w)
    got, scale, acc, stats = cf.int8_conv(xq, xs, wq, ws, g, b, emit_q8, out_dtype, sums=True)
    torch.cuda.synchronize()
    want = cf.fused_int8_conv_taps_reference(xq, xs, (wq, ws)).reshape(-1, 512)
    assert acc.shape == want.shape and torch.equal(acc, want)
    mean = want.mean(-1)
    rstd = 1.0 / torch.sqrt(((want - mean[:, None]) ** 2).mean(-1) + _common.LN_EPS)
    torch.testing.assert_close(stats[:, 0], mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stats[:, 1], rstd, rtol=1e-5, atol=0)
    y = _common.ln_gelu_from_stats(acc, stats, g, b)
    if emit_q8:
        q_ref, s_ref = quantize_rows(y)
        assert got.dtype == torch.int8 and tuple(scale.shape) == (3, t_out, 1)
        assert torch.equal(got.view(-1, 512), q_ref) and torch.equal(scale.view(-1, 1), s_ref)
    else:
        assert scale is None and got.dtype == out_dtype
        assert torch.equal(got.view(-1, 512), y.to(out_dtype))
    before = fused_int8_conv_ln_gelu.launches
    wrapped = {}
    assert _launched(monkeypatch, lambda: wrapped.setdefault("out", fused_int8_conv_ln_gelu(
        xq, xs, (wq, ws), g, b, emit_q8=emit_q8, out_dtype=out_dtype))) == ["s3_int8_conv"]
    assert fused_int8_conv_ln_gelu.launches == before + 1
    assert torch.equal(wrapped["out"][0], got)
    assert (wrapped["out"][1] is None) if scale is None else torch.equal(wrapped["out"][1],
                                                                         scale)


@pytest.mark.parametrize("N", [264, 1024])
@pytest.mark.parametrize("M", [1, 127, 129, 15968])
@pytest.mark.parametrize("C", [768, 1024])
def test_int8_panel_f32_rows(dev, C, M, N):
    """The panel kernel's f32-row instantiation (K6's context): in the test
    mode its codes and scales equal quant_rows.cu's and quantize_rows' on
    the same f32 rows bit for bit; the output, with and without the
    residual, against the plain f32 rule (`int8_panel_reference`: bf16
    under the kernels' rule, f32 at atol 1e-4)."""
    rng = np.random.RandomState(C + M + N + 1)
    x = _t(rng.randn(M, C) * 0.3, dev)
    (w8, ws), b = _qpair(rng, dev, C, N)
    res = _t(rng.randn(M, N) * 0.5, dev, torch.bfloat16)
    q8, s8 = _common.quant_rows(x)
    for residual, out_f32 in ((None, False), (res, False), (res, True)):
        got, q, s, stats = _common.int8_panel(x, w8, ws, b, residual=residual,
                                              out_f32=out_f32, codes=True)
        torch.cuda.synchronize()
        want, q_ref, s_ref = _common.int8_panel_reference(x, w8, ws, b, residual=residual,
                                                          out_f32=out_f32)
        assert stats is None
        assert torch.equal(q, q8) and torch.equal(s, s8)
        assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
        assert got.dtype == want.dtype and got.shape == (M, N)
        if out_f32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            _close_bf16(got, want)


@pytest.mark.parametrize("C", [1024, 1280])
def test_k6_launches_by_row_width(dev, monkeypatch, C):
    """At C <= PANEL_MAX_C K6 is two launches, the packed attention (f32
    context) and one panel launch on those f32 rows (no quant_rows.cu);
    wider rows take quant_rows.cu + gemm_s8.cu. Both against the plain
    version (C = 1,280: 20 heads of 64)."""
    rng = np.random.RandomState(41)
    B, T, H = 2, 577, C // 64
    qkv = _t(rng.randn(B, T, 3 * C), dev, torch.bfloat16)
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    wo, bo = _qpair(rng, dev, C, C)
    kv = torch.tensor([T, 300], dtype=torch.int32, device=dev)
    tail = ["s3_quant_rows", "s3_gemm_s8"] if C > _common.PANEL_MAX_C else ["s3_int8_panel"]
    got = {}
    assert _launched(monkeypatch, lambda: got.setdefault("y", fused_qkv_attention_outproj(
        qkv, x, wo, bo, kv, H))) == ["s3_qkv_attention"] + tail
    _close_bf16(got["y"], fused_qkv_attention_outproj(*_on_cpu(qkv, x, wo, bo, kv), H))


@pytest.mark.parametrize("n,dtype", [(160000, torch.bfloat16), (16007, torch.bfloat16),
                                     (16007, torch.float32), (10, torch.bfloat16)],
                         ids=["10s", "ragged-block", "f32", "one-frame"])
def test_k13a_kernel(dev, n, dtype):
    """K13a (conv0 + LN + erf GELU + row-quant) against its plain version:
    [2, 31999, 512] codes at 10 s, a ragged last frame block, one frame."""
    rng = np.random.RandomState(28)
    wavs = _t(rng.randn(2, n), dev, dtype)
    weight = _t(rng.randn(512, 1, 10) / np.sqrt(10), dev, dtype)
    g, b = _ln(rng, dev, 512)
    before = conv0_ln_gelu_q8.launches
    got_q, got_s = conv0_ln_gelu_q8(wavs, weight, g, b)
    torch.cuda.synchronize()
    assert conv0_ln_gelu_q8.launches == before + 1
    frames = (n - 10) // 5 + 1
    assert got_q.dtype == torch.int8 and tuple(got_q.shape) == (2, frames, 512)
    want_q, want_s = conv0_ln_gelu_q8_reference(wavs, weight, g, b)
    _codes_close(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)


# K3 and K13a (csrc/conv0_ln_gelu.cu) walk warp tiles of 8 frames: 10, 44, 45, 50 and
# 219 samples give 1, 7, 8, 9 and 43 frames (the last tile ragged); at 54 samples the
# last window runs past the wave (a ninth-frame tile whose frame 9 would need sample 54);
# 16,007 samples give 3,200 frames
CONV0_SAMPLES = [10, 44, 45, 50, 54, 219, 16007]
# "<wave dtype>-<GELU mode>" (K3) or "<wave dtype>-q8" (K13a)
CONV0_FORMS = ["bf16-erf", "bf16-tanh", "f32-erf", "f32-tanh", "bf16-q8", "f32-q8"]


def _conv0_inputs(seed, B, n, dtype, dev):
    rng = np.random.RandomState(seed)
    wavs = _t(rng.randn(B, n), dev, dtype)
    weight = _t(rng.randn(512, 1, 10) / np.sqrt(10), dev, dtype)
    return (wavs, weight, *_ln(rng, dev, 512))


def _conv0_run(args, form):
    """One launch of K3 or K13a in `form` (CONV0_FORMS)."""
    mode = form.split("-")[1]
    return conv0_ln_gelu_q8(*args) if mode == "q8" else conv0_ln_gelu(*args, gelu_mode=mode)


def _conv0_held(got, args, form):
    """K3 at atol 1e-4 (f32) or by `_close_bf16`; K13a's codes within one step in at
    most 0.1% of places and its scales at rtol 1e-5."""
    mode = form.split("-")[1]
    if mode == "q8":
        want_q, want_s = conv0_ln_gelu_q8_reference(*args)
        assert got[0].shape == want_q.shape and got[1].shape == want_s.shape
        _codes_close(got[0], want_q)
        torch.testing.assert_close(got[1], want_s, rtol=1e-5, atol=0)
        return
    want = conv0_ln_gelu_reference(*args, gelu_mode=mode)
    assert got.shape == want.shape
    if args[0].dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("n", CONV0_SAMPLES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("form", CONV0_FORMS)
def test_conv0_kernel_tile_edges(dev, form, B, n):
    """K3 (both GELU modes, bf16 and f32 waves) and K13a on the warp tile's edges
    against their plain versions."""
    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    args = _conv0_inputs(31, B, n, dtype, dev)
    got = _conv0_run(args, form)
    torch.cuda.synchronize()
    frames = (n - 10) // 5 + 1
    assert (got[0] if form.endswith("q8") else got).shape == (B, frames, 512)
    _conv0_held(got, args, form)


@pytest.mark.parametrize("form", CONV0_FORMS)
def test_conv0_kernel_walks_utterances_and_repeats(dev, form):
    """B = 33 x 16,007 samples (400 tiles an utterance: every warp of the persistent
    grid walks tiles of several utterances): two launches give the same bits, and
    both hold against the plain version."""
    dtype = torch.bfloat16 if form.startswith("bf16") else torch.float32
    args = _conv0_inputs(33, 33, 16007, dtype, dev)
    launches = (conv0_ln_gelu_q8 if form.endswith("q8") else conv0_ln_gelu).launches
    first, second = _conv0_run(args, form), _conv0_run(args, form)
    torch.cuda.synchronize()
    assert (conv0_ln_gelu_q8 if form.endswith("q8") else conv0_ln_gelu).launches == launches + 2
    for a, b in zip(*((first, second) if form.endswith("q8") else ((first,), (second,)))):
        assert torch.equal(a, b)
    _conv0_held(first, args, form)


@pytest.mark.parametrize("shape,dtype", [((2, 15999, 512), torch.bfloat16),
                                         ((2, 999, 512), torch.bfloat16),
                                         ((3, 1, 512), torch.bfloat16),
                                         ((2, 999, 512), torch.float32)],
                         ids=["layer1", "layer5", "one-row", "f32"])
@pytest.mark.parametrize("gelu_mode", ["erf", "tanh"])
def test_k15_kernel(dev, shape, dtype, gelu_mode):
    """K15 on the mid convs' output shapes at 10 s against its plain version:
    bf16 (`_close_bf16`) or f32 at atol 1e-5."""
    rng = np.random.RandomState(29)
    x = _t(rng.randn(*shape) * 2 + 0.3, dev, dtype)
    g, b = _ln(rng, dev, 512)
    before = ln_gelu.launches
    got = ln_gelu(x, g, b, gelu_mode)
    torch.cuda.synchronize()
    assert ln_gelu.launches == before + 1 and got.dtype == dtype and got.shape == x.shape
    want = ln_gelu_reference(x, g, b, gelu_mode)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        _close_bf16(got, want)


def test_frontend_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Wrong dtypes and shapes, CPU weights beside CUDA inputs, inputs that
    require grad; no row, no launch."""
    x = torch.zeros(2, 9, 512, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(512, 1536, dtype=torch.bfloat16, device=dev)
    g, b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
    with pytest.raises(NotImplementedError, match="K14"):  # f32 x: not ported
        fused_conv_ln_gelu(x.float(), w.float(), g, b)
    with pytest.raises(ValueError):  # 256 channels
        fused_conv_ln_gelu(x[..., :256].contiguous(), w[:, :768].contiguous(), g, b)
    with pytest.raises(ValueError):  # k = 4
        fused_conv_ln_gelu(x, torch.zeros(512, 2048, dtype=torch.bfloat16, device=dev), g, b)
    with pytest.raises(ValueError):  # CPU weight
        fused_conv_ln_gelu(x, w.cpu(), g.cpu(), b.cpu())
    with pytest.raises(TypeError):  # f16
        ln_gelu(x.half(), g, b)
    with pytest.raises(ValueError):  # 256 channels
        ln_gelu(x[..., :256].contiguous(), g[:256], b[:256])
    with pytest.raises(ValueError):  # not contiguous
        ln_gelu(x.transpose(0, 1), g, b)
    with pytest.raises(ValueError):
        ln_gelu(x, g, b, gelu_mode="sigmoid")
    before = ln_gelu.launches
    assert ln_gelu(x[:, :0], g, b).shape == (2, 0, 512) and ln_gelu.launches == before
    wav = torch.zeros(2, 1600, dtype=torch.bfloat16, device=dev)
    w0 = torch.zeros(512, 1, 10, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):  # f16 wav
        conv0_ln_gelu_q8(wav.half(), w0.half(), g, b)
    with pytest.raises(ValueError):  # fewer samples than the kernel width
        conv0_ln_gelu_q8(wav[:, :9].contiguous(), w0, g, b)
    with pytest.raises(ValueError):  # k = 8, stride 4
        conv0_ln_gelu_q8(wav, w0[..., :8].contiguous(), g, b, stride=4, k=8)
    xq = torch.zeros(2, 9, 512, dtype=torch.int8, device=dev)
    xs = torch.ones(2, 9, 1, device=dev)
    taps = (torch.zeros(3, 512, 512, dtype=torch.int8, device=dev),
            torch.ones(3, 512, device=dev))
    with pytest.raises(TypeError):  # bf16 rows
        fused_int8_conv_ln_gelu(x, xs, taps, g, b)
    with pytest.raises(ValueError):  # a scale per utterance, not per row
        fused_int8_conv_ln_gelu(xq, xs[:, :1].contiguous(), taps, g, b)
    with pytest.raises(TypeError):  # bf16 weight scales
        fused_int8_conv_ln_gelu(xq, xs, (taps[0], taps[1].bfloat16()), g, b)
    for tensor, call in ((x, lambda: fused_conv_ln_gelu(x, w, g, b)),
                         (x, lambda: ln_gelu(x, g, b)),
                         (wav, lambda: conv0_ln_gelu_q8(wav, w0, g, b)),
                         (xs, lambda: fused_int8_conv_ln_gelu(xq, xs, taps, g, b))):
        tensor.requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):  # the kernels have no backward
            call()
        with torch.no_grad():
            call()
        tensor.requires_grad_(False)


@pytest.mark.parametrize("model,path,option,launches", [
    ("hubert", "int8", "int8_conv", [0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2]),
    ("hubert", "int8", "fused_conv", [1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2]),
    ("hubert", "bf16", "fused_conv", [1, 0, 0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2]),
    ("hubert", "int8", "fused_midln", [1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2]),
    ("hubert", "bf16", "fused_midln", [1, 0, 0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2]),
    ("wavlm", "bf16", "fused_conv", [1, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 2]),
    ("wavlm", "int8", "fused_midln", [1, 0, 2, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 2]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_tiny_models_frontend_options_match_cpu(dev, monkeypatch, model, path, option, launches):
    """Each front-end option on the card (mid layers 512 wide, lengths 6,400,
    3,001 and 1 sample) against the same seed's model on the CPU, with its
    launch counts: K13a + 2 K13b in place of K3, or K3 + 2 K14, or K3 + 2
    K15 after the stock mid convs."""
    quantize = path == "int8"
    if model == "hubert":
        pair = _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=quantize,
                                layers=FRONT_LAYERS, **{option: True})
    else:
        pair = _tiny_wavlm_pair(dev, quantize, layers=FRONT_LAYERS, **{option: True})
    _trunk_on_card_vs_cpu(dev, monkeypatch, quantize, launches, pair=pair)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_mode_extractor_gets_gradients_on_the_card(dev, dtype):
    """Layer 0 in train() takes the stock conv, LN and GELU, never the
    forward-only K3: conv_0 and ln_0 get gradients, and the features agree
    with the eval-mode kernel route: f32 at atol 1e-4; bf16 at cosine >
    0.999, the bar between bf16 paths that round at other points (the
    stock layer rounds the conv and the LN to bf16, K3 once at the end, and
    three layers compound it)."""
    from s3prl_tpu_torch.models.convfe import ConvFeatureExtractor

    fe = ConvFeatureExtractor(FRONT_LAYERS, dtype=dtype, device=dev)
    wavs = _t(np.random.RandomState(30).randn(2, 3207), dev)
    before = conv0_ln_gelu.launches
    got = fe.train()(wavs)
    got.float().square().mean().backward()
    assert conv0_ln_gelu.launches == before
    first = fe.conv_layers[0]
    assert first.conv.weight.grad is not None and first.norm.weight.grad is not None
    assert first.norm.bias.grad is not None
    with torch.no_grad():
        want = fe.eval()(wavs)
    assert conv0_ln_gelu.launches == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got.detach(), want, atol=1e-4, rtol=0)
    else:
        a, c = got.detach().double().flatten(), want.double().flatten()
        assert float(a @ c / (a.norm() * c.norm())) > 0.999


def test_every_block_kernel_refuses_inputs_that_require_grad(dev):
    """K1-K8 and K12 are forward-only: on the card each raises for an input
    that requires grad while grad is enabled (K7/K8 dropped the gradient
    silently before) and runs under no_grad."""
    rng = np.random.RandomState(31)
    C, H = 128, 2
    x = _t(rng.randn(2, 64, C) * 0.5, dev, torch.bfloat16)
    wq, bq = _block_weights(rng, dev, C, 3 * C)
    wo, bo = _block_weights(rng, dev, C, C)
    w1, b1 = _block_weights(rng, dev, C, 256)
    w2, b2 = _block_weights(rng, dev, 256, C)
    ln = _ln(rng, dev, C)
    kv = torch.tensor([64, 30], dtype=torch.int32, device=dev)
    qkv = _t(rng.randn(2, 600, 3 * C), dev, torch.bfloat16)
    kv_long = torch.tensor([600, 300], dtype=torch.int32, device=dev)
    q = _t(rng.randn(2, H, 2100, 64), dev, torch.bfloat16)
    kv_online = torch.tensor([2100, 900], dtype=torch.int32, device=dev)
    wav = _t(rng.randn(1, 1600), dev)
    w0 = _t(rng.randn(512, 1, 10) / np.sqrt(10), dev)
    g0, b0 = _ln(rng, dev, 512)
    calls = {
        "K3": lambda: conv0_ln_gelu(wav, w0, g0, b0),
        "K1": lambda: fused_attention_block(x, wq, bq, ln, wo, bo, kv, H),
        "K2": lambda: fused_int8_ffn(x, w1, b1, w2, b2, ln=ln, residual=True),
        "K4": lambda: fused_attention_block_bf16(x, wq, bq, ln, wo, bo, kv, H),
        "K5": lambda: fused_bf16_ffn(x, w1, b1, w2, b2, ln=ln, residual=True),
        "K6": lambda: fused_qkv_attention_outproj(qkv, qkv[..., :C].contiguous(), wo.float(),
                                                  bo, kv_long, H),
        "K7": lambda: fused_qkv_attention(qkv, kv_long, H),
        "K8": lambda: online_flash_attention(q, q, q, kv_online),
        "K12": lambda: fused_int8_linear(x, wq.float(), bq, ln=ln),
    }
    grads = {"K3": w0, "K1": bq, "K2": b1, "K4": x, "K5": x, "K6": bo, "K7": qkv, "K8": q,
             "K12": x}
    for name, call in calls.items():
        t = grads[name]
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()
        t.requires_grad_(False)
    torch.cuda.synchronize()


# -- the pos-conv options: K16a, K16b; K17 --------------------------------------------

def _posconv_inputs(rng, dev, B, T, dtype=torch.bfloat16, C=1024, G=16, k=128):
    """x [B, T, C] (scale 0.5), an f32 nn.Conv1d weight [C, C/G, k] and a bias."""
    x = _t(rng.randn(B, T, C) * 0.5, dev, dtype)
    w = _t(rng.randn(C, C // G, k) / np.sqrt(k * C // G), dev)
    return x, w, _t(rng.randn(C) * 0.1, dev)


# K16a's shapes: T on and beside its 256-frame and 128-row window-box edges,
# B = 1 and 3, and the main path's B=32 x 10 s
K16A_SHAPES = [(B, T) for T in (1, 127, 128, 129, 255, 256, 257, 499, 1499, 2048)
               for B in (1, 3)] + [(32, 499)]


@pytest.mark.parametrize("B,T", K16A_SHAPES)
def test_k16a_kernel(dev, B, T):
    """K16a against its plain version on the card (k 128, 16 groups of 64);
    the nn.Conv1d weight and the load-time GEMM weight give one result."""
    x, w, bias = _posconv_inputs(np.random.RandomState(32), dev, B, T)
    wg = pc.posconv_gemm_weight(w.bfloat16(), 16)
    before = pc.pos_conv_gelu.launches
    got = pc.pos_conv_gelu(x, wg, bias)
    torch.cuda.synchronize()
    assert pc.pos_conv_gelu.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close_bf16(got, pc.pos_conv_gelu_reference(x, wg, bias, 16))
    assert torch.equal(pc.pos_conv_gelu(x, w.bfloat16(), bias), got)


# K16b's shapes: T on and beside its warpgroups' 256-frame halves and its
# 512-frame block edge, B = 1 and 3, and the main path's B=32 x 10 s
K16B_SHAPES = [(B, T) for T in (1, 63, 64, 65, 255, 256, 257, 499, 511, 512, 513, 1499, 2048)
               for B in (1, 3)] + [(32, 499)]


def _zero_past_lengths(x):
    """x [B, T, C] with the frames past each utterance's length zeroed, as
    in a padded batch: lengths T, 5T/8, 1, then T - 13 b (at least 1)."""
    B, T, _ = x.shape
    lens = [T, max(1, 5 * T // 8), 1] if B <= 3 else [max(1, T - 13 * b) for b in range(B)]
    for b, n in enumerate(lens[:B]):
        x[b, n:] = 0
    return x


@pytest.mark.parametrize("k", [32, 64, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,T", K16B_SHAPES)
def test_k16b_kernel(dev, B, T, dtype, k):
    """K16b at k 32 to 1,024 on padded batches: its activation codes and
    scales, the quantizer's (`posconv_quant`) and the ones its conv kernel
    writes into its windows (test mode), equal the plain version's; its
    output matches the plain version's (exact int32 sums on both sides):
    bf16 by `_close_bf16`, f32 at atol 1e-4; one launch a call."""
    x, w, bias = _posconv_inputs(np.random.RandomState(33), dev, B, T, dtype, k=k)
    x = _zero_past_lengths(x)
    want_q, want_xs = pc.quantize_posconv_input(x, 16)
    q, xs = pc.posconv_quant(x, 16)
    assert torch.equal(xs, want_xs) and torch.equal(q, want_q)
    wq, ws = pc.quantize_posconv_weight(w, 16)
    before = pc.pos_conv_gelu_q8.launches
    got = pc.pos_conv_gelu_q8(x, (wq, ws), bias)
    torch.cuda.synchronize()
    assert pc.pos_conv_gelu_q8.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = pc.pos_conv_gelu_q8_reference(x, wq, ws, bias, 16)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _close_bf16(got, want)
    assert torch.equal(pc.pos_conv_gelu_q8(x, w, bias), got)
    out, q, xs = pc.pos_conv_gelu_q8(x, (wq, ws), bias, codes=True)
    assert torch.equal(out, got) and torch.equal(xs, want_xs) and torch.equal(q, want_q)


@pytest.mark.parametrize("T,B,H", [(T, B, 2) for T in GATED_T for B in (1, 3, 7)]
                         + [(499, 32, 16)])
def test_k17_kernel(dev, T, B, H):
    """K17 on [B, H, T, 64] with kv_lens on the tile edges (`_edge_kv`)
    against its plain version on the card; beyond MAX_KERNEL_T it hands
    over to K8, whose launch counts instead."""
    rng = np.random.RandomState(34)
    q, k, v = (_t(rng.randn(B, H, T, 64) * sc, dev, torch.bfloat16) for sc in (0.125, 1, 1))
    kv = _edge_kv(B, T, dev)
    before = fa.flash_attention.launches, online_flash_attention.launches
    got = fa.flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    online = T > fa.MAX_KERNEL_T
    assert (fa.flash_attention.launches - before[0],
            online_flash_attention.launches - before[1]) == (0 + (not online), 0 + online)
    plain = online_flash_attention_reference if online else fa.flash_attention_reference
    _close_bf16(got, plain(q, k, v, kv))


def test_posconv_and_k17_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Wrong dtypes, group widths and tap counts, CPU weights beside CUDA
    inputs, inputs that require grad; no frame, no launch."""
    x, w, bias = _posconv_inputs(np.random.RandomState(35), dev, 2, 40)
    wg, (wq, ws) = pc.posconv_gemm_weight(w.bfloat16(), 16), pc.quantize_posconv_weight(w, 16)
    with pytest.raises(NotImplementedError, match="K16a"):  # f32 x: not ported
        pc.pos_conv_gelu(x.float(), wg.float(), bias)
    with pytest.raises(ValueError):  # 32 channels per group
        pc.pos_conv_gelu(x[..., :512].contiguous(), wg[:, :32, :4096].contiguous(),
                         bias[:512].contiguous())
    with pytest.raises(ValueError):  # k = 24, not a multiple of 16
        pc.pos_conv_gelu(x, wg[..., :24 * 64].contiguous(), bias)
    with pytest.raises(ValueError):  # CPU weight beside a CUDA input
        pc.pos_conv_gelu(x, wg.cpu(), bias.cpu())
    with pytest.raises(TypeError):  # f16 x
        pc.pos_conv_gelu_q8(x.half(), (wq, ws), bias)
    with pytest.raises(TypeError):  # bf16 weight scales
        pc.pos_conv_gelu_q8(x, (wq, ws.bfloat16()), bias)
    with pytest.raises(ValueError):  # k = 48, not a multiple of 32
        pc.pos_conv_gelu_q8(x, (wq[..., :48 * 64].contiguous(), ws), bias)
    before = pc.pos_conv_gelu.launches, pc.pos_conv_gelu_q8.launches
    assert pc.pos_conv_gelu(x[:, :0], wg, bias).shape == (2, 0, 1024)
    assert pc.pos_conv_gelu_q8(x[:, :0], (wq, ws), bias).shape == (2, 0, 1024)
    assert (pc.pos_conv_gelu.launches, pc.pos_conv_gelu_q8.launches) == before
    q = torch.zeros(1, 2, 100, 64, dtype=torch.bfloat16, device=dev)
    kv = torch.tensor([60], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):  # f32 q, k, v
        fa.flash_attention(q.float(), q.float(), q.float(), kv)
    with pytest.raises(ValueError):  # head dim 32
        fa.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                           q[..., :32].contiguous(), kv)
    for tensor, call in ((x, lambda: pc.pos_conv_gelu(x, wg, bias)),
                         (bias, lambda: pc.pos_conv_gelu_q8(x, (wq, ws), bias)),
                         (q, lambda: fa.flash_attention(q, q, q, kv))):
        tensor.requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):  # the kernels have no backward
            call()
        with torch.no_grad():
            call()
        tensor.requires_grad_(False)


@pytest.mark.parametrize("model,path,option,max_posconv_t,launches", [
    ("hubert", "bf16", "fused_posconv", 2048, [1, 0, 0, 2, 2] + [0] * 11 + [1]),
    ("hubert", "int8", "int8_posconv", 2048, [1, 2, 2] + [0] * 14 + [1]),
    ("hubert", "int8", "fused_posconv", 2048, [1, 2, 2] + [0] * 13 + [1]),
    ("hubert", "f32", "int8_posconv", 2048, [1] + [0] * 16 + [1]),
    ("hubert", "int8", "int8_posconv", 64, [1, 2, 2]),
    ("wavlm", "bf16", "fused_posconv", 2048, [1] + [0] * 7 + [2] + [0] * 7 + [1]),
    ("wavlm", "int8", "int8_posconv", 2048, [1, 0, 2] + [0] * 5 + [2] + [0] * 8 + [1]),
], ids=lambda v: v if isinstance(v, str) else str(v) if isinstance(v, int) else "")
def test_tiny_models_posconv_options_match_cpu(dev, monkeypatch, model, path, option,
                                               max_posconv_t, launches):
    """Each pos-conv option on the card (C = 128 in 2 groups of 64, k = 32;
    T' = 320 frames) against the same seed's model on the CPU, with its
    launch counts: one K16a or K16b a forward, none when MAX_POSCONV_T is
    below T' (the stock conv)."""
    monkeypatch.setattr(pc, "MAX_POSCONV_T", max_posconv_t)
    quantize, dtype = path == "int8", torch.float32 if path == "f32" else torch.bfloat16
    if model == "hubert":
        pair = _tiny_trunk_pair(dtype, path != "f32", dev, quantize=quantize, conv_pos=(32, 2),
                                **{option: True})
    else:
        pair = _tiny_wavlm_pair(dev, quantize, conv_pos=(32, 2), **{option: True})
    _trunk_on_card_vs_cpu(dev, monkeypatch, quantize, launches, pair=pair)


# -- rows with no valid key (kv_len = 0: an utterance with no frame under the
# conv length rule) and the post-LN forms at the Large width ------------------------

def _zero_kv(B, T, dev):
    """kv_lens [T, 0, 5T/8, T, 0, ...]: utterance 1 has no valid key."""
    return torch.tensor([(T, 0, (T * 5) // 8)[i % 3] for i in range(B)], dtype=torch.int32,
                        device=dev)


def _mean_rows(out, v, b):
    """Utterance b's rows of out [B, H, T, Dh] against the mean over T of
    its values v [B, H, T, Dh] (a uniform row)."""
    _close_bf16(out[b], v[b].float().mean(1, keepdim=True).expand_as(v[b]))


@pytest.mark.parametrize("T", [65, 499])
@pytest.mark.parametrize("kernel", ["K1", "K1-postnorm", "K4", "K4-postnorm"])
def test_block_kernels_with_rows_without_keys(dev, kernel, T):
    """K1 and K4 (pre-LN and postnorm, C 1,024, H 16) on B = 3 with an
    utterance of kv_len 0 against their plain versions on the card."""
    rng = np.random.RandomState(40)
    B, C, H = 3, 1024, 16
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    kv = _zero_kv(B, T, dev)
    postnorm = kernel.endswith("postnorm")
    ln = _ln(rng, dev, C)
    if kernel.startswith("K1"):
        (wq, bq), (wo, bo) = _qpair(rng, dev, C, 3 * C), _qpair(rng, dev, C, C)
        fn, plain = fused_attention_block, fused_attention_block_reference
    else:
        (wq, bq), (wo, bo) = _block_weights(rng, dev, C, 3 * C), _block_weights(rng, dev, C, C)
        fn, plain = fused_attention_block_bf16, fused_attention_block_bf16_reference
    before = fn.launches
    got = fn(x, wq, bq, ln, wo, bo, kv, H, postnorm=postnorm)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and bool(torch.isfinite(got).all())
    _close_bf16(got, plain(x, wq, bq, ln, wo, bo, kv, H, postnorm=postnorm))


@pytest.mark.parametrize("form", ["ln-residual", "postnorm", "bare"])
def test_k2_on_padded_rows(dev, form):
    """K2 (C 1,024, F 4,096) on the rows of an utterance with no frame: one
    utterance all zero rows (bare: the row quantizer's clamp, codes 0),
    one of a single repeated row (its LN has zero variance), one unit-scale,
    against the plain version on the card."""
    rng = np.random.RandomState(41)
    B, T, C, F = 3, 123, 1024, 4096
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    x[1] = 0
    x[2] = x[2, :1].expand(T, C)
    (w1, b1), (w2, b2) = _qpair(rng, dev, C, F), _qpair(rng, dev, F, C)
    kw = {"ln-residual": dict(ln=_ln(rng, dev, C), residual=True),
          "postnorm": dict(ln=_ln(rng, dev, C), residual=True, postnorm=True),
          "bare": {}}[form]
    before = fused_int8_ffn.launches
    got = fused_int8_ffn(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    assert fused_int8_ffn.launches == before + 1 and bool(torch.isfinite(got).all())
    _close_bf16(got, fused_int8_ffn_reference(x, w1, b1, w2, b2, **kw))


@pytest.mark.parametrize("T", [65, 1499, 2049])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_k6_k7_with_rows_without_keys(dev, kernel, T):
    """K6 and K7 (C 1,024, H 16) with an utterance of kv_len 0 against the
    plain versions of their route (K8 beyond MAX_KERNEL_T); K7's row
    without keys is the mean of the values."""
    rng = np.random.RandomState(42)
    B, C, H = 3, 1024, 16
    qkv = _t(rng.randn(B, T, 3 * C), dev, torch.bfloat16)
    kv = _zero_kv(B, T, dev)
    if kernel == "K6":
        x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
        wo, bo = _qpair(rng, dev, C, C)
        got = fused_qkv_attention_outproj(qkv, x, wo, bo, kv, H)
        want = fused_qkv_attention_outproj(*_on_cpu(qkv, x, wo, bo, kv), H)
    else:
        got = fused_qkv_attention(qkv, kv, H)
        want = fused_qkv_attention(*_on_cpu(qkv, kv), H)
        v = qkv[..., 2 * C:].view(B, T, H, 64).transpose(1, 2)
        _mean_rows(got.view(B, T, H, 64).transpose(1, 2), v, 1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _close_bf16(got, want)


@pytest.mark.parametrize("kernel,T", [("K8", 65), ("K8", 2049), ("K9", 65), ("K9", 499),
                                      ("K10", 65), ("K10", 2049), ("K17", 65), ("K17", 499),
                                      ("K17", 2049)])
def test_split_head_kernels_with_rows_without_keys(dev, kernel, T):
    """K8, K9 (the main path's padded bf16 bias), K10 and K17 called directly
    on [3, 16, T, 64] with an utterance of kv_len 0: finite, equal to the
    plain version on the card, and that row the mean of the values (a row
    without keys runs every key tile of T; skipping them gave 0 / l_floor:
    0 in K8 / K10, NaN in K9 / K17)."""
    rng = np.random.RandomState(43)
    B, H = 3, 16
    q, k, v, pos_bias, gate, _ = _gated_inputs(rng, dev, B, H, T, "bf16-padded")
    kv = _zero_kv(B, T, dev)
    fn, plain = {
        "K8": (online_flash_attention, online_flash_attention_reference),
        "K17": (fa._gated_launch, fa.flash_attention_reference),
        "K9": (gated_bias_attention, gated_bias_attention_reference),
        "K10": (gated_online_flash_attention, gated_online_flash_attention_reference)}[kernel]
    if kernel == "K17":  # its own launch at every T (the wrapper hands T > 2,048 to K8)
        got = fn(q, k, v, None, None, kv, -1e9, 0.0)
        want = plain(q, k, v, kv)
    elif kernel == "K8":
        got, want = fn(q, k, v, kv), plain(q, k, v, kv)
    else:
        got = fn(q, k, v, pos_bias, gate, kv)
        want = plain(q, k, v, pos_bias, gate, kv)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _close_bf16(got, want)
    _mean_rows(got, v, 1)


@pytest.mark.parametrize("T", [65, 499])
def test_k11_with_rows_without_keys(dev, T):
    """K11 (H 16) with an utterance of kv_len 0 against its plain version."""
    from s3prl_tpu_torch.models.wavlm import bucket_table

    rng = np.random.RandomState(44)
    B, H = 3, 16
    C = H * 64
    qkv = _t(rng.randn(B, T, 3 * C), dev, torch.bfloat16)
    x = _t(rng.randn(B, T, C) * 0.5, dev, torch.bfloat16)
    pos_bias = _t(rng.randn(320, H) * 0.5, dev).t()[:, bucket_table(T, 320, 800, dev)].contiguous()
    gate = _t(1 + 2 * rng.rand(B, H, T), dev)
    wo, bo = _qpair(rng, dev, C, C)
    kv = _zero_kv(B, T, dev)
    before = fa.gated_bias_attention_outproj.launches
    got = fa.gated_bias_attention_outproj(qkv, x, pos_bias, gate, wo, bo, kv, H)
    torch.cuda.synchronize()
    assert fa.gated_bias_attention_outproj.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close_bf16(got, fa.gated_bias_attention_outproj(*_on_cpu(qkv, x, pos_bias, gate, wo, bo,
                                                              kv), H))


@pytest.mark.parametrize("kernel", ["K1", "K4", "K2", "K5", "K6-raw-x"])
def test_post_ln_forms_at_c1024(dev, kernel):
    """The post-LN kernel forms of data2vec-Large (C 1,024, H 16, F 4,096)
    on a unit-scale residual stream: K1 / K4 postnorm and K2 / K5 postnorm
    at B = 4 x 499, K6 on a QKV made from raw x (int8_matmul) at 4 x 1,499,
    each against its plain version on the card."""
    from s3prl_tpu_torch.ops.quant import int8_matmul

    rng = np.random.RandomState(45)
    C, H, F = 1024, 16, 4096
    T = 1499 if kernel == "K6-raw-x" else 499
    x = _t(rng.randn(4, T, C), dev, torch.bfloat16)
    kv = _long_kv(T, dev)
    kv = torch.cat([kv, kv[:1]])
    ln = _ln(rng, dev, C)
    if kernel == "K1":
        (wq, bq), (wo, bo) = _qpair(rng, dev, C, 3 * C), _qpair(rng, dev, C, C)
        got = fused_attention_block(x, wq, bq, ln, wo, bo, kv, H, postnorm=True)
        want = fused_attention_block_reference(x, wq, bq, ln, wo, bo, kv, H, postnorm=True)
    elif kernel == "K4":
        (wq, bq), (wo, bo) = _block_weights(rng, dev, C, 3 * C), _block_weights(rng, dev, C, C)
        got = fused_attention_block_bf16(x, wq, bq, ln, wo, bo, kv, H, postnorm=True)
        want = fused_attention_block_bf16_reference(x, wq, bq, ln, wo, bo, kv, H,
                                                    postnorm=True)
    elif kernel == "K2":
        (w1, b1), (w2, b2) = _qpair(rng, dev, C, F), _qpair(rng, dev, F, C)
        got = fused_int8_ffn(x, w1, b1, w2, b2, ln=ln, residual=True, postnorm=True)
        want = fused_int8_ffn_reference(x, w1, b1, w2, b2, ln=ln, residual=True, postnorm=True)
    elif kernel == "K5":
        (w1, b1), (w2, b2) = _block_weights(rng, dev, C, F), _block_weights(rng, dev, F, C)
        got = fused_bf16_ffn(x, w1, b1, w2, b2, ln=ln, residual=True, postnorm=True)
        want = fused_bf16_ffn_reference(x, w1, b1, w2, b2, ln=ln, residual=True, postnorm=True)
    else:
        wq, bq = _qpair(rng, dev, C, 3 * C)
        qkv = int8_matmul(x, wq, bq, out_dtype=torch.bfloat16)
        wo, bo = _qpair(rng, dev, C, C)
        got = fused_qkv_attention_outproj(qkv, x, wo, bo, kv, H)
        want = fused_qkv_attention_outproj(*_on_cpu(qkv, x, wo, bo, kv), H)
    torch.cuda.synchronize()
    _close_bf16(got, want)


# -- frozen-upstream probe training on the card ----------------------------------------


def _probe_trainer(up, exp_dir):
    """An UtteranceLevel probe over `up` with the trainer's Adam (lr 1e-3)."""
    from s3prl_tpu_torch.nn import UpstreamDownstreamModel, UtteranceLevel
    from s3prl_tpu_torch.task import UtteranceClassificationTask
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    task = UtteranceClassificationTask(
        UpstreamDownstreamModel(UtteranceLevel(128, 4, (16,)), up.num_layers), 4)
    trainer = Trainer(up, task, exp_dir, TrainerConfig(
        total_steps=4, tensorboard=False, optimizer={"name": "Adam", "lr": 1e-3}))
    trainer.init()
    return trainer


def _update_cosines(before, after_a, after_b):
    """Per parameter, the cosine between two runs' updates from `before`."""
    out = {}
    for k, p0 in before.items():
        a = (after_a[k].cpu() - p0.cpu()).double().flatten()
        b = (after_b[k].cpu() - p0.cpu()).double().flatten()
        out[k] = float(a @ b / (a.norm() * b.norm()))
    return out


def test_probe_training_on_the_card(dev, tmp_path):
    """The int8 tiny trunk under the trainer: every step launches K3 once
    and K1 and K2 once a layer with the upstream in eval(), the loss
    finite. Then one probe step from the card's states on the card and,
    from the same probe and optimizer state, on the CPU: loss and gradient
    norm at rtol 1e-3, each parameter's update at cosine > 0.999 (the f32
    head sums in other orders; Adam's update m / sqrt(v) can flip sign only
    where a gradient is near zero)."""
    cpu, gpu = _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=True)
    wavs, lens = _tiny_batch()
    batch = {"x": wavs.to(dev), "x_len": lens.to(dev),
             "class_id": np.array([0, 3, 1], np.int32)}
    card = _probe_trainer(gpu, tmp_path / "card")
    for _ in range(3):
        for w in wrappers():
            w.launches = 0
        loss, _, _ = card.train_step(batch)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers()] == [1, 2, 2] + [0] * (len(wrappers()) - 3)
        assert not gpu.model.training and card.task.module.training and torch.isfinite(loss)
    hs, h_lens = gpu(batch["x"], batch["x_len"])
    assert hs.dtype == torch.bfloat16 and not hs.requires_grad
    host = _probe_trainer(cpu, tmp_path / "cpu")
    host.task.module.load_state_dict(card.task.module.state_dict())
    host.optimizer.load_state_dict(copy.deepcopy(card.optimizer.state_dict()))
    before = {k: v.clone() for k, v in card.task.module.state_dict().items()}
    loss_card, _, norm_card = card.probe_step(hs, h_lens, batch)
    loss_cpu, _, norm_cpu = host.probe_step(hs.cpu(), h_lens.cpu(), batch)
    np.testing.assert_allclose(float(loss_card), float(loss_cpu), rtol=1e-3)
    np.testing.assert_allclose(float(norm_card), float(norm_cpu), rtol=1e-3)
    coss = _update_cosines(before, card.task.module.state_dict(), host.task.module.state_dict())
    assert min(coss.values()) > 0.999, coss


# -- the CTC probe on the card -----------------------------------------------------


def _ctc_trainer(up, exp_dir, tokenizer):
    """A BLSTM-CTC probe over `up` (RNNEncoder(hidden 32, 2 layers, proj
    32)) with the trainer's Adam (lr 1e-3)."""
    from s3prl_tpu_torch.nn import RNNEncoder, UpstreamDownstreamModel
    from s3prl_tpu_torch.task import Speech2TextCTCTask
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    task = Speech2TextCTCTask(UpstreamDownstreamModel(
        RNNEncoder(128, tokenizer.vocab_size, 32, 2, proj_size=32, dropout=0.0),
        up.num_layers), tokenizer)
    trainer = Trainer(up, task, exp_dir, TrainerConfig(
        total_steps=4, tensorboard=False, optimizer={"name": "Adam", "lr": 1e-3}))
    trainer.init()
    return trainer


def test_asr_training_on_the_card(dev, tmp_path):
    """The int8 tiny trunk under a BLSTM-CTC probe: every step launches K3
    once and K1 and K2 once a layer with the upstream in eval(), the loss
    finite (the 1-sample row has no frame: optax's 1e5). One probe step
    from the card's states on the card and on the CPU: loss and gradient
    norm at rtol 1e-3, each parameter's update at cosine > 0.999. Then the
    LSTM with cuDNN's TF32 switched on globally against the CPU at atol 1e-4
    (it runs with TF32 off: TF32 would be 1e-3 off), forward and backward,
    and the CTC loss with an infeasible row on the card against the CPU:
    values at rtol 1e-5, the logit gradient at atol 1e-5."""
    from s3prl_tpu_torch.data.collate import pad_collate
    from s3prl_tpu_torch.data.encoder import CharacterTokenizer
    from s3prl_tpu_torch.nn import RNNEncoder
    from s3prl_tpu_torch.ops.ctc import ctc_loss

    tok = CharacterTokenizer.from_text(["ab ba", "cab"])
    cpu, gpu = _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=True)
    wavs, lens = _tiny_batch()
    items = [{"class_ids": np.asarray(tok.encode(t), np.int32), "labels": t}
             for t in ("ab ba", "cab", "a")]
    batch = {"x": wavs.to(dev), "x_len": lens.to(dev), **pad_collate(items)}
    card = _ctc_trainer(gpu, tmp_path / "card", tok)
    for _ in range(3):
        for w in wrappers():
            w.launches = 0
        loss, _, _ = card.train_step(batch)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers()] == [1, 2, 2] + [0] * (len(wrappers()) - 3)
        assert not gpu.model.training and card.task.module.training and torch.isfinite(loss)
    hs, h_lens = gpu(batch["x"], batch["x_len"])
    host = _ctc_trainer(cpu, tmp_path / "cpu", tok)
    host.task.module.load_state_dict(card.task.module.state_dict())
    host.optimizer.load_state_dict(copy.deepcopy(card.optimizer.state_dict()))
    before = {k: v.clone() for k, v in card.task.module.state_dict().items()}
    loss_card, _, norm_card = card.probe_step(hs, h_lens, batch)
    loss_cpu, _, norm_cpu = host.probe_step(hs.cpu(), h_lens.cpu(), batch)
    np.testing.assert_allclose(float(loss_card), float(loss_cpu), rtol=1e-3)
    np.testing.assert_allclose(float(norm_card), float(norm_cpu), rtol=1e-3)
    coss = _update_cosines(before, card.task.module.state_dict(), host.task.module.state_dict())
    assert min(coss.values()) > 0.999, coss

    rng = np.random.RandomState(8)
    x = rng.randn(4, 50, 128).astype(np.float32)
    x_lens = torch.tensor([50, 31, 1, 0])
    enc = RNNEncoder(128, 9, 256, 2, proj_size=256, dropout=0.0)
    grads = {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in ("cpu", dev):
            model = copy.deepcopy(enc).to(where).train()
            xs = torch.from_numpy(x).to(where).requires_grad_()
            out, _ = model(xs, x_lens)
            (out * torch.linspace(-1, 1, 9, device=where)).sum().backward()
            grads[str(where)] = [out.detach().cpu(), xs.grad.cpu()] + [
                p.grad.cpu() for p in model.parameters() if p.requires_grad]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)

    logits = rng.randn(3, 12, tok.vocab_size).astype(np.float32) * 2
    labels, label_lens = np.asarray([[3, 4, 5], [4, 4, 0], [3, 5, 6]]), np.asarray([3, 2, 3])
    frame_lens = torch.tensor([12, 3, 2])  # feasible, feasible (a repeat), infeasible
    out = {}
    for where in ("cpu", dev):
        z = torch.from_numpy(logits).to(where).requires_grad_()
        per_seq = ctc_loss(z, frame_lens, labels, label_lens)
        per_seq.sum().backward()
        out[str(where)] = per_seq.detach().cpu().numpy(), z.grad.cpu().numpy()
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=1e-5, rtol=0)
    assert out["cuda"][0][2] > 9e4 and np.isfinite(out["cuda"][1]).all()


# -- the speaker probes on the card ---------------------------------------------------


def _speaker_trainer(up, task, exp_dir, optimizer, clip):
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(up, task, exp_dir, TrainerConfig(
        total_steps=4, tensorboard=False, gradient_clipping=clip, optimizer=optimizer))
    trainer.init()
    return trainer


def _one_update(task, optimizer, hs, h_lens, batch):
    """One micro-step and one update (an optimizer of accumulation 1
    carrying `optimizer`'s state) of `task` on the states: (loss, cache,
    gradient norm)."""
    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm

    opt = Optimizer(task.module.parameters(), **optimizer)
    loss, cache = task.loss_and_cache(hs, h_lens, batch, None, True)
    loss.backward()
    norm = global_norm([p.grad for p in opt.params])
    assert opt.step()
    return loss.detach(), cache, norm


def test_speaker_training_on_the_card(dev, tmp_path):
    """The int8 tiny trunk (20 samples a frame) under the speaker probes:
    an x-vector with AM-softmax (AdamW, clip 1e3) on 320 frames launches K3
    once and K1 and K2 once a layer; the diarization LSTM with PIT (Adam,
    clip 1) on 1,600 frames takes the long route, K3 once and K6
    (`fused_qkv_attention_outproj`) and K2 once a layer, K1 never; the
    upstream in eval(), the losses finite. Then one update of each probe
    from the card's states on the card and on the CPU: loss and gradient
    norm at rtol 1e-3, each parameter's update at cosine > 0.999
    (am_weight included; bias_ih held at zero), the same permutation a row.
    Last, the TDNN stack with cuDNN's TF32 switched on globally against the
    CPU at atol 1e-4, forward and backward (it runs with TF32 off)."""
    from s3prl_tpu_torch.data.corpus.kaldi_diar import rasterize_labels
    from s3prl_tpu_torch.nn import (SuperbDiarizationModel, SuperbXvector,
                                    UpstreamDownstreamModel, XVectorBackbone)
    from s3prl_tpu_torch.task import DiarizationPITTask, SpeakerVerificationTask

    cpu, gpu = _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=True)
    wavs, lens = _tiny_batch()
    rng = np.random.RandomState(9)
    n = 32000  # 1,600 frames
    sd_lens = torch.tensor([n, 25000, 12000])
    sd_wavs = torch.from_numpy(rng.randn(3, n).astype(np.float32)) * (
        torch.arange(n)[None] < sd_lens[:, None])
    segments = [("A", 0.0, 1.3), ("B", 0.9, 2.0)]
    label = np.stack([rasterize_labels(segments, 3200, spk, frame_shift=10) for spk in
                      (["A", "B"], ["B", "A"], ["A", "B"])])  # twice the states' frames
    cases = {
        "asv": (lambda up: SpeakerVerificationTask(UpstreamDownstreamModel(
                    SuperbXvector(128, 32, 32, 64), up.num_layers), 5),
                {"x": wavs, "x_len": lens, "class_id": np.array([0, 4, 2], np.int32)},
                {"name": "AdamW", "lr": 1e-3}, 1000.0, [1, 2, 2]),
        "sd": (lambda up: DiarizationPITTask(UpstreamDownstreamModel(
                   SuperbDiarizationModel(128, 2, 32, 1), up.num_layers)),
               {"x": sd_wavs, "x_len": sd_lens, "label": label,
                "label_len": np.array([3200, 2500, 1200], np.int32)},
               {"name": "Adam", "lr": 1e-3}, 1.0, [1, 0, 2, 0, 0, 2]),
    }
    for name, (make, batch, optimizer, clip, launches) in cases.items():
        batch = {**batch, "x": batch["x"].to(dev), "x_len": batch["x_len"].to(dev)}
        card = _speaker_trainer(gpu, make(gpu), tmp_path / name, optimizer, clip)
        for _ in range(2):
            for w in wrappers():
                w.launches = 0
            loss, _, _ = card.train_step(batch)
            torch.cuda.synchronize()
            assert [w.launches for w in wrappers()] == \
                launches + [0] * (len(wrappers()) - len(launches)), name
            assert not gpu.model.training and card.task.module.training and torch.isfinite(loss)
        hs, h_lens = gpu(batch["x"], batch["x_len"])
        host = make(cpu)
        host.module.load_state_dict({k: v.cpu() for k, v in
                                     card.task.module.state_dict().items()})
        before = {k: v.detach().cpu().clone() for k, v in card.task.module.state_dict().items()}
        kw = dict(optimizer, gradient_clipping=clip)
        out_card = _one_update(card.task, kw, hs, h_lens, batch)
        out_cpu = _one_update(host, kw, hs.cpu(), h_lens.cpu(), batch)
        for a, b in ((out_card[0], out_cpu[0]), (out_card[2], out_cpu[2])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-3, err_msg=name)
        after = card.task.module.state_dict()
        coss = _update_cosines({k: v for k, v in before.items() if ".bias_ih_" not in k},
                               after, host.module.state_dict())
        assert min(coss.values()) > 0.999, (name, coss)
        if name == "sd":
            perm = out_card[1]["best_perm"].cpu()
            assert torch.equal(perm, out_cpu[1]["best_perm"]) and len(set(perm.tolist())) == 2

    x = torch.from_numpy(rng.randn(2, 40, 64).astype(np.float32))
    backbone = XVectorBackbone(64, 96)
    grads = {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in ("cpu", dev):
            model = copy.deepcopy(backbone).to(where).train()
            xs = x.to(where, copy=True).requires_grad_()
            out = model(xs)
            (out * torch.linspace(-1, 1, 96, device=where)).sum().backward()
            grads[str(where)] = [out.detach().cpu(), xs.grad.cpu()] + [
                p.grad.cpu() for p in model.parameters()]
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


# -- query-by-example, HEAR and MOS on the card ---------------------------------------


def test_dtw_on_the_card(dev):
    """qbe_scores on CUDA tensors against the CPU's on the same features:
    queries of 12, 3 and 1 frames over documents of 7 to 1,499 frames, in
    one chunk and a document a chunk, at rtol 1e-5 with the same ranking
    for each query; the result stays on the card."""
    from s3prl_tpu_torch.ops.dtw import qbe_scores

    rng = np.random.RandomState(11)
    q = torch.from_numpy(rng.randn(3, 12, 1024).astype(np.float32))
    d = torch.from_numpy(rng.randn(5, 1499, 1024).astype(np.float32))
    ql, dl = torch.tensor([12, 3, 1]), torch.tensor([300, 40, 1499, 7, 800])
    want = qbe_scores(q, ql, d, dl)
    for max_gib in (2.0, 1e-6):
        got = qbe_scores(q.to(dev), ql.to(dev), d.to(dev), dl.to(dev), max_gib=max_gib)
        assert got.device.type == "cuda"
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)
        assert torch.equal(got.cpu().argsort(dim=1), want.argsort(dim=1))


def test_recipe_steps_on_the_card(dev, tmp_path):
    """The int8 tiny trunk (20 samples a frame, 320 frames) under the QbE
    embedder (two LSTMs, AdamW) and the MOS predictor with judge ids
    (Adam): each train step launches K3 once and K1 and K2 once a layer
    with the upstream in eval(); then one update of each probe from the
    card's states on the card and on the CPU: loss and gradient norm at
    rtol 1e-3, each parameter's update at cosine > 0.999 (bias_ih held at
    zero; the attention poolings' score biases, whose gradient is zero but
    for rounding, left out)."""
    from s3prl_tpu_torch.task import (MosDownstreamModule, MosPredictionTask, QbeEmbedder,
                                      QbeEmbeddingTask)

    cpu, gpu = _tiny_trunk_pair(torch.bfloat16, True, dev, quantize=True)
    wavs, lens = _tiny_batch()
    wavs, lens = torch.cat([wavs, wavs.flip(0)]), torch.cat([lens, lens.flip(0)])
    cases = {
        "qbe": (lambda: QbeEmbeddingTask(QbeEmbedder(gpu.num_layers, 128, 32, 48, 2)),
                {"pair_label": np.array([1, -1, 1] * 2, np.int32)},
                {"name": "AdamW", "lr": 1e-3}),
        "mos": (lambda: MosPredictionTask(MosDownstreamModule(gpu.num_layers, 128, 32, 8)),
                {"mean": np.linspace(1, 5, 6).astype(np.float32),
                 "mos": np.linspace(5, 1, 6).astype(np.float32),
                 "judge_id": np.array([0, 3, 7, 1, 1, 2], np.int32)},
                {"name": "Adam", "lr": 1e-3}),
    }
    for name, (make, labels, optimizer) in cases.items():
        batch = {"x": wavs.to(dev), "x_len": lens.to(dev), **labels}
        card = _speaker_trainer(gpu, make(), tmp_path / name, optimizer, 1.0)
        for _ in range(2):
            for w in wrappers():
                w.launches = 0
            loss, _, _ = card.train_step(batch)
            torch.cuda.synchronize()
            assert [w.launches for w in wrappers()][:3] == [1, 2, 2], name
            assert sum(w.launches for w in wrappers()) == 5, name
            assert not gpu.model.training and card.task.module.training and torch.isfinite(loss)
        hs, h_lens = gpu(batch["x"], batch["x_len"])
        host = make()
        host.module.load_state_dict({k: v.cpu() for k, v in
                                     card.task.module.state_dict().items()})
        before = {k: v.detach().cpu().clone() for k, v in card.task.module.state_dict().items()}
        kw = dict(optimizer, gradient_clipping=1.0)
        out_card = _one_update(card.task, kw, hs, h_lens, batch)
        out_cpu = _one_update(host, kw, hs.cpu(), h_lens.cpu(), batch)
        for a, b in ((out_card[0], out_cpu[0]), (out_card[2], out_cpu[2])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-3, err_msg=name)
        coss = _update_cosines({k: v for k, v in before.items() if ".bias_ih_" not in k
                                and not k.endswith(("attention_linear.bias", "pooling.bias"))},
                               card.task.module.state_dict(), host.module.state_dict())
        assert min(coss.values()) > 0.999, (name, coss)


# -- the upstream in train mode and VC on the card -------------------------------------


def _train_mode_pair(dev, model, **rates):
    """One seed's tiny HuBERT-Large-style (int8) or WavLM-Large-style (bf16)
    model with flash=True on the CPU and on the card, at `rates`."""
    import dataclasses

    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from s3prl_tpu_torch.models.wavlm import WavLMConfig
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    fields = dict(extractor_mode="layer_norm", conv_feature_layers=TINY_LAYERS,
                  encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                  encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4,
                  layer_norm_first=True, normalize=True)
    cfg = (WavLMConfig(**fields, num_buckets=32, max_distance=80) if model == "wavlm"
           else Wav2Vec2Config(**fields))
    cfg = dataclasses.replace(cfg, **rates)
    return [_trunk_upstream("tiny", cfg, dtype=torch.bfloat16, flash=True,
                            quantize=model == "hubert", seed=3, device=d) for d in ("cpu", dev)]


@pytest.mark.parametrize("model", ["hubert", "wavlm"])
def test_train_mode_step_on_the_card(dev, tmp_path, model):
    """flash=True with upstream_trainable at rates 0.1: a train step
    launches K7 (WavLM: K9) once a layer and nothing else (a refuse_grad
    error would raise), no upstream parameter gets a gradient and the
    states need none; at rates 0 the card's train-mode states match the
    CPU's at per-layer cosine > 0.999."""
    rates = dict(dropout=0.1, activation_dropout=0.1, dropout_input=0.1)
    _, gpu = _train_mode_pair(dev, model, **rates)
    wavs, lens = _tiny_batch()
    batch = {"x": wavs.to(dev), "x_len": lens.to(dev), "class_id": np.array([0, 3, 1], np.int32)}
    trainer = _probe_trainer(gpu, tmp_path)
    trainer.cfg.upstream_trainable = True
    kernel = 8 if model == "wavlm" else 6  # K9 / K7 in wrappers() order
    for _ in range(2):
        for w in wrappers():
            w.launches = 0
        loss, _, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        want = [0] * len(wrappers())
        want[kernel] = 2
        assert [w.launches for w in wrappers()] == want
        assert gpu.model.training and torch.isfinite(loss)
        assert all(p.grad is None for p in gpu.model.parameters())
    hs, _ = gpu(batch["x"], batch["x_len"], train=True,
                generator=torch.Generator(device=dev).manual_seed(0))
    assert not hs.requires_grad
    cpu, gpu = _train_mode_pair(dev, model, **dict.fromkeys(rates, 0.0))
    want, h_lens = cpu(wavs, lens, train=True)
    got, got_lens = gpu(wavs.to(dev), lens.to(dev), train=True)
    assert got_lens.tolist() == h_lens.tolist()
    for layer in range(got.shape[0]):
        a = torch.cat([got[layer, b, :n].float().cpu() for b, n in enumerate(h_lens.tolist())])
        b = torch.cat([want[layer, b, :n].float() for b, n in enumerate(h_lens.tolist())])
        cos = float((a.double() * b.double()).sum() / (a.double().norm() * b.double().norm()))
        assert cos > 0.999 or (a.norm() == 0 and b.norm() == 0), (layer, cos)


def test_griffin_lim_on_the_card(dev):
    """Griffin-Lim on cuFFT against the CPU on the same log-mels (a tone's
    and random ones): the zero-phase synthesis (no round) within 1e-5 of the
    peak 0.95 (log_mel_to_wav); after 32 rounds, whose phases are rounding
    where the magnitudes are inconsistent, the spectral convergence within
    1% of the CPU's."""
    from s3prl_tpu_torch.ops.audio import log_mel
    from s3prl_tpu_torch.ops.vocoder import (griffin_lim, log_mel_to_wav, mel_magnitudes,
                                             spectral_convergence)

    t = torch.arange(32000) / 16000
    wavs = torch.stack([0.3 * torch.sin(2 * np.pi * 220 * t), 0.2 * torch.sin(2 * np.pi * 523 * t)])
    wavs = wavs + 0.02 * torch.randn(wavs.shape, generator=torch.Generator().manual_seed(0))
    mels = {"tone": log_mel(wavs, n_mels=80)[0],
            "random": torch.randn(6, 412, 80, generator=torch.Generator().manual_seed(1)) * 2 - 3}
    for name, m in mels.items():
        got = log_mel_to_wav(m.to(dev), n_iter=0).cpu()
        want = log_mel_to_wav(m, n_iter=0)
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        assert float((got - want).abs().max()) < 1e-5, name
        mag = mel_magnitudes(m)
        sc_card = spectral_convergence(griffin_lim(mag.to(dev), n_iter=32), mag.to(dev))
        sc_cpu = spectral_convergence(griffin_lim(mag, n_iter=32), mag)
        assert abs(float(sc_card) / float(sc_cpu) - 1) < 1e-2, (name, float(sc_card),
                                                                 float(sc_cpu))


def test_vc_step_on_the_card(dev):
    """VcExample's Taco2-AR (the prenet's dropout off on both sides) on the
    same states and weights, card vs CPU: loss at rtol 1e-4, gradients at
    cosine > 0.9999."""
    import s3prl_tpu_torch.models.taco2ar as taco2ar
    from s3prl_tpu_torch.problem import VcExample

    class Up:
        num_layers, hidden_sizes = 3, [16] * 3

    rng = np.random.RandomState(0)
    hs = torch.from_numpy(rng.randn(3, 2, 60, 16).astype(np.float32))
    h_lens = torch.tensor([60, 41])
    batch = {"target_mel": rng.randn(2, 50, 80).astype(np.float32),
             "target_mel_len": np.array([50, 40], np.int32)}
    problem = VcExample()
    cpu_task = problem.build_task(Up(), problem.default_config())
    cpu_task.init_params(torch.Generator().manual_seed(0))
    gpu_task = problem.build_task(Up(), problem.default_config())
    gpu_task.module.load_state_dict(cpu_task.module.state_dict())
    gpu_task.module.to(dev)
    saved, taco2ar.PRENET_DROPOUT = taco2ar.PRENET_DROPOUT, 0.0
    try:
        want, _ = cpu_task.loss_and_cache(hs, h_lens, batch, None, True)
        got, _ = gpu_task.loss_and_cache(hs.to(dev), h_lens.to(dev), batch, None, True)
        want.backward()
        got.backward()
    finally:
        taco2ar.PRENET_DROPOUT = saved
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-4)
    for (name, a), b in zip(gpu_task.module.named_parameters(), cpu_task.module.parameters()):
        if a.grad is None:
            continue
        x, y = a.grad.double().cpu().flatten(), b.grad.double().flatten()
        assert float(x @ y / (x.norm() * y.norm())) > 0.9999 or x.norm() == y.norm() == 0, name


@pytest.mark.parametrize("entry,dtype,launches", [
    ("wav2vec2_conformer_relpos", torch.bfloat16, {0: 1}),
    ("wav2vec2_conformer_rope", torch.float32, {0: 1}),
    ("espnet_hubert_large_gs_ll60k", torch.bfloat16, {0: 1, 3: 2, 4: 2})])
def test_zoo_trunks_on_the_card(dev, monkeypatch, entry, dtype, launches):
    """The Conformer entries (K3 once, their layers on stock ops) and
    ESPnet HuBERT-Large with flash=True (K3 once, K4 and K5 once a layer),
    their configurations cut to two layers at C 128 (head dim 64; conv0
    keeps the kernel's 512 channels): the launches of one forward (`launches`
    by wrappers() index, every other count 0) and the card against the CPU
    at per-layer cosine > 0.999 over the valid frames."""
    import dataclasses

    import s3prl_tpu_torch.upstream.registry as registry
    from s3prl_tpu_torch import hub

    tiny = dict(conv_feature_layers=TINY_LAYERS, encoder_layers=2, encoder_embed_dim=128,
                encoder_ffn_embed_dim=256, encoder_attention_heads=2)
    monkeypatch.setattr(registry, "CONFORMER_BASE",
                        dataclasses.replace(registry.CONFORMER_BASE, **tiny))
    monkeypatch.setattr(registry, "LARGE", dataclasses.replace(registry.LARGE, conv_pos=16,
                                                               conv_pos_groups=4, **tiny))
    flash = entry.startswith("espnet")
    gpu = hub.load(entry, dtype=dtype, flash=flash, seed=3)
    cpu = hub.load(entry, dtype=dtype, flash=flash, seed=3, device="cpu")
    wavs, lens = _tiny_batch()
    for w in wrappers():
        w.launches = 0
    got, got_lens = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers()] == [launches.get(i, 0)
                                                for i in range(len(wrappers()))]
    want, h_lens = cpu.apply_standardized(wavs, lens)
    assert got_lens.tolist() == h_lens.tolist() and got.shape == want.shape
    for layer in range(got.shape[0]):
        a = torch.cat([got[layer, b, :n].float().cpu() for b, n in enumerate(h_lens.tolist())])
        b = torch.cat([want[layer, b, :n].float() for b, n in enumerate(h_lens.tolist())])
        cos = float((a.double() * b.double()).sum() / (a.double().norm() * b.double().norm()))
        assert cos > 0.999, (layer, cos)


@pytest.mark.parametrize("entry,dtype", [
    ("wav2vec", torch.float32), ("vq_wav2vec", torch.float32),
    ("vq_wav2vec_kmeans", torch.float32), ("cpc", torch.float32),
    ("decoar_layers", torch.float32), ("decoar2", torch.bfloat16), ("byol_a", torch.float32),
    ("byol_s_resnetish34", torch.float32), ("byol_s_cvt", torch.float32), ("example", None)])
def test_conv_recurrent_windowed_zoo_on_the_card(dev, monkeypatch, entry, dtype):
    """wav2vec 1.0 / vq-wav2vec, CPC, DeCoAR, DeCoAR 2.0, BYOL-A / BYOL-S and
    example (their configurations cut: three extractor and aggregator convs
    at 512, DeCoAR at hidden 64, DeCoAR 2.0 at two layers, BYOL's windows at
    0.2 s) from one seed on the card and on the CPU: no kernel launched, the
    lengths equal, per-layer cosine > 0.999 over the valid frames, and
    vq-wav2vec's codes equal on at least 99.5% of the valid frames (a
    random codebook's near-ties move with z's last bits; where a code moves
    the aggregator's states take another codeword: > 0.99 there)."""
    import dataclasses

    import s3prl_tpu_torch.upstream.registry as registry
    from s3prl_tpu_torch import hub

    w2v1 = dict(conv_feature_layers=((512, 10, 5), (512, 8, 4), (512, 4, 2)),
                conv_aggregator_layers=((512, 2, 1), (512, 3, 1), (512, 4, 1)))
    for name in ("W2V1", "VQ_WAV2VEC", "VQ_WAV2VEC_KMEANS"):
        monkeypatch.setattr(registry, name, dataclasses.replace(getattr(registry, name), **w2v1))
    monkeypatch.setattr(registry, "DECOAR", dataclasses.replace(registry.DECOAR, hidden=64))
    monkeypatch.setattr(registry, "DECOAR2", dataclasses.replace(registry.DECOAR2, num_layers=2))
    for name in ("BYOL_A_2048", "BYOL_S_RESNETISH34", "BYOL_S_CVT"):
        cfg = getattr(registry, name)
        monkeypatch.setattr(registry, name, dataclasses.replace(
            cfg, window_secs=0.2, stride_secs=min(cfg.stride_secs, 0.2)))
    kw = {} if dtype is None else {"dtype": dtype, "seed": 3}
    gpu = hub.load(entry, **kw)
    cpu = hub.load(entry, device="cpu", **kw)
    wavs, lens = _tiny_batch()
    for w in wrappers():
        w.launches = 0
    got, got_lens = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers()] == [0] * len(wrappers())
    want, h_lens = cpu.apply_standardized(wavs, lens)
    assert got_lens.tolist() == h_lens.tolist() and got.shape == want.shape
    for layer in range(got.shape[0]):
        a = torch.cat([got[layer, b, :n].float().cpu() for b, n in enumerate(h_lens.tolist())])
        b = torch.cat([want[layer, b, :n].float() for b, n in enumerate(h_lens.tolist())])
        cos = float((a.double() * b.double()).sum() / (a.double().norm() * b.double().norm()))
        assert cos > (0.99 if entry.startswith("vq_") and layer > 0 else 0.999), (layer, cos)
    if entry.startswith("vq_"):
        with torch.inference_mode():
            _, feat_lens, codes = gpu.model(wavs.to(dev), lens.to(dev), return_code_ids=True)
            _, _, codes_cpu = cpu.model(wavs, lens, return_code_ids=True)
        valid = torch.arange(codes_cpu.shape[1])[None] < feat_lens.cpu()[:, None]
        assert float((codes.cpu() == codes_cpu)[valid].float().mean()) >= 0.995


def _valid_cosines(got, want, h_lens):
    """Per-layer cosine of card and CPU states over the valid frames."""
    out = []
    for layer in range(got.shape[0]):
        a = torch.cat([got[layer, b, :n].double().cpu() for b, n in enumerate(h_lens)])
        b = torch.cat([want[layer, b, :n].double() for b, n in enumerate(h_lens)])
        out.append(float((a * b).sum() / (a.norm() * b.norm())))
    return out


@pytest.mark.parametrize("entry,dtype,launches", [
    ("ast", torch.float32, {}), ("ssast_frame_base", torch.bfloat16, {}),
    ("passt_hop100base2lvlmel", torch.float32, {}), ("vggish", None, {}),
    ("discretebert", None, {}), ("pase_plus", torch.float32, {}), ("spec_augment", None, {}),
    ("hf_wav2vec2", None, {"conv0_ln_gelu": 1})])
def test_rest_of_the_zoo_on_the_card(dev, monkeypatch, entry, dtype, launches):
    """The AST family and PaSST (cut to two blocks), VGGish, the
    vq-wav2vec -> RoBERTa pipeline, PASE+, SpecAugment and hf_wav2vec2 from
    one seed on the card and on the CPU: the launches (K3 once on the HF
    entry, none elsewhere), the lengths equal, per-layer cosine > 0.999 over
    the valid frames (0.99 for RoBERTa's states, whose tokens come from
    k-means codes equal on at least 99.5% of the frames); SpecAugment's
    train mode on the card masks within its bands and leaves every other
    value as eval mode's."""
    import dataclasses

    import s3prl_tpu_torch.upstream.registry as registry
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.nn import specaug

    for name in ("SSAST_PATCH", "SSAST_FRAME"):
        monkeypatch.setattr(registry, name, dataclasses.replace(getattr(registry, name), depth=2))
    for name, cfg in registry.PASST_ENTRIES.items():
        monkeypatch.setitem(registry.PASST_ENTRIES, name, dataclasses.replace(cfg, depth=2))
    kw = {} if dtype is None else {"dtype": dtype}
    gpu = hub.load(entry, seed=3, **kw)
    cpu = hub.load(entry, seed=3, device="cpu", **kw)
    rng = np.random.RandomState(7)
    lens = torch.tensor([24000, 16001, 801])
    wavs = torch.from_numpy(rng.randn(3, 24000).astype(np.float32)) * (
        torch.arange(24000)[None] < lens[:, None])
    for w in wrappers():
        w.launches = 0
    got, got_lens = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert {w.__name__: w.launches for w in wrappers() if w.launches} == launches
    want, h_lens = cpu.apply_standardized(wavs, lens)
    assert got_lens.tolist() == h_lens.tolist() and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    bar = 0.999
    if entry == "discretebert":
        with torch.inference_mode():
            _, n, codes = gpu.model.w2v(wavs.to(dev), lens.to(dev), return_code_ids=True)
            _, _, codes_cpu = cpu.model.w2v(wavs, lens, return_code_ids=True)
        valid = torch.arange(codes_cpu.shape[1])[None] < n.cpu()[:, None]
        assert float((codes.cpu() == codes_cpu)[valid].float().mean()) >= 0.995
        bar = 0.99
    assert min(_valid_cosines(got, want, h_lens.tolist())) > bar
    if entry == "spec_augment":
        model = gpu.model.train()
        gen = torch.Generator(device=dev).manual_seed(5)
        with torch.inference_mode():
            masked, feat_lens = model(wavs.to(dev), lens.to(dev), generator=gen)
            plain, _ = model.eval()(wavs.to(dev), lens.to(dev))
        B, T, D = plain.shape[1:]
        gen = torch.Generator(device=dev).manual_seed(5)
        fb, tb = specaug.draw_bands(gen, B, D, 2, 27), specaug.draw_bands(gen, B, T, 2, 100)
        assert int(fb[1].max()) <= 27 and int(tb[1].max()) <= 100
        assert torch.equal(masked[0], specaug.mask_bands(plain[0], feat_lens, fb, tb))


@pytest.mark.parametrize("activation", ["relu", "swish"])
def test_swish_trunk_on_the_card(dev, activation):
    """A pre-LN trunk (two layers at 128 wide, head dim 64) with
    activation_fn relu / swish in int8 serving (bf16, flash, quantize): K3
    once and K7 once a layer, none of K1, K2, K4, K5 or K12; per-layer
    cosine > 0.999 against the same model on the CPU."""
    import dataclasses

    import s3prl_tpu_torch.upstream.registry as registry

    cfg = dataclasses.replace(registry.HUBERT_LARGE, encoder_layers=2, encoder_embed_dim=128,
                              encoder_ffn_embed_dim=256, encoder_attention_heads=2, conv_pos=16,
                              conv_pos_groups=4, activation_fn=activation)
    gpu = registry._trunk_upstream("trunk", cfg, torch.bfloat16, flash=True, quantize=True,
                                   seed=3)
    cpu = registry._trunk_upstream("trunk", cfg, torch.bfloat16, flash=True, quantize=True,
                                   seed=3, device="cpu")
    wavs, lens = _tiny_batch()
    for w in wrappers():
        w.launches = 0
    got, got_lens = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert {w.__name__: w.launches for w in wrappers() if w.launches} == {
        "conv0_ln_gelu": 1, "fused_qkv_attention": 2}
    want, h_lens = cpu.apply_standardized(wavs, lens)
    assert got_lens.tolist() == h_lens.tolist()
    assert min(_valid_cosines(got, want, h_lens.tolist())) > 0.999


def test_data2vec_pretrain_step_on_the_card(dev, monkeypatch):
    """A data2vec pretraining step of a tiny layer-norm trunk (conv0 at the
    kernel's 512 channels, the depth-5 pos-conv stack, two post-LN layers)
    on the card: K3 launched once, in the EMA teacher, under no_grad; the
    loss and every gradient against the same step on the CPU (the same span
    mask, drawn on the CPU); then the teacher moved by `post_update` toward
    a perturbed student: its K3 output on the card follows the moved
    weights (the plain version's on them at atol 1e-4, away from the old
    weights' output)."""
    import s3prl_tpu_torch.task.data2vec_pretrain as d2v
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
    from s3prl_tpu_torch.ops.masking import compute_mask_indices

    cfg = Wav2Vec2Config(extractor_mode="layer_norm", conv_feature_layers=TINY_LAYERS,
                         encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
                         encoder_attention_heads=2, conv_pos=20, conv_pos_groups=4,
                         pos_conv_depth=5, layer_norm_first=False, normalize=True,
                         dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
                         post_extract_proj_always=True, feat_pad_rule="conv")
    cpu = d2v.Data2VecPretrainTask(Wav2Vec2Trunk(cfg), average_top_k_layers=2, ema_decay=0.9,
                                   mask_length=4)
    cpu.init_params(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu)
    gpu.module.to(dev)

    def mask(_, shape, pad, *a, device=None, **k):
        return compute_mask_indices(torch.Generator().manual_seed(1), shape, pad.cpu(), *a,
                                    **k).to(device)

    monkeypatch.setattr(d2v, "compute_mask_indices", mask)
    wavs, lens = _tiny_batch()
    wavs, lens = wavs[:2], lens[:2]
    batch = {"x": wavs.numpy(), "x_len": lens.numpy()}
    losses, grads = [], []
    for task, where in ((cpu, "cpu"), (gpu, dev)):
        for w in wrappers():
            w.launches = 0
        hs = torch.zeros(1, 2, wavs.shape[1], 1, device=where)
        loss, _ = task.loss_and_cache(hs, lens.to(where), batch, None, True)
        loss.backward()
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers()][:2] == ([0, 0] if where == "cpu" else [1, 0])
        assert sum(w.launches for w in wrappers()) == (where != "cpu")
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.cpu() for n, p in task.module.student.named_parameters()})
        assert all(p.grad is None for p in task.module.teacher.parameters())
    assert abs(losses[1] / losses[0] - 1) < 1e-4
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads[0].values())))
    for name, g in grads[0].items():
        if float(g.norm()) > 1e-5 * total:
            a, b = grads[1][name].double().flatten(), g.double().flatten()
            assert float(a @ b / (a.norm() * b.norm())) > 0.9999, name

    layer0 = gpu.module.teacher.feature_extractor.conv_layers[0]
    old = [t.detach().clone() for t in (layer0.conv.weight, layer0.norm.weight, layer0.norm.bias)]
    with torch.no_grad():
        student0 = gpu.module.student.feature_extractor.conv_layers[0].conv.weight
        student0.add_(0.05 * torch.randn_like(student0))
    gpu.post_update()
    assert not torch.equal(layer0.conv.weight, old[0])
    x = wavs.to(dev)
    with torch.no_grad():
        x = (x - x.mean(1, keepdim=True)) / x.std(1, keepdim=True)
        for w in wrappers():
            w.launches = 0
        got = conv0_ln_gelu(x, layer0.conv.weight, layer0.norm.weight, layer0.norm.bias)
        assert conv0_ln_gelu.launches == 1
        want = conv0_ln_gelu_reference(x, layer0.conv.weight, layer0.norm.weight,
                                       layer0.norm.bias)
        stale = conv0_ln_gelu_reference(x, *old)
        teacher_hs, _ = gpu.module.teacher(wavs.to(dev), lens.to(dev))
        assert conv0_ln_gelu.launches == 2  # the teacher's forward: its K3, on the moved weights
    assert float((got - want).abs().max()) <= 1e-4
    assert float((got - stale).abs().max()) > 1e-2
    assert bool(torch.isfinite(teacher_hs).all())


def test_dp2_probe_step_on_the_card(dev, tmp_path):
    """Two ranks sharing card 0 over gloo (NCCL refuses two ranks on one
    device), a Trainer at dp = 2 on the tiny int8 trunk: each rank's step
    launches K3 once and K1 and K2 once a layer on its two rows; the two
    steps' losses and the probe's weights equal one process's on the card
    on the global batch of four, its frozen upstream run on the ranks' two
    row groups (the stock bf16 ops pick algorithms by batch shape), losses
    at rtol 1e-4, weights at max abs 5e-4."""
    from s3prl_tpu_torch.parallel.distributed import spawn
    from torch_parallel_workers import card_dp_rank

    wavs, lens = _tiny_batch()
    batch = {"x": np.concatenate([wavs.numpy(), 0.5 * wavs.numpy()[:1]]),
             "x_len": np.concatenate([lens.numpy(), lens.numpy()[:1]]),
             "class_id": np.array([0, 3, 1, 2], np.int32)}
    one = card_dp_rank(batch, groups=2)
    assert one["dp"] == 1
    ranks = spawn(card_dp_rank, 2, batch, tmp_dir=str(tmp_path))
    for out in ranks:
        assert out["dp"] == 2
        for launches in out["launches"]:
            assert launches == [1, 2, 2] + [0] * (len(wrappers()) - 3)
        np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-4)
        for k, v in one["state"].items():
            assert float((out["state"][k] - v).abs().max()) <= 5e-4, k
