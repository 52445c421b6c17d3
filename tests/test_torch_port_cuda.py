"""CUDA kernels of s3prl_tpu_torch against their plain PyTorch versions on
the card (same CUDA inputs through both). Needs an NVIDIA GPU with nvcc;
skipped elsewhere. On the GPU machine (no jax there, so without the suite's
conftest):

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_port_cuda.py

Tolerances: f32 outputs at atol 1e-4 (sum order only); bf16 outputs at
cosine > 0.9995 and every element within max(3e-2, one bf16 step at the
plain value) of it (one step is 0.03125 where outputs reach |v| >= 4): the
kernel and the plain version sum in other orders, so a value near a
rounding boundary can land one step apart.
"""

import numpy as np
import pytest
import torch

from s3prl_tpu_torch.kernels import _common
from s3prl_tpu_torch.kernels.conv_frontend import (
    conv0_ln_gelu, conv0_ln_gelu_reference)
from s3prl_tpu_torch.kernels.ffn import fused_bf16_ffn, fused_bf16_ffn_reference
from s3prl_tpu_torch.kernels.flash_attention import (
    attention_reference, fused_attention_block_bf16,
    fused_attention_block_bf16_reference)

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


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layernorm_kernel(dev, src):
    rng = np.random.RandomState(2)
    x = _t(rng.randn(333, 1024) * 2 + 0.5, dev, src)
    g, b = _ln(rng, dev, 1024)
    got = _common.layer_norm(x, g, b)
    want = torch.nn.functional.layer_norm(x.float(), (1024,), g, b, eps=1e-5)
    _close_bf16(got, want.to(torch.bfloat16))


def test_attention_kernel_ragged(dev):
    """The attention launch alone at a ragged T with kv_len 1 and a full row."""
    rng = np.random.RandomState(3)
    B, T, H = 3, 131, 4
    qkv = _t(rng.randn(B, T, 3 * H * 64), dev, torch.bfloat16)
    kv = torch.tensor([131, 70, 1], dtype=torch.int32, device=dev)
    out = torch.empty(B * T, H * 64, dtype=torch.bfloat16, device=dev)
    from s3prl_tpu_torch.kernels._build import launch

    launch("s3_attention", qkv.data_ptr(), kv.data_ptr(), out.data_ptr(), B, T,
           H, 64 ** -0.5, _common.stream_of(qkv))
    want = attention_reference(qkv, kv, H)
    _close_bf16(out.view(B, T, -1), want)


@pytest.mark.parametrize("postnorm", [False, True], ids=["preln", "postnorm"])
@pytest.mark.parametrize("T", [499, 64])
def test_attention_block_kernel(dev, postnorm, T):
    rng = np.random.RandomState(4)
    B, C, H = 4, 256, 4
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


@pytest.mark.parametrize("ln,residual,postnorm", [
    (True, True, False), (False, False, False), (True, False, False),
    (False, True, False), (True, True, True)])
def test_ffn_kernel(dev, ln, residual, postnorm):
    rng = np.random.RandomState(5)
    B, T, C, F = 2, 123, 256, 1024
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


def _tiny_trunk_pair(dtype, flash, dev):
    """One seed's tiny HuBERT-Large-style trunk on the CPU and on the card
    (conv0 keeps the kernel's 512 channels; head dim 64)."""
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    cfg = Wav2Vec2Config(
        extractor_mode="layer_norm", conv_feature_layers=((512, 10, 5), (64, 3, 2), (64, 2, 2)),
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4,
        layer_norm_first=True, normalize=True)
    return [_trunk_upstream("tiny", cfg, dtype=dtype, flash=flash, seed=3, device=d)
            for d in ("cpu", dev)]


def _tiny_batch():
    rng = np.random.RandomState(6)
    lens = np.array([6400, 3001, 1])
    wavs = rng.randn(3, 6400).astype(np.float32) * (np.arange(6400) < lens[:, None])
    return torch.from_numpy(wavs), torch.from_numpy(lens)


def test_tiny_trunk_bf16_kernels_match_cpu(dev):
    """The module routing on the card (K3 + K4 + K5 launches) against the
    same seed's model on the CPU (plain module path): per-layer cosine >
    0.999 over the valid frames of all utterances, the JAX package's bar for
    bf16 paths (a length-1 utterance's early layers are exactly 0 on both
    sides under zero-initialised biases)."""
    from s3prl_tpu_torch.kernels import wrappers

    cpu, gpu = _tiny_trunk_pair(torch.bfloat16, True, dev)
    wavs, lens = _tiny_batch()
    for w in wrappers():
        w.launches = 0
    hs_gpu, hl_gpu = gpu.apply_standardized(wavs.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers()] == [1, 2, 2]
    hs_cpu, hl_cpu = cpu.apply_standardized(wavs, lens)
    assert hl_gpu.tolist() == hl_cpu.tolist()
    valid = [(b, n) for b, n in enumerate(hl_cpu.tolist())]
    for layer in range(hs_cpu.shape[0]):  # cosine over every utterance's valid frames
        a = torch.cat([hs_gpu[layer, b, :n].cpu() for b, n in valid]).double().flatten()
        c = torch.cat([hs_cpu[layer, b, :n] for b, n in valid]).double().flatten()
        assert float(a @ c / (a.norm() * c.norm())) > 0.999, layer


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
