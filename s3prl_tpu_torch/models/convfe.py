"""Strided conv waveform feature extractor, layer-norm mode (port of
s3prl_tpu/models/convfe.py:180, the wav2vec2/HuBERT *-Large front end).

Each layer is an unpadded strided Conv1d -> LayerNorm over channels (f32) ->
GELU, on [B, T, C] activations (the JAX package's layout). Layer 0 (C_in=1,
k=10, s=5, no bias) goes through the `conv0_ln_gelu` kernel; the mid convs
are stock `F.conv1d`, as the JAX package leaves them to XLA. GELU is exact,
except in int8 serving (``quantize``), which runs the tanh approximation in
the kernel and in the mid layers (convfe.py:275-289, :344).

On the card, f32 convolutions would run in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the f32 path assumes the
caller has turned it off (``chip_smoke.py`` does), as the JAX package runs
them in full f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.conv_frontend import conv0_ln_gelu

# (dim, kernel, stride) stack shared by wav2vec2/HuBERT: total stride 320
DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


def total_stride(conv_layers=DEFAULT_CONV_LAYERS) -> int:
    out = 1
    for _, _, s in conv_layers:
        out *= s
    return out


class ConvLayer(nn.Sequential):
    """Conv1d -> LayerNorm -> GELU. The module indices follow fairseq's
    Sequential(Conv1d, Dropout, Sequential(TransposeLast, Fp32LayerNorm,
    TransposeLast), GELU), so the keys read ``0.weight`` and
    ``2.1.{weight,bias}``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, device=None):
        super().__init__(
            nn.Conv1d(c_in, c_out, k, stride, bias=False, device=device),
            nn.Identity(),
            nn.Sequential(nn.Identity(), nn.LayerNorm(c_out, device=device)),
        )

    @property
    def conv(self) -> nn.Conv1d:
        return self[0]

    @property
    def norm(self) -> nn.LayerNorm:
        return self[2][1]

    def forward(self, x: torch.Tensor, gelu_mode: str = "erf") -> torch.Tensor:
        """x [B, T, C_in] -> [B, T', C_out]; the f32 LN is cast to x.dtype
        before the GELU (``approximate`` "none" for erf, "tanh")."""
        conv = self.conv
        y = F.conv1d(x.transpose(1, 2), conv.weight, stride=conv.stride)
        y = F.layer_norm(y.transpose(1, 2).float(), (y.shape[1],),
                         self.norm.weight, self.norm.bias, eps=1e-5)
        return F.gelu(y.to(x.dtype), approximate="tanh" if gelu_mode == "tanh" else "none")


class ConvFeatureExtractor(nn.Module):
    """wavs [B, T] -> features [B, T', C] (valid convs, total stride 320).

    Matrix weights live in `dtype`, norms in f32. Only ``mode="layer_norm"``
    without conv bias is ported; the group-norm ("default", HuBERT-Base)
    extractor and conv bias are later slices (ROADMAP.md Queue 1 item
    3)."""

    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]] = DEFAULT_CONV_LAYERS,
                 mode: str = "layer_norm", conv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, quantize: bool = False,
                 device=None):
        super().__init__()
        if mode != "layer_norm" or conv_bias:
            raise NotImplementedError(
                f"extractor mode {mode!r}, conv_bias={conv_bias}: only the "
                "bias-free 'layer_norm' extractor is ported "
                "(ROADMAP.md Queue 1 item 3)")
        self.dtype = dtype
        self.quantize = quantize
        layers, c_in = [], 1
        for dim, k, stride in conv_layers:
            layers.append(ConvLayer(c_in, dim, k, stride, device=device))
            c_in = dim
        self.conv_layers = nn.ModuleList(layers)
        for layer in self.conv_layers:
            layer.conv.weight.data = layer.conv.weight.data.to(dtype)

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        first, *rest = self.conv_layers
        # int8 serving runs tanh GELU (serving_tanh, convfe.py:275)
        gelu_mode = "tanh" if self.quantize and not self.training else "erf"
        # layer 0 through the fused kernel, as convfe.py:276-289 does in extraction
        x = conv0_ln_gelu(wavs.to(self.dtype), first.conv.weight, first.norm.weight,
                          first.norm.bias, stride=first.conv.stride[0],
                          k=first.conv.kernel_size[0], gelu_mode=gelu_mode)
        for layer in rest:
            x = layer(x, gelu_mode)
        return x
