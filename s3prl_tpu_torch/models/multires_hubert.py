"""MR-HuBERT (port of s3prl_tpu/models/multires_hubert.py): the hourglass
(U-net) multi-resolution HuBERT.

Conv features -> f32 LayerNorm -> projection -> ``encoders.{i}`` (a post-LN
transformer, the pos-conv on the first only), each followed by a
down-sampling module; the ``middle_encoder`` (no pos-conv when there is a
rate pair) in a residual, x + middle(x), its input zeroed on padded frames
first as the reference's encoder zeroes it in place; then up-sampling
modules, each followed by ``decoders.{i}`` (no pos-conv) and the aligned
residual add of the matching encoder's output (multires_hubert.py:203-308).

The resampling modules (`ConvAdapter`, or the plain `ConvDownsampler` /
`ConvUpsampler` halves) are conv / transposed conv -> GroupNorm(1, C) over
every frame and channel, padded frames included (f32, variance E[x^2] -
E[x]^2 as flax's) -> erf GELU, with residuals scaled by sqrt(0.4).

The hidden states follow the expert's hooks: for each block, every layer
input and the block's output, repeated along time to the finest rate and
trimmed to the shortest. Stock ops only (the group-norm extractor and
post-LN layers without ``use_flash``), as in the JAX package. The module
names follow the reference's state_dict keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import dropout
from .convfe import DEFAULT_CONV_LAYERS, ConvFeatureExtractor
from .transformer import TransformerEncoder
from .wav2vec2 import normalize_wavs


@dataclass(frozen=True)
class MultiresHubertConfig:
    """The field names and defaults of s3prl_tpu.models.multires_hubert.MultiresHubertConfig."""

    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "default"
    conv_bias: bool = False
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # [u1, d1, u2, d2, ...]: (numerator, denominator) rate changes
    label_rate_ratios: Tuple[int, ...] = (1, 2)
    encoder_layers: int = 2  # layers a U-net block
    override_encoder_layers: Tuple[int, ...] = ()  # per block, 2 * n_pairs + 1 entries
    conv_adapator_kernal: int = 7
    use_plain_updownsample: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    normalize: bool = False

    @property
    def n_pairs(self) -> int:
        return len(self.label_rate_ratios) // 2

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        r = self.label_rate_ratios
        return tuple((r[2 * i], r[2 * i + 1]) for i in range(self.n_pairs))

    @property
    def block_layers(self) -> Tuple[int, ...]:
        """Layers of each block: encoders, middle, decoders."""
        if self.override_encoder_layers:
            if len(self.override_encoder_layers) != 2 * self.n_pairs + 1:
                raise ValueError(f"override_encoder_layers {self.override_encoder_layers}: "
                                 f"{2 * self.n_pairs + 1} blocks")
            return tuple(self.override_encoder_layers)
        return (self.encoder_layers,) * (2 * self.n_pairs + 1)

    @property
    def num_hidden_states(self) -> int:
        return sum(n + 1 for n in self.block_layers)


def _repeat_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    """x [B, T, C] with each frame repeated `factor` times."""
    return x if factor == 1 else x.repeat_interleave(factor, dim=1)


class GNConv(nn.Sequential):
    """Conv (or transposed conv) -> GroupNorm(1, C) -> erf GELU, no bias,
    in the reference's Sequential(conv, dropout, norm) indices, so the keys
    read ``0.weight`` and ``2.{weight,bias}``. The transposed conv is
    torch's ConvTranspose1d with padding 0 and stride - 1 trailing zero
    frames (``output_padding``); the conv pads (k - 1) // 2 on each side."""

    def __init__(self, channels: int, kernel: int, stride: int, transpose: bool = False,
                 device=None):
        conv = (nn.ConvTranspose1d(channels, channels, kernel, stride, bias=False,
                                   device=device) if transpose else
                nn.Conv1d(channels, channels, kernel, stride, padding=(kernel - 1) // 2,
                          bias=False, device=device))
        super().__init__(conv, nn.Identity(), nn.GroupNorm(1, channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        conv, norm = self[0], self[2]
        w = conv.weight.to(x.dtype)
        if isinstance(conv, nn.ConvTranspose1d):
            s = conv.stride[0]
            y = F.pad(F.conv_transpose1d(x.transpose(1, 2), w, stride=s), (0, s - 1))
        else:
            y = F.conv1d(x.transpose(1, 2), w, stride=conv.stride, padding=conv.padding)
        h = y.float()
        mean = h.mean((1, 2), keepdim=True)
        var = (h.square().mean((1, 2), keepdim=True) - mean.square()).clamp_min(0.0)
        h = (h - mean) * (torch.rsqrt(var + norm.eps) * norm.weight[:, None]) + norm.bias[:, None]
        return F.gelu(h.to(x.dtype)).transpose(1, 2)


class ConvAdapter(nn.Module):
    """Up-then-down rational resampler (multires_hubert.py:116-145): the
    ``upsample_conv`` (stride `up`) plus the repeated input, the
    ``downsample_conv`` (stride `down`) plus the decimated sum, then the
    highway residual, each sum scaled by sqrt(0.4)."""

    scale = 0.4 ** 0.5

    def __init__(self, channels: int, kernel: int, up: int, down: int, device=None):
        super().__init__()
        self.up, self.down = up, down
        self.upsample_conv = GNConv(channels, kernel, up, transpose=True, device=device)
        self.downsample_conv = GNConv(channels, kernel, down, device=device)

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        up = self.upsample_conv(x)
        res_up = _repeat_time(x, self.up)
        t = min(up.shape[1], res_up.shape[1])
        up = (up[:, :t] + res_up[:, :t]) * self.scale
        down = self.downsample_conv(up)
        res_down = up[:, ::self.down]
        t = min(down.shape[1], res_down.shape[1])
        y = (down[:, :t] + res_down[:, :t]) * self.scale
        res_hw = res_up[:, ::self.down]
        t = min(y.shape[1], res_hw.shape[1])
        y = (y[:, :t] + res_hw[:, :t]) * self.scale
        lens = -(-(lens * self.up) // self.down)
        return y, torch.clamp(lens, max=y.shape[1])


class ConvDownsampler(nn.Module):
    """The plain down-sampling half (multires_hubert.py:148-165)."""

    def __init__(self, channels: int, kernel: int, down: int, device=None):
        super().__init__()
        self.down = down
        self.downsample_conv = GNConv(channels, kernel, down, device=device)

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        down = self.downsample_conv(x)
        res = x[:, ::self.down]
        t = min(down.shape[1], res.shape[1])
        y = (down[:, :t] + res[:, :t]) * ConvAdapter.scale
        return y, torch.clamp(-(-lens // self.down), max=y.shape[1])


class ConvUpsampler(nn.Module):
    """The plain up-sampling half (multires_hubert.py:168-185)."""

    def __init__(self, channels: int, kernel: int, up: int, device=None):
        super().__init__()
        self.up = up
        self.upsample_conv = GNConv(channels, kernel, up, transpose=True, device=device)

    def forward(self, x: torch.Tensor, lens: torch.Tensor):
        upd = self.upsample_conv(x)
        res = _repeat_time(x, self.up)
        t = min(upd.shape[1], res.shape[1])
        y = (upd[:, :t] + res[:, :t]) * ConvAdapter.scale
        return y, torch.clamp(lens * self.up, max=y.shape[1])


class MultiresHubertModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (hidden states [num_hidden_states, B,
    T', C] at the finest rate, their lengths [B]). Matrix and conv weights
    in `dtype`, biases and norms in f32. In train mode the dropouts (the
    projected features', ``dropout_input``, then each encoder's) draw from
    the forward's generator."""

    def __init__(self, cfg: MultiresHubertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        C, k, n = cfg.encoder_embed_dim, cfg.conv_adapator_kernal, cfg.n_pairs
        self.feature_extractor = ConvFeatureExtractor(cfg.conv_feature_layers, cfg.extractor_mode,
                                                      cfg.conv_bias, dtype, device=device)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed, device=device)
        self.post_extract_proj = nn.Linear(embed, C, device=device) if embed != C else None

        def encoder(layers, pos_conv):
            return TransformerEncoder(
                C, cfg.encoder_ffn_embed_dim, layers, cfg.encoder_attention_heads,
                cfg.layer_norm_first, cfg.conv_pos, cfg.conv_pos_groups, dtype, device=device,
                dropout=cfg.dropout, activation_dropout=cfg.activation_dropout,
                use_pos_conv=pos_conv, activation=cfg.activation_fn)

        blocks = cfg.block_layers
        self.encoders = nn.ModuleList([encoder(blocks[i], i == 0) for i in range(n)])
        self.middle_encoder = encoder(blocks[n], n == 0)
        self.decoders = nn.ModuleList([encoder(blocks[n + 1 + i], False) for i in range(n)])
        if cfg.use_plain_updownsample:
            if any(u != 1 for u, _ in cfg.pairs):
                raise ValueError("the plain down-sampler needs unit numerators, got "
                                 f"{cfg.label_rate_ratios}")
            self.downsample_modules = nn.ModuleList(
                [ConvDownsampler(C, k, d, device=device) for _, d in cfg.pairs])
            self.upsample_modules = nn.ModuleList(
                [ConvUpsampler(C, k, d, device=device) for _, d in cfg.pairs])
        else:  # upsample module i reverses pair i
            self.downsample_modules = nn.ModuleList(
                [ConvAdapter(C, k, u, d, device=device) for u, d in cfg.pairs])
            self.upsample_modules = nn.ModuleList(
                [ConvAdapter(C, k, d, u, device=device) for u, d in cfg.pairs])
        for m in [self.post_extract_proj, *self.downsample_modules.modules(),
                  *self.upsample_modules.modules()]:
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
                m.weight.data = m.weight.data.to(dtype)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        cfg = self.cfg
        if cfg.normalize:
            wavs = normalize_wavs(wavs, wav_lens)
        feat = self.feature_extractor(wavs)
        t_feat = feat.shape[1]
        r = max(wavs.shape[1] // max(t_feat, 1), 1)  # HuBERT's block rule
        lens = torch.clamp(torch.div(wav_lens + r - 1, r, rounding_mode="floor"), max=t_feat)
        x = F.layer_norm(feat.float(), self.layer_norm.normalized_shape, self.layer_norm.weight,
                         self.layer_norm.bias, eps=1e-5).to(self.dtype)
        if self.post_extract_proj is not None:
            proj = self.post_extract_proj
            x = F.linear(x, proj.weight, proj.bias.to(self.dtype))
        x = dropout(x, cfg.dropout_input, self.training, generator)
        n = cfg.n_pairs
        factors = [1]  # each resolution's repeat factor back to the finest
        for u, d in cfg.pairs:
            factors.append(factors[-1] * d // u)
        states, residuals = [], []  # (hidden states [L + 1, B, T_i, C], factor)
        for i in range(n):
            hs = self.encoders[i](x, lens, generator=generator)
            x = hs[-1]
            states.append((hs, factors[i]))
            residuals.append((x, lens))
            x, lens = self.downsample_modules[i](x, lens)
        pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lens[:, None]
        x = x.masked_fill(pad[..., None], 0.0)
        hs = self.middle_encoder(x, lens, generator=generator)
        states.append((hs, factors[-1]))
        x = x + hs[-1]
        for i in range(n):
            x, lens = self.upsample_modules[i](x, lens)
            hs = self.decoders[i](x, lens, generator=generator)
            x = hs[-1]
            states.append((hs, factors[n - 1 - i]))
            res_x, res_lens = residuals[n - 1 - i]
            common = min(x.shape[1], res_x.shape[1])
            x = x[:, :common] + res_x[:, :common]
            lens = torch.clamp(torch.minimum(lens, res_lens), max=common)
        upsampled = [_repeat_time(h, f) for hs, f in states for h in hs]
        t_min = min(h.shape[1] for h in upsampled)
        return torch.stack([h[:, :t_min] for h in upsampled]), torch.clamp(lens, max=t_min)
