"""Transformer encoder with convolutional positional embedding (port of
s3prl_tpu/models/transformer.py, pre-LN blocks).

Per-layer hidden states come back as the stack of every layer's input plus
the final LayerNorm's output, [L+1, B, T, C] (transformer.py:743-789).

Routing of a pre-LN `EncoderLayer` (transformer.py:496-557): a bf16 layer
built with ``use_flash`` whose input the fused kernels can serve (CUDA, see
`_fused_block_available`) runs the whole attention block through
`fused_attention_block_bf16` and the whole FFN block through
`fused_bf16_ffn`; every other case runs the plain module path below. On the
card, T > MAX_BLOCK_T (the long-utterance kernels K7/K8) and flash attention
outside the bf16 block path (K7) are not ported yet and raise.

Matrix weights live in the model dtype, biases and norms in f32, as the JAX
package casts them at use. f32 matmuls on the card need
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) to
match the JAX package's full-f32 products.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ffn import fused_bf16_ffn
from ..kernels.flash_attention import MAX_BLOCK_T, fused_attention_block_bf16


def _fused_block_available(x: torch.Tensor) -> bool:
    """The fused serving kernels run for CUDA tensors (the JAX package's
    `_fused_block_available` checks for a TPU). Tests patch this to send CPU
    tensors through the kernel wrappers, whose plain versions then run."""
    return x.is_cuda


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """f32 LayerNorm cast back to x.dtype (nn.LayerNorm(dtype=f32) then astype)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight, layer.bias.to(x.dtype))


class ConvPositionalEmbedding(nn.Sequential):
    """Grouped conv positional embedding, depth 1 (transformer.py:32): conv
    (k=128, 16 groups, pad k//2) -> drop the last frame (even k) -> GELU.
    The conv sits at index 0 as in fairseq's Sequential(conv, SamePad,
    GELU), so the keys read ``pos_conv.0.{weight,bias}``; checkpoints with
    weight norm are folded into the plain weight before loading."""

    def __init__(self, features: int, kernel_size: int = 128, groups: int = 16,
                 device=None):
        super().__init__(nn.Conv1d(features, features, kernel_size,
                                   padding=kernel_size // 2, groups=groups,
                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        conv = self[0]
        y = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias.to(x.dtype),
                     padding=conv.padding, groups=conv.groups)
        if conv.kernel_size[0] % 2 == 0:
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    """Multi-head self-attention with one fused QKV projection.

    The fused weight `qkv_weight` [3C, C] (q, k, v rows stacked, nn.Linear
    layout) is what the kernels read; `state_dict()` and `load_state_dict()`
    speak fairseq's ``{q,k,v}_proj.{weight,bias}`` keys."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.qkv_bias = nn.Parameter(torch.empty(3 * embed_dim, device=device))
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, w, b in zip("qkv", self.qkv_weight.chunk(3), self.qkv_bias.chunk(3)):
            destination[f"{prefix}{name}_proj.weight"] = w if keep_vars else w.detach()
            destination[f"{prefix}{name}_proj.bias"] = b if keep_vars else b.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        for kind in ("weight", "bias"):
            keys = [f"{prefix}{n}_proj.{kind}" for n in "qkv"]
            if all(k in state_dict for k in keys):
                state_dict[f"{prefix}qkv_{kind}"] = torch.cat(
                    [state_dict.pop(k) for k in keys])
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """Plain path (transformer.py:186-200 with attention_bthd): x [B, T, C]
        in the model dtype, pad_mask [B, T] True on padded keys."""
        B, T, C = x.shape
        H = self.num_heads
        Dh = C // H
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias.to(x.dtype))
        q, k, v = qkv.view(B, T, 3, H, Dh).unbind(2)
        q = q * Dh ** -0.5
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        scores = scores.masked_fill(pad_mask[:, None, None, :], -1e9)
        probs = scores.softmax(-1).to(v.dtype)
        out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, C)
        return _linear(out, self.out_proj)


class EncoderLayer(nn.Module):
    """Pre-LN transformer block (wav2vec2_model.py:3214, layer_norm_first).
    The post-LN order (HuBERT-Base) is a later slice (ROADMAP.md Queue 1
    item 5)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 layer_norm_eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype = dtype
        self.use_flash = use_flash
        self.num_heads = num_heads
        self.self_attn = SelfAttention(embed_dim, num_heads, device=device)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, device=device)
        self.fc1 = nn.Linear(embed_dim, ffn_dim, device=device)
        self.fc2 = nn.Linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, device=device)
        for p in (self.self_attn.qkv_weight, self.self_attn.out_proj.weight,
                  self.fc1.weight, self.fc2.weight):
            p.data = p.data.to(dtype)

    def forward(self, x: torch.Tensor, kv_lens: torch.Tensor,
                pad_mask: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] in the model dtype; kv_lens [B] int32 valid frames;
        pad_mask [B, T] True on padded frames."""
        attn, ln1, ln2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
        fused = (
            self.dtype == torch.bfloat16 and self.use_flash
            and ln1.eps == 1e-5 and _fused_block_available(x)
        )
        if fused:
            if x.shape[1] > MAX_BLOCK_T:
                raise NotImplementedError(
                    f"T={x.shape[1]} > {MAX_BLOCK_T} frames needs the long-utterance "
                    "attention kernels (K7 fused_qkv_attention, K8 "
                    "online_flash_attention), not ported yet "
                    "(ROADMAP.md Queue 2)")
            x = fused_attention_block_bf16(
                x, attn.qkv_weight, attn.qkv_bias, (ln1.weight, ln1.bias),
                attn.out_proj.weight, attn.out_proj.bias, kv_lens, self.num_heads)
        else:
            if self.use_flash and x.is_cuda:
                raise NotImplementedError(
                    "flash attention outside the bf16 whole-block path runs K7 "
                    "(fused_qkv_attention), not ported yet "
                    "(ROADMAP.md Queue 2)")
            x = x + attn(_layer_norm(x, ln1), pad_mask)
        if fused and self.fc1.out_features % 128 == 0:
            return fused_bf16_ffn(x, self.fc1.weight, self.fc1.bias, self.fc2.weight,
                                  self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        h = F.gelu(_linear(_layer_norm(x, ln2), self.fc1))
        return x + _linear(h, self.fc2)


class TransformerEncoder(nn.Module):
    """Pre-LN encoder stack returning [L+1, B, T, C]: the input of every
    layer, then the final LayerNorm's output (transformer.py:671)."""

    def __init__(self, embed_dim: int = 1024, ffn_dim: int = 4096, num_layers: int = 24,
                 num_heads: int = 16, layer_norm_first: bool = True, conv_pos: int = 128,
                 conv_pos_groups: int = 16, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, device=None):
        super().__init__()
        if not layer_norm_first:
            raise NotImplementedError(
                "post-LN encoder (HuBERT-Base) is a later slice "
                "(ROADMAP.md Queue 1 item 5)")
        self.pos_conv = ConvPositionalEmbedding(embed_dim, conv_pos, conv_pos_groups,
                                                device=device)
        self.pos_conv[0].weight.data = self.pos_conv[0].weight.data.to(dtype)
        self.layers = nn.ModuleList([
            EncoderLayer(embed_dim, ffn_dim, num_heads, dtype, use_flash, device=device)
            for _ in range(num_layers)
        ])
        self.layer_norm = nn.LayerNorm(embed_dim, device=device)

    def forward(self, x: torch.Tensor, feat_lens: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] in the model dtype, feat_lens [B] valid frames ->
        hidden states [L+1, B, T, C]."""
        B, T, C = x.shape
        pad_mask = torch.arange(T, device=x.device)[None, :] >= feat_lens[:, None]
        kv_lens = torch.clamp(feat_lens, max=T).to(torch.int32)
        x = x.masked_fill(pad_mask[..., None], 0.0)
        x = x + self.pos_conv(x)
        hidden = x.new_empty(len(self.layers) + 1, B, T, C)
        for i, layer in enumerate(self.layers):
            hidden[i] = x
            x = layer(x, kv_lens, pad_mask)
        hidden[-1] = _layer_norm(x, self.layer_norm)
        return hidden
