"""Plain multi-head attention (port of s3prl_tpu/ops/attention.py):
`scaled_dot_attention` on [B, H, T, Dh] (the speech-translation decoder's,
Mockingjay's) and `attention_bthd` on heads-last [B, T, H, Dh] (the
Conformer's ESPnet attention without relative positions).

The JAX package's rules exactly: scores and softmax in f32, an additive
bias (the decoder's causal -1e9) added first, then ``key_padding_mask``
*replacing* the scores of padded keys with -1e9. A row with no valid key
therefore averages all its values uniformly, where
``F.scaled_dot_product_attention`` with a boolean mask gives NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large but finite: a row with every key masked stays finite


def scaled_dot_attention(
    q: torch.Tensor,  # [B, H, T, Dh], pre-scaled by Dh ** -0.5
    k: torch.Tensor,  # [B, H, S, Dh]
    v: torch.Tensor,  # [B, H, S, Dh]
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S], True = padding
    attn_bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, T, S]
) -> torch.Tensor:
    """Returns [B, H, T, Dh] in v's dtype."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :], NEG_INF, scores)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype), v)


def attention_bthd(
    q: torch.Tensor,  # [B, T, H, Dh], pre-scaled by Dh ** -0.5
    k: torch.Tensor,  # [B, S, H, Dh]
    v: torch.Tensor,  # [B, S, H, Dh]
    key_padding_mask: Optional[torch.Tensor] = None,  # [B, S], True = padding
) -> torch.Tensor:
    """`scaled_dot_attention` in the heads-last layout (attention.py:40-62):
    returns [B, T, H, Dh] in v's dtype."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask[:, None, None, :], NEG_INF, scores)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
