"""Length arithmetic and masks (port of s3prl_tpu/ops/masking.py), which
reproduces the reference's length rules (s3prl/nn/upstream.py:166-231), and
the span masks of wav2vec2-style pretraining (`compute_mask_indices`: its
draw, `draw_mask_uniforms`, apart from the rule that reads it,
`mask_indices_from_uniforms`, so a test can feed in JAX's draws)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.bool) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask, True on valid positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def lengths_after_conv1d(lengths: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Valid-length arithmetic for an unpadded strided conv."""
    return torch.clamp(torch.div(lengths - kernel, stride, rounding_mode="floor") + 1, min=0)


def upstream_feat_lengths(wav_lens: torch.Tensor, stride: int) -> torch.Tensor:
    """The reference's h_len rule: floor((wav_len - 1) / stride) + 1."""
    return torch.div(wav_lens - 1, stride, rounding_mode="floor") + 1


def expected_max_feat_len(max_wav_len: int, stride: int) -> int:
    """len(range(0, max_wav_len, stride))."""
    return -(-max_wav_len // stride)


def max_mask_spans(T: int, mask_prob: float, mask_length: int, min_masks: int = 2) -> int:
    """The static bound on the spans of a [B, T] mask (masking.py:85)."""
    return max(min_masks, int(mask_prob * T / mask_length) + 2)


def draw_mask_uniforms(generator: torch.Generator | None, B: int, T: int, mask_prob: float,
                       mask_length: int, min_masks: int = 2, device=None):
    """The uniforms `compute_mask_indices` reads, drawn from `generator`
    on `device` (the generator's when None): (round [B], starts [B, S]), S
    = `max_mask_spans`. The JAX package draws the same shapes from its key
    (masking.py:81-89), from another stream."""
    device = device if device is not None else (generator.device if generator else "cpu")
    S = max_mask_spans(T, mask_prob, mask_length, min_masks)
    rand_round = torch.rand(B, generator=generator, device=device)
    starts = torch.rand(B, S, generator=generator, device=device)
    return rand_round, starts


def mask_indices_from_uniforms(uniforms, shape, padding_mask: torch.Tensor | None,
                               mask_prob: float, mask_length: int,
                               min_masks: int = 2) -> torch.Tensor:
    """bool [B, T], True on masked frames, from the uniforms (round [B],
    starts [B, S]) (masking.py:52-93): a row of `valid` frames keeps the
    first ``floor(mask_prob * valid / mask_length + round)`` of its S
    candidate spans (at least `min_masks`, at most S), each starting at
    ``floor(u * max(valid - mask_length, 1))``; padding is never masked."""
    B, T = shape
    rand_round, u = uniforms
    device = u.device
    valid = (torch.full((B,), T, dtype=torch.int32, device=device) if padding_mask is None
             else (~padding_mask).sum(-1).to(torch.int32).to(device))
    S = u.shape[1]
    if S != max_mask_spans(T, mask_prob, mask_length, min_masks):
        raise ValueError(f"starts: {S} spans, the bound at T = {T} is "
                         f"{max_mask_spans(T, mask_prob, mask_length, min_masks)}")
    num_spans = (mask_prob * valid.float() / float(mask_length) + rand_round).to(torch.int32)
    num_spans = torch.clamp(num_spans, min=min_masks, max=S)
    span_room = torch.clamp(valid - mask_length, min=1)
    starts = (u * span_room[:, None].float()).to(torch.int64)
    keep = torch.arange(S, device=device)[None, :] < num_spans[:, None]
    t = torch.arange(T, device=device)[None, None, :]
    s = starts[:, :, None]
    hit = (t >= s) & (t < s + mask_length) & keep[:, :, None]
    return hit.any(dim=1) & (torch.arange(T, device=device)[None, :] < valid[:, None])


def compute_mask_indices(generator: torch.Generator | None, shape, padding_mask: torch.Tensor | None,
                         mask_prob: float, mask_length: int, min_masks: int = 2,
                         device=None) -> torch.Tensor:
    """Static-bound span masks of wav2vec2 / HuBERT pretraining (the JAX
    package's rule, not fairseq's numpy one): `draw_mask_uniforms`, then
    `mask_indices_from_uniforms`."""
    B, T = shape
    uniforms = draw_mask_uniforms(generator, B, T, mask_prob, mask_length, min_masks, device)
    return mask_indices_from_uniforms(uniforms, shape, padding_mask, mask_prob, mask_length,
                                      min_masks)
