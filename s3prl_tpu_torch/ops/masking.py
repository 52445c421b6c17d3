"""Length arithmetic and masks (port of s3prl_tpu/ops/masking.py:17-35),
which reproduces the reference's length rules (s3prl/nn/upstream.py:166-231)."""

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
