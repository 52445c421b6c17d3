"""The upstream contract (port of s3prl_tpu/upstream/base.py).

An `Upstream` bundles a model returning (hidden_states [L, B, T', H],
feat_lens [B]) with its metadata; `apply_standardized` applies the
reference's length rules (s3prl/nn/upstream.py:166-231): a 0.05 s minimum
length, trim or repeat-last-frame to len(range(0, max_wav_len, stride)), and
h_len = floor((wav_len - 1) / stride) + 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masking import expected_max_feat_len, upstream_feat_lengths

MIN_SECOND = 0.05  # minimum supported audio length (nn/upstream.py:197-203)
SAMPLE_RATE = 16000


def match_length_stacked(hs: torch.Tensor, target_len: int) -> torch.Tensor:
    """Trim or repeat the last frame along the time axis (axis -2)."""
    cur = hs.shape[-2]
    if cur == target_len:
        return hs
    if cur > target_len:
        return hs[..., :target_len, :]
    pad = hs[..., -1:, :].expand(*hs.shape[:-2], target_len - cur, hs.shape[-1])
    return torch.cat([hs, pad], dim=-2)


def standardize_hidden_states(hidden_states: torch.Tensor, wav_lens: torch.Tensor,
                              max_wav_len: int, stride: int):
    """Returns (hs [L, B, T_expected, H], h_lens [B]) under the reference rules."""
    target = expected_max_feat_len(max_wav_len, stride)
    return match_length_stacked(hidden_states, target), upstream_feat_lengths(wav_lens, stride)


@dataclass
class Upstream:
    """A ready-to-run upstream: model + metadata. Serving only: the forward
    runs under ``torch.inference_mode``."""

    name: str
    model: nn.Module  # (wavs [B, T], wav_lens [B]) -> (hs [L, B, T', H], feat_lens [B])
    num_layers: int
    hidden_size: int
    downsample_rate: int

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.inference_mode()
    def apply_standardized(self, wavs, wav_lens):
        """wavs [B, T] (or [B, T, 1]) padded 16 kHz, wav_lens [B] -> (hs
        [L, B, T_expected, H], h_lens [B]) on the model's device."""
        dev = self.device
        wavs = torch.as_tensor(wavs, device=dev)
        if not wavs.is_floating_point():
            wavs = wavs.float()
        wav_lens = torch.as_tensor(wav_lens, device=dev).long()
        if wavs.ndim == 3:
            wavs = wavs[..., 0]
        original_max = wavs.shape[1]
        min_samples = int(MIN_SECOND * SAMPLE_RATE)
        if original_max < min_samples:
            # the reference pads every wav_len by the same amount (upstream.py:199-207)
            wavs = F.pad(wavs, (0, min_samples - original_max))
            run_lens = wav_lens + (min_samples - original_max)
        else:
            run_lens = wav_lens
        hs, _ = self.model(wavs, run_lens)
        return standardize_hidden_states(hs, wav_lens, wavs.shape[1], self.downsample_rate)
