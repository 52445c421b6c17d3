"""SpecAugment on the features' device (port of s3prl_tpu/nn/specaug.py).

Random frequency and time band masking (and the two-segment time warp) of
[B, T, D] features, in the reference's LibriSpeech policy
(s3prl/nn/specaug.py:26-207). Every draw comes from an explicit
`torch.Generator` (the JAX package draws from a PRNG key, so the two
streams differ); the masks themselves are built from the drawn bands by
`band_mask` and applied by `mask_bands`, so the same bands give the JAX
package's masks. Static shapes: a mask is the union of its bands compared
against an iota, no data-dependent shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_bands(generator: torch.Generator, B: int, L: int, num_masks: int,
               max_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, widths) [B, num_masks] on the generator's device: widths
    uniform in [0, max_width], starts uniform in [0, max(L - width, 1))
    (nn/specaug.py:21-30)."""
    dev = generator.device
    widths = torch.randint(0, max_width + 1, (B, num_masks), generator=generator, device=dev)
    u = torch.rand(B, num_masks, generator=generator, device=dev)
    starts = (u * torch.clamp(L - widths, min=1).float()).to(torch.int64)
    return starts, widths


def band_mask(starts: torch.Tensor, widths: torch.Tensor, L: int) -> torch.Tensor:
    """[B, L] bool: the union of the bands [start, start + width)."""
    pos = torch.arange(L, device=starts.device)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return hit.any(dim=1)


def mask_bands(feats: torch.Tensor, feat_lens: Optional[torch.Tensor], fbands, tbands,
               mask_value: float = 0.0) -> torch.Tensor:
    """`feats` [B, T, D] with the frequency bands `fbands` and the time bands
    `tbands` ((starts, widths) each) set to `mask_value`; the time mask
    stays inside each utterance's `feat_lens` (nn/specaug.py:53-57)."""
    B, T, D = feats.shape
    fmask = band_mask(*(b.to(feats.device) for b in fbands), D)
    tmask = band_mask(*(b.to(feats.device) for b in tbands), T)
    if feat_lens is not None:
        tmask = tmask & (torch.arange(T, device=feats.device)[None, :] < feat_lens[:, None])
    out = torch.where(fmask[:, None, :], mask_value, feats)
    return torch.where(tmask[:, :, None], mask_value, out)


def specaug(generator: torch.Generator, feats: torch.Tensor,
            feat_lens: Optional[torch.Tensor] = None, *, freq_mask_num: int = 2,
            freq_mask_width: int = 27, time_mask_num: int = 2, time_mask_width: int = 100,
            mask_value: float = 0.0) -> torch.Tensor:
    """Frequency then time masking of feats [B, T, D] (nn/specaug.py:33-57):
    ``freq_mask_num`` bands of at most ``freq_mask_width`` bins and
    ``time_mask_num`` bands of at most ``time_mask_width`` frames an
    utterance, drawn from `generator` (frequency bands first)."""
    B, T, D = feats.shape
    fbands = draw_bands(generator, B, D, freq_mask_num, freq_mask_width)
    tbands = draw_bands(generator, B, T, time_mask_num, time_mask_width)
    return mask_bands(feats, feat_lens, fbands, tbands, mask_value)


class SpecAug:
    """The policy as a callable: ``SpecAug()(generator, feats, lens)``."""

    def __init__(self, freq_mask_num: int = 2, freq_mask_width: int = 27,
                 time_mask_num: int = 2, time_mask_width: int = 100):
        self.kwargs = dict(freq_mask_num=freq_mask_num, freq_mask_width=freq_mask_width,
                           time_mask_num=time_mask_num, time_mask_width=time_mask_width)

    def __call__(self, generator: torch.Generator, feats: torch.Tensor,
                 feat_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        return specaug(generator, feats, feat_lens, **self.kwargs)


def warp_frames(feats: torch.Tensor, center: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """feats [B, T, D] re-interpolated so that frame `center` [B] reads
    source frame center + `shift` [B], linearly on each side
    (nn/specaug.py:82-103)."""
    B, T, D = feats.shape
    t = torch.arange(T, dtype=torch.float32, device=feats.device)[None, :]
    c = center.to(feats.device, torch.float32)[:, None]
    sc = c + shift.to(feats.device, torch.float32)[:, None]
    left = t / torch.clamp(c, min=1.0) * sc
    right = sc + (t - c) / torch.clamp((T - 1) - c, min=1.0) * ((T - 1) - sc)
    src = torch.where(t <= c, left, right)
    lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = (src - lo.float())[..., None]

    def gather(idx):
        return torch.gather(feats, 1, idx[..., None].expand(B, T, D))

    return gather(lo) * (1.0 - frac) + gather(hi) * frac


def time_warp(generator: torch.Generator, feats: torch.Tensor,
              warp_window: int = 5) -> torch.Tensor:
    """Two-segment linear time warp (nn/specaug.py:74-103): an anchor drawn
    in [warp_window + 1, T - warp_window - 1) moves by a shift drawn in
    [-warp_window, warp_window]; sequences of at most 2 * warp_window + 2
    frames come back as they are."""
    B, T, D = feats.shape
    if T <= 2 * warp_window + 2:
        return feats
    dev = generator.device
    center = torch.randint(warp_window + 1, T - warp_window - 1, (B,), generator=generator,
                           device=dev)
    shift = torch.randint(-warp_window, warp_window + 1, (B,), generator=generator, device=dev)
    return warp_frames(feats, center, shift)
