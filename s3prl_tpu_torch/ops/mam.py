"""Masked Acoustic Modeling masks on the features' device (port of
s3prl_tpu/ops/mam.py:20-70; the reference's pretrain/mockingjay/dataset.py).

About `mask_proportion` of the frames are masked in spans of
`mask_consecutive`; a span's frames are zeroed (80%), replaced by a random
frame of the utterance (10%) or kept (10%), and predicted; TERA also zeroes
a band of frequency bins an utterance. The draw (`draw_mam_uniforms`, from
a `torch.Generator`) is apart from the rule that reads it
(`mam_mask_from_uniforms`), so a test can feed in JAX's draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .masking import length_mask


def mam_spans(T: int, mask_proportion: float, mask_consecutive: int) -> int:
    """The span count of a padded length T (mam.py:38)."""
    return max(int(T * mask_proportion / max(mask_consecutive, 1)), 1)


def draw_mam_uniforms(generator: Optional[torch.Generator], B: int, T: int,
                      mask_proportion: float = 0.15, mask_consecutive: int = 7,
                      mask_frequency: float = 0.0, device=None) -> Dict[str, torch.Tensor]:
    """The uniforms `mam_mask_from_uniforms` reads, in the shapes of the
    JAX package's five keys (mam.py:36): span starts [B, S], span modes
    [B, S, 1], random frames [B, T] and, with `mask_frequency`, the band's
    start and width [B, 1]."""
    S = mam_spans(T, mask_proportion, mask_consecutive)
    kw = dict(generator=generator, device=device)
    out = {"span": torch.rand(B, S, **kw), "mode": torch.rand(B, S, 1, **kw),
           "rand": torch.rand(B, T, **kw)}
    if mask_frequency > 0:
        out["freq"], out["fwidth"] = torch.rand(B, 1, **kw), torch.rand(B, 1, **kw)
    return out


def mam_mask_from_uniforms(u: Dict[str, torch.Tensor], feats: torch.Tensor,
                           feat_lens: torch.Tensor, mask_proportion: float = 0.15,
                           mask_consecutive: int = 7, mask_frequency: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked feats [B, T, D], label mask [B, T] bool, True = predict) of
    feats [B, T, D] (mam.py:20-66): span starts ``floor(u * max(len - L,
    1))``, each frame's mode the least of the spans that hit it (2 where
    none does), zero below 0.8, a random frame ``floor(u * max(len, 1))``
    in [0.8, 0.9), kept above; the frequency band ``floor(u * f * D)``
    wide from ``floor(u * max(D - width, 1))``, per utterance."""
    B, T, D = feats.shape
    if u["span"].shape[1] != mam_spans(T, mask_proportion, mask_consecutive):
        raise ValueError(f"span uniforms: {u['span'].shape[1]} spans, the count at T = {T} "
                         f"is {mam_spans(T, mask_proportion, mask_consecutive)}")
    lens = feat_lens.to(feats.device)
    valid_starts = torch.clamp(lens - mask_consecutive, min=1)
    starts = (u["span"] * valid_starts[:, None].float()).to(torch.int64)
    t = torch.arange(T, device=feats.device)[None, None, :]
    span_hit = (t >= starts[..., None]) & (t < (starts + mask_consecutive)[..., None])
    time_mask = span_hit.any(dim=1) & length_mask(lens, T)
    mode_t = torch.where(span_hit, u["mode"], 2.0).amin(dim=1)
    rand_idx = (u["rand"] * torch.clamp(lens, min=1)[:, None].float()).to(torch.int64)
    rand_frames = torch.gather(feats, 1, rand_idx[..., None].expand(B, T, D))
    masked = torch.where((time_mask & (mode_t < 0.8))[..., None], 0.0, feats)
    masked = torch.where((time_mask & (mode_t >= 0.8) & (mode_t < 0.9))[..., None],
                         rand_frames, masked)
    if mask_frequency > 0:
        width = (u["fwidth"] * mask_frequency * D).to(torch.int64)
        start = (u["freq"] * torch.clamp(D - width, min=1).float()).to(torch.int64)
        d = torch.arange(D, device=feats.device)[None, :]
        freq_mask = (d >= start) & (d < start + width)
        masked = torch.where(freq_mask[:, None, :], 0.0, masked)
    return masked, time_mask


def mam_mask(generator: Optional[torch.Generator], feats: torch.Tensor, feat_lens: torch.Tensor,
             mask_proportion: float = 0.15, mask_consecutive: int = 7,
             mask_frequency: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """`draw_mam_uniforms` on the features' device, then
    `mam_mask_from_uniforms`."""
    B, T, _ = feats.shape
    kw = dict(mask_proportion=mask_proportion, mask_consecutive=mask_consecutive,
              mask_frequency=mask_frequency)
    u = draw_mam_uniforms(generator, B, T, device=feats.device, **kw)
    return mam_mask_from_uniforms(u, feats, feat_lens, **kw)
