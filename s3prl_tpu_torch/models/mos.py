"""The MOS predictor: a finetuned upstream, a learned layer-weighted sum and
the mean-net head over 1-s windows (port of s3prl_tpu/models/mos.py:34-129;
the reference's upstream/mos_prediction).

Each padded batch is cut into 1-s windows at a 0.5-s hop, their count
taken from the padded T (one window up to 16,000 samples, T // 8,000
beyond, the last half zero padding); every window runs through the
upstream (``trunk``: wav2vec2-Base; ``apc``: APC over log-mel; ``tera``: a
Mockingjay encoder over log-mel or fbank + deltas), the softmax of
``featurizer_weights`` sums its layers in f32, ``connector`` projects,
``mean_net_linear`` scores every frame and averages (or
``mean_net_pooling``'s softmax pools first), ``clipping`` maps the score
to tanh(s) * 2 + 3, and each utterance averages the windows its own length
covers. The score is broadcast over [1, B, T', 1] at the upstream's frame
rate, the standard upstream contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import Dense
from .apc import APCConfig, APCModel
from .baseline import mel_ssl_features
from .mockingjay import MockingjayConfig, MockingjayEncoder
from .wav2vec2 import BASE, Wav2Vec2Config, Wav2Vec2Trunk

SEG = 16000
STEP = 8000


@dataclass(frozen=True)
class MosConfig:
    """The JAX package's fields and defaults (its ``MosConfig``)."""

    upstream: str = "wav2vec2"  # "wav2vec2" | "apc" | "tera" (hubconf mos_*)
    trunk: Wav2Vec2Config = BASE
    apc: Optional[APCConfig] = None
    tera: Optional[MockingjayConfig] = None
    feat_kind: str = "mel"  # the apc / tera front end: "mel" or "fbank_delta"
    projector_dim: int = 256
    clipping: bool = False
    attention_pooling: bool = False

    @property
    def downsample_rate(self) -> int:
        return self.trunk.downsample_rate if self.upstream == "wav2vec2" else 160


class MosModel(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (scores [1, B, T', 1], lens [B])."""

    def __init__(self, cfg: MosConfig = MosConfig(), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.upstream == "apc":
            apc = cfg.apc or APCConfig()
            self.apc = APCModel(apc, device)
            layers, hidden = apc.num_layers, apc.hidden_size
        elif cfg.upstream == "tera":
            tera = cfg.tera or MockingjayConfig(input_dim=80)
            self.tera = MockingjayEncoder(tera, dtype, device)
            layers, hidden = tera.num_hidden_layers + 1, tera.hidden_size
        elif cfg.upstream == "wav2vec2":
            self.trunk = Wav2Vec2Trunk(cfg.trunk, dtype, device=device)
            layers, hidden = cfg.trunk.encoder_layers + 1, cfg.trunk.encoder_embed_dim
        else:
            raise ValueError(f"unknown MOS upstream {cfg.upstream!r}")
        self.featurizer_weights = nn.Parameter(torch.zeros(layers, device=device))
        self.connector = Dense(hidden, cfg.projector_dim, device=device)
        if cfg.attention_pooling:  # SelfAttentionPooling.W
            self.mean_net_pooling = Dense(cfg.projector_dim, 1, device=device)
        self.mean_net_linear = Dense(cfg.projector_dim, 1, device=device)

    def _states(self, segs: torch.Tensor, generator=None) -> torch.Tensor:
        """Every window's hidden states [L, B * S, T', C]."""
        lens = torch.full((segs.shape[0],), SEG, dtype=torch.long, device=segs.device)
        if self.cfg.upstream == "wav2vec2":
            return self.trunk(segs, lens, generator=generator)[0]
        feats, feat_lens = mel_ssl_features(segs, lens, self.cfg.feat_kind)
        model = self.apc if self.cfg.upstream == "apc" else self.tera
        return model(feats, feat_lens, generator)[0]

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        """In train mode the nested upstream's dropouts draw from
        `generator` (mos.py:79-89); the head has none."""
        cfg = self.cfg
        B, T = wavs.shape
        n_seg = max(T // STEP, 1) if T > SEG else 1
        pad_to = (n_seg - 1) * STEP + SEG
        segs = F.pad(wavs, (0, max(pad_to - T, 0))).unfold(1, SEG, STEP).reshape(B * n_seg, SEG)
        hs = self._states(segs, generator)
        w = torch.softmax(self.featurizer_weights, dim=0)
        feat = self.connector(torch.einsum("l,lbtc->btc", w, hs.float()))
        if cfg.attention_pooling:
            att = torch.softmax(self.mean_net_pooling(feat), dim=1)
            seg_score = self.mean_net_linear((feat * att).sum(dim=1))[:, 0]
        else:
            seg_score = self.mean_net_linear(feat)[..., 0].mean(dim=-1)
        if cfg.clipping:
            seg_score = torch.tanh(seg_score) * 2.0 + 3.0
        seg_score = seg_score.view(B, n_seg)
        # each utterance averages the windows its own length covers
        wav_lens = wav_lens.to(wavs.device)
        n_valid = torch.where(wav_lens <= SEG, 1, torch.div(wav_lens, STEP, rounding_mode="floor"))
        n_valid = n_valid.clamp(1, n_seg)
        seg_mask = (torch.arange(n_seg, device=wavs.device)[None] < n_valid[:, None])
        seg_mask = seg_mask.to(seg_score.dtype)
        score = (seg_score * seg_mask).sum(-1) / seg_mask.sum(-1)
        rate = cfg.downsample_rate
        t_out = max(T // rate, 1)
        out_lens = torch.clamp(torch.div(wav_lens, rate, rounding_mode="floor"), min=1)
        return score[None, :, None, None].expand(1, B, t_out, 1), out_lens
