"""HuBERT configurations and its pretraining head (port of
s3prl_tpu/models/hubert.py). Extraction is exactly the wav2vec2 trunk
forward; `HubertForPretrain` adds the masked-unit prediction head of
in-repo pretraining (the reference's hubert_model.py: ``final_proj`` and
cosine logits against the label embeddings at temperature ``logit_temp``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .wav2vec2 import BASE, LARGE, Wav2Vec2Config, Wav2Vec2Trunk

HUBERT_BASE = BASE  # 12L/768, group-norm extractor, post-LN, normalize=False
HUBERT_LARGE = LARGE  # 24L/1024, layer-norm extractor, pre-LN, normalize=True


@dataclass(frozen=True)
class HubertPretrainConfig:
    """Pretraining-head hyperparameters (the mask is the task's:
    `HubertPretrainTask`)."""

    num_classes: int = 504  # k-means units (100 -> 504 incl. specials)
    final_dim: int = 256
    logit_temp: float = 0.1


class HubertForPretrain(nn.Module):
    """Trunk + masked-unit head: (wavs, wav_lens, mask_indices) -> (logits
    [B, T', num_classes] f32, feat_lens), the logits cos(final_proj(h_L),
    label_embs) / logit_temp with each norm floored at 1e-8 (models/
    hubert.py:38-75). Modules: ``trunk``, ``final_proj``, ``label_embs`` (the
    JAX tree's names; the label embeddings uniform in [0, 1) at init)."""

    def __init__(self, cfg: Wav2Vec2Config = HUBERT_BASE,
                 pre_cfg: HubertPretrainConfig = HubertPretrainConfig(),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg, self.pre_cfg, self.dtype = cfg, pre_cfg, dtype
        self.trunk = Wav2Vec2Trunk(cfg, dtype, device=device)
        self.final_proj = nn.Linear(cfg.encoder_embed_dim, pre_cfg.final_dim, device=device)
        self.final_proj.weight.data = self.final_proj.weight.data.to(dtype)
        self.label_embs = nn.Parameter(torch.empty(pre_cfg.num_classes, pre_cfg.final_dim,
                                                   device=device))

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor,
                mask_indices: torch.Tensor | None = None, generator=None):
        hs, feat_lens = self.trunk(wavs, wav_lens, generator=generator,
                                   mask_indices=mask_indices)
        proj = F.linear(hs[-1], self.final_proj.weight, self.final_proj.bias.to(self.dtype))
        emb = self.label_embs.to(self.dtype)
        proj = proj / torch.clamp(torch.linalg.vector_norm(proj, dim=-1, keepdim=True), min=1e-8)
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)
        logits = torch.einsum("btd,cd->btc", proj.float(), emb.float())
        return logits / self.pre_cfg.logit_temp, feat_lens
