"""fairseq RoBERTa over discrete units and the vq-wav2vec k-means -> RoBERTa
pipeline (port of s3prl_tpu/models/roberta.py and the pipeline of
s3prl_tpu/upstream/registry.py:1378-1470).

`RobertaModel`, as fairseq builds it: positions from ``make_positions``
with the pad offset (the first valid token at pad_idx + 1, pads at
pad_idx), the token embedding zero on padded tokens, ``emb_layer_norm``
(fairseq's ``layernorm_embedding``, eps 1e-5), then post-LN blocks at eps
1e-5 with erf GELU (`EncoderLayer`, its module path: the JAX model passes
no use_flash / quantize, so no kernel runs); its states are the embedding
output and every layer's output. The modules keep fairseq's keys.

`DiscreteBertPipeline`: vq-wav2vec's k-means codes (`Wav2Vec1Model`) of
each frame, a code pair (a, b) looked up into a token id (a
dictionary's table, or the dense 4 + a V + b clipped to the vocabulary),
the ids wrapped in <s> ... </s>, cut into buckets of ``max_positions``
tokens whose positions restart, and RoBERTa over the buckets; lengths
len + 2 tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.heads import dropout
from ..ops.masking import length_mask
from .transformer import EncoderLayer, _layer_norm
from .wav2vec1 import Wav2Vec1Config, Wav2Vec1Model

BOS, PAD, EOS, UNK = 0, 1, 2, 3  # fairseq Dictionary's specials


@dataclass(frozen=True)
class RobertaConfig:
    """The field names and defaults of s3prl_tpu.models.roberta.RobertaConfig."""

    vocab_size: int = 320 * 320 + 5
    max_positions: int = 512
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    pad_idx: int = PAD


class RobertaModel(nn.Module):
    """tokens [B, T] ids, lens [B] -> (hidden states [L + 1, B, T, H], lens)
    (roberta.py:44-80). Embeddings, norms and biases in f32, the layers'
    matrix weights in the model dtype; in train mode the embedding output,
    each residual branch and the FFN's activation drop from `generator`
    (the attention probabilities are never dropped, as in the JAX model)."""

    def __init__(self, cfg: RobertaConfig = RobertaConfig(), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        H = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, H, device=device)
        self.embed_positions = nn.Embedding(cfg.max_positions + cfg.pad_idx + 1, H, device=device)
        self.emb_layer_norm = nn.LayerNorm(H, eps=1e-5, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(H, cfg.ffn_size, cfg.num_heads, dtype, device=device,
                         layer_norm_first=False, dropout=cfg.dropout,
                         activation_dropout=cfg.activation_dropout)
            for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, lens: torch.Tensor, generator=None):
        cfg = self.cfg
        B, T = tokens.shape
        valid = length_mask(lens, T, torch.int64)
        tokens = torch.where(valid > 0, tokens, cfg.pad_idx)
        pos_ids = torch.cumsum(valid, dim=1) * valid + cfg.pad_idx
        emb = self.embed_tokens(tokens) * valid[..., None]  # the pad row zeroed
        x = _layer_norm(emb + self.embed_positions(pos_ids), self.emb_layer_norm).to(self.dtype)
        x = dropout(x, cfg.dropout, self.training, generator)
        pad = valid == 0
        kv_lens = torch.clamp(lens, max=T).to(torch.int32)
        hidden = [x]
        for layer in self.layers:
            x = layer(x, kv_lens, pad, generator=generator)
            hidden.append(x)
        return torch.stack(hidden), lens


class DiscreteBertPipeline(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (RoBERTa's states [L + 1, B, T_c + 2,
    H], token lengths len + 2) over vq-wav2vec's k-means codes (registry.py:
    1416-1450), in f32 as the JAX pipeline runs. ``lookup`` [V, V] maps a
    code pair to a token id; it is a buffer that the state_dict does not
    hold (the dictionary's table, or the dense default), filled by
    `set_lookup` once the module is materialised."""

    def __init__(self, w2v_cfg: Wav2Vec1Config, rob_cfg: RobertaConfig, device=None):
        super().__init__()
        self.cfg = rob_cfg
        self.w2v = Wav2Vec1Model(w2v_cfg, device=device)
        self.roberta = RobertaModel(rob_cfg, device=device)
        V = w2v_cfg.vq_vars
        self.register_buffer("lookup", torch.empty(V, V, dtype=torch.int64, device=device),
                             persistent=False)

    def set_lookup(self, lookup) -> None:
        """The code-pair table, [V', V'] for any V' >= V (a dictionary's is
        320 x 320 whatever the frontend's codebook)."""
        self.lookup = torch.as_tensor(lookup, dtype=torch.int64, device=self.lookup.device)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        _, lens, ids = self.w2v(wavs, wav_lens, generator, return_code_ids=True)
        B, Tc = ids.shape[:2]
        tokens = self.lookup[ids[..., 0], ids[..., 1 % ids.shape[-1]]]
        T_tok, P = Tc + 2, self.cfg.max_positions
        wrapped = torch.full((B, T_tok), EOS, dtype=tokens.dtype, device=tokens.device)
        wrapped[:, 1:Tc + 1] = tokens
        wrapped[:, 0] = BOS
        tok_lens = lens + 2
        eos_pos = torch.clamp(lens + 1, 0, T_tok - 1)
        wrapped = torch.where(torch.arange(T_tok, device=tokens.device)[None] == eos_pos[:, None],
                              EOS, wrapped)
        nb = -(-T_tok // P)  # buckets of P tokens whose positions restart (expert.py:73-79)
        buckets = F.pad(wrapped, (0, nb * P - T_tok)).reshape(B * nb, P)
        offsets = torch.arange(nb, device=tokens.device)[None] * P
        b_lens = torch.clamp(tok_lens[:, None] - offsets, 0, P).reshape(-1)
        hs, _ = self.roberta(buckets, b_lens, generator)
        return hs.reshape(hs.shape[0], B, nb * P, -1)[:, :, :T_tok], tok_lens
