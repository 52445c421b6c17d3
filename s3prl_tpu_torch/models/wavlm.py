"""WavLM (port of s3prl_tpu/models/wavlm.py): the wav2vec2 trunk with a gated
relative-position-bias transformer (Microsoft WavLM, s3prl/upstream/wavlm).

On top of the trunk:
- a T5-style bucketed relative position bias (num_buckets=320,
  max_distance=800): a [num_buckets, H] table owned by the FIRST layer
  (Microsoft's key ``encoder.layers.0.self_attn.relative_attention_bias.weight``;
  the JAX package keeps it at encoder level) and shared by all layers as
  pos_bias [H, T, T] = table[buckets], gathered once per forward and rounded
  to the model dtype (wavlm.py:297-308);
- per layer, a gate per (head, query) from the attention's input split by
  heads (wavlm.py:118-128), which scales the shared bias.

Ported: pre-LN WavLM (WavLM-Large) and post-LN WavLM (WavLM-Base,
WavLM-Base+: the group-norm extractor, the encoder LN before the layers),
which UniSpeech-SAT shares; and WavLM without the gate (``gru_rel_pos=False``:
the bias added to the scores by the plain attention, no kernel, as the JAX
package's attention_bthd path) or without the bias
(``relative_position_embedding=False``: the trunk's plain `SelfAttention`,
K7 / K8 under ``use_flash``), wavlm.py:136-141, :297. Neither takes
``wavlm_fuse`` (the JAX gate asks for both, :175-179).
Routing of a pre-LN `GatedRelPosLayer` (wavlm.py:182-229):
- attention: x + self_attn(LN(x)) with the gated bias; with ``use_flash``
  K9 `gated_bias_attention` (K10 beyond MAX_KERNEL_T), otherwise plain ops;
  the projections through int8_matmul under ``quantize``. WavLM runs none
  of K1, K4, K6 and K7; with the ``wavlm_fuse`` option under quant serving
  and ``use_flash``: int8_matmul QKV, then K11 `gated_bias_attention_outproj`
  (the gated attention, the int8 out-proj and the residual; K9 -> K10 and
  stock ops beyond MAX_KERNEL_T) in place of the attention and out-proj;
- FFN: quant serving (``quantize``, eval mode, CUDA input) -> K2
  `fused_int8_ffn` with the LN and the residual folded in; otherwise the
  module path fc1 -> erf GELU -> fc2 (int8_matmul under ``quantize``): the
  bf16 WavLM does not run K5;
- extractor: the JAX WavLM passes no ``quantize`` to it (wavlm.py:264-267),
  so K3 runs exact (erf) GELU in both paths (the group-norm extractor runs
  no kernel, and erf too).
A post-LN layer (wavlm.py:230-236) takes the same attention routes on raw
x, the gate computed from raw x too, then the stock f32 LN:
x = LN1(x + attn(x)) (with ``wavlm_fuse`` LN1(K11(x))); then
x = LN2(x + ffn(x)), the FFN being K2 bare under quant serving (not K2's
postnorm form) and the module path otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.ffn import fused_int8_ffn
from ..kernels.flash_attention import gated_bias_attention_outproj
from ..ops.quant import int8_matmul
from ..parallel.collectives import copy_to_tp
from . import transformer as tr
from .transformer import EncoderLayer, SelfAttention, TransformerEncoder, _layer_norm
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk


@dataclass(frozen=True)
class WavLMConfig(Wav2Vec2Config):
    """The JAX package's WavLMConfig (wavlm.py:38-43)."""

    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True

    @property
    def gated(self) -> bool:
        """Whether the gate runs, and so has parameters: it scales the bias,
        so it needs both (the JAX WavLM makes ``grep_*`` only where it calls
        them, wavlm.py:118-141)."""
        return self.relative_position_embedding and self.gru_rel_pos


WAVLM_BASE = WavLMConfig(dropout_input=0.0)  # 12L/768, group-norm extractor, post-LN
WAVLM_BASE_PLUS = WAVLM_BASE
WAVLM_LARGE = WavLMConfig(
    extractor_mode="layer_norm",
    encoder_layers=24,
    encoder_embed_dim=1024,
    encoder_ffn_embed_dim=4096,
    encoder_attention_heads=16,
    layer_norm_first=True,
    dropout=0.0,
    attention_dropout=0.0,
    dropout_input=0.0,
    normalize=True,
)


def relative_position_buckets(seq_len: int, num_buckets: int = 320,
                              max_distance: int = 800) -> np.ndarray:
    """[T, T] int64 bucket indices (wavlm.py:62-83; bidirectional T5
    bucketing: half the buckets by sign, half log-spaced in magnitude). The
    log is taken in float64 and truncated, as the JAX package does: a
    float32 log moves bucket boundaries."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


@lru_cache(maxsize=8)
def bucket_table(seq_len: int, num_buckets: int, max_distance: int,
                 device: torch.device, cols: int | None = None) -> torch.Tensor:
    """`relative_position_buckets` as an int64 tensor on `device`, cached per
    (T, device, cols); with `cols` > T the rows are padded to `cols` columns
    of bucket 0 (a padded bias buffer's columns that no kernel reads). Made
    outside inference mode, so a forward that autograd tracks can index
    with a table first cached under `Upstream.apply_standardized`."""
    buckets = relative_position_buckets(seq_len, num_buckets, max_distance)
    if cols is not None:
        buckets = np.pad(buckets, ((0, 0), (0, cols - seq_len)))
    with torch.inference_mode(False):
        return torch.from_numpy(buckets).to(device)


class GatedSelfAttention(SelfAttention):
    """SelfAttention with WavLM's gate parameters under Microsoft's keys:
    ``grep_linear`` (Linear(Dh, 8)) and ``grep_a`` [1, H, 1, 1], kept in f32
    and cast to the model dtype at use (none with ``gated=False``); in layer
    0 also the shared bias table ``relative_attention_bias``
    (nn.Embedding(num_buckets, H), f32)."""

    def __init__(self, embed_dim: int, num_heads: int, quantize: bool = False,
                 use_flash: bool = False, device=None, gated: bool = True):
        super().__init__(embed_dim, num_heads, quantize, use_flash, device=device)
        self.gated = gated  # a plain attribute, not state
        if gated:
            self.grep_linear = nn.Linear(embed_dim // num_heads, 8, device=device)
            self.grep_a = nn.Parameter(torch.empty(1, num_heads, 1, 1, device=device))

    def heads(self) -> slice:
        """The heads this layer holds: all, or a tp shard's run of them."""
        if self.tp is None:
            return slice(None)
        return slice(self.tp.rank * self.num_heads, (self.tp.rank + 1) * self.num_heads)

    def local(self, p: torch.Tensor) -> torch.Tensor:
        """A replicated parameter as this layer reads it: under tp through
        `copy_to_tp`, so the partial gradient of each rank's heads is summed."""
        return p if self.tp is None else copy_to_tp(p, self.tp.group)

    def gate(self, h: torch.Tensor) -> torch.Tensor:
        """Gate [B, H, T] in h's dtype from h [B, T, C] split by heads
        (wavlm.py:118-128): g = sigmoid(sum over 4 of grep_linear(h)), then
        a * (b * grep_a - 1) + 2, every step in h's dtype. Under tp: the
        gate of this rank's heads, from their channels of h and their
        ``grep_a``."""
        B, T, C = h.shape
        H = self.num_heads * (1 if self.tp is None else self.tp.size)
        heads = h.view(B, T, H, C // H)[:, :, self.heads()].transpose(1, 2)
        H = heads.shape[1]
        lin = self.grep_linear
        g = F.linear(heads, self.local(lin.weight).to(h.dtype)) + \
            self.local(lin.bias).to(h.dtype)  # Dense: dot, then bias
        g = torch.sigmoid(g.view(B, H, T, 2, 4).sum(-1))
        grep_a = self.local(self.grep_a)[:, self.heads()]
        return g[..., 0] * (g[..., 1] * grep_a.to(h.dtype)[..., 0] - 1.0) + 2.0


class GatedRelPosLayer(EncoderLayer):
    """WavLM block (wavlm.py:86-237), pre-LN with ``layer_norm_first``,
    post-LN without it. ``num_buckets`` is given to layer 0 only, which
    then owns the shared bias table (none without the bias); ``gated``
    (``gru_rel_pos``) adds the gate parameters."""

    attention = GatedSelfAttention

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 quantize: bool = False, num_buckets: int | None = None, device=None,
                 wavlm_fuse: bool = False, layer_norm_first: bool = True, gated: bool = True,
                 dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__(embed_dim, ffn_dim, num_heads, dtype, use_flash, quantize,
                         device=device, layer_norm_first=layer_norm_first,
                         attention_kwargs={"gated": gated}, dropout=dropout,
                         activation_dropout=activation_dropout)
        self.wavlm_fuse = wavlm_fuse  # K11 under quant serving: a plain attribute, not state
        if num_buckets is not None:
            self.self_attn.relative_attention_bias = nn.Embedding(num_buckets, num_heads,
                                                                  device=device)

    def forward(self, x: torch.Tensor, kv_lens: torch.Tensor, pad_mask: torch.Tensor,
                pos_bias: torch.Tensor | None, generator=None, sp=None) -> torch.Tensor:
        """x [B, T, C] in the model dtype; kv_lens [B] int32; pad_mask [B, T]
        True on padded frames; pos_bias [H, T, T], the encoder's shared bias
        (None without the bias); `generator`: train mode's dropouts
        (wavlm.py:183-184), after each residual branch and the FFN's
        activation. Under tp (`split_tp`) the attention and the FFN are this
        rank's heads and columns (pos_bias of its heads), all-reduced as in
        `EncoderLayer._tp_forward`; under sp (`sp`) the module path, the
        attention on the gathered keys (pad_mask [B, T_all], pos_bias the
        rank's query rows)."""
        attn, ln1, ln2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
        quant_serving = self.quantize and not self.training and tr._fused_block_available(x)
        # pre-LN: attention on LN1(x), plus x; post-LN: on raw x, then LN1
        h = _layer_norm(x, ln1) if self.layer_norm_first else x
        if self.tp is not None:
            h = copy_to_tp(h, self.tp.group)
        if quant_serving and self.use_flash and self.wavlm_fuse:  # wavlm.py:175-212
            qkv = int8_matmul(h, attn.qpair("qkv"), attn.qkv_bias, out_dtype=self.dtype)
            x = gated_bias_attention_outproj(qkv, x, pos_bias, attn.gate(h).float(),
                                             attn.qpair("out_proj"), attn.out_proj.bias,
                                             kv_lens, self.num_heads)
        elif pos_bias is None:  # no bias: the trunk's attention (wavlm.py:136-137)
            x = x + self._drop(attn(h, pad_mask, sp=sp), generator)
        elif attn.gated:
            x = x + self._drop(attn(h, pad_mask, rel_bias=(pos_bias, attn.gate(h)), sp=sp),
                               generator)
        else:  # the bias without the gate, plain ops (wavlm.py:140-141)
            x = x + self._drop(attn(h, pad_mask, attn_bias=pos_bias[None], sp=sp), generator)
        if self.tp is not None:
            group = self.tp.group
            if not self.layer_norm_first:
                x = _layer_norm(x, ln1)
                return _layer_norm(x + self._drop(self._ffn(copy_to_tp(x, group), generator),
                                                  generator), ln2)
            h = self._ffn(copy_to_tp(_layer_norm(x, ln2), group), generator)
            return x + self._drop(h, generator)
        if not self.layer_norm_first:  # wavlm.py:230-236
            x = _layer_norm(x, ln1)
            if quant_serving:  # K2 bare
                h = fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                                   self.fc2.bias)
            else:
                h = self._drop(self._ffn(x, generator), generator)
            return _layer_norm(x + h, ln2)
        if quant_serving:
            return fused_int8_ffn(x, self.qpair("fc1"), self.fc1.bias, self.qpair("fc2"),
                                  self.fc2.bias, ln=(ln2.weight, ln2.bias), residual=True)
        return x + self._drop(self._ffn(_layer_norm(x, ln2), generator), generator)


class WavLMEncoder(TransformerEncoder):
    """Pos-conv, the gated layers and the encoder LN (``enc_layer_norm`` of
    the JAX tree, after the layers when pre-LN, before them when post-LN,
    wavlm.py:290-292, :330-331); [L+1, B, T, C] as the trunk's."""

    def __init__(self, cfg: WavLMConfig, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, quantize: bool = False, device=None,
                 posconv: str | None = None, wavlm_fuse: bool = False):
        super().__init__(cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, 0,
                         cfg.encoder_attention_heads, cfg.layer_norm_first, cfg.conv_pos,
                         cfg.conv_pos_groups, dtype, use_flash, quantize, device=device,
                         posconv=posconv, dropout=cfg.dropout)
        self.dtype = dtype
        self.use_flash = use_flash
        self.wavlm_fuse = wavlm_fuse
        self.rel_pos, self.gated = cfg.relative_position_embedding, cfg.gated
        self.num_buckets, self.max_distance = cfg.num_buckets, cfg.max_distance
        self.layers.extend(
            GatedRelPosLayer(cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim,
                             cfg.encoder_attention_heads, dtype, use_flash, quantize,
                             num_buckets=cfg.num_buckets if i == 0 and self.rel_pos else None,
                             device=device, wavlm_fuse=wavlm_fuse,
                             layer_norm_first=cfg.layer_norm_first, gated=cfg.gated,
                             dropout=cfg.dropout, activation_dropout=cfg.activation_dropout)
            for i in range(cfg.encoder_layers))

    def _layer_args(self, T: int, device, rows: slice = slice(None)) -> tuple:
        """The shared bias pos_bias [H, T, T] = table[buckets] in the model
        dtype (wavlm.py:304-308), gathered once per forward; the layers
        share the one tensor. Its form is what the layers' kernels read:
        - flash, bf16 model: bf16 gathered into [H, T, Tp], Tp = T rounded
          up to 8, handed over as the view [:, :, :T] (K9/K10 read its rows
          in 16-byte copies; 288 MB at T = 3,000, half the f32 bias);
        - flash under ``wavlm_fuse``: the rounded table cast once to f32 and
          gathered likewise into rows of Tp = T rounded up to 4 (K11 reads
          them in 16-byte copies);
        - flash in an f32 model: f32, contiguous;
        - no flash, or no gate (the plain attention takes the bias):
          contiguous in the model dtype.
        The values are the same in each: bf16 -> f32 is exact. Without the
        bias (``relative_position_embedding=False``) it is None. Under tp
        the rows of this rank's heads; under sp (no flash) the query `rows`
        of a time shard, [H, T_r, T]."""
        if not self.rel_pos:
            return (None,)
        attn = self.layers[0].self_attn
        table = attn.local(attn.relative_attention_bias.weight).t()[attn.heads()].to(self.dtype)
        nb, md = self.num_buckets, self.max_distance
        if not (self.use_flash and self.gated):
            return (table[:, bucket_table(T, nb, md, device)[rows]],)
        if self.dtype == torch.bfloat16 or self.wavlm_fuse:
            step = 4 if self.wavlm_fuse else 8  # 16 bytes of f32 or of bf16
            table = table.float() if self.wavlm_fuse else table
            padded = table[:, bucket_table(T, nb, md, device, cols=-(-T // step) * step)]
            return (padded[:, :, :T],)
        return (table.float()[:, bucket_table(T, nb, md, device)],)


class WavLMModel(Wav2Vec2Trunk):
    """WavLM extraction: conv features -> LN -> proj -> gated rel-pos
    transformer -> ([L+1, B, T', C], feat_lens [B]), the trunk's length
    rule (wavlm.py:268-270). Weights as the trunk's; the int8 model keeps
    its projection weights in f32 and quantizes them once at load. Options:
    ``wavlm_fuse`` (K11), the front-end ``fused_conv`` / ``fused_midln`` and
    the pos-conv ``fused_posconv`` (K16a) / ``int8_posconv`` (K16b; WavLM
    reaches the same pos-conv module, wavlm.py:287); ``int8_conv`` raises,
    as WavLM's extractor takes no ``quantize``, and on the group-norm
    extractor of WavLM-Base the front-end options all raise; ``wavlm_fuse``
    raises without the gate or without the bias. No weighted sum: the JAX
    WavLM has no ``layer_weights``."""

    tanh_extractor = False  # erf in both paths (wavlm.py:264-267)
    fuse_options = ("wavlm_fuse",)
    layer_types = ("transformer",)
    # the JAX WavLM layer's FFN runs erf GELU whatever activation_fn says
    # (wavlm.py:203) while its K2 gate reads it (:185-188): gelu only here
    activations = ("gelu",)

    def __init__(self, cfg: WavLMConfig = WAVLM_LARGE, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, quantize: bool = False, device=None, **fuse):
        if fuse.get("wavlm_fuse") and not cfg.gated:
            raise ValueError("wavlm_fuse cannot take effect: it fuses the gated "
                             "relative-position bias attention, and this model has "
                             f"relative_position_embedding={cfg.relative_position_embedding}, "
                             f"gru_rel_pos={cfg.gru_rel_pos}")
        super().__init__(cfg, dtype, use_flash, quantize, device=device, **fuse)

    def _encoder(self, cfg, dtype, use_flash, quantize, device, posconv, **fuse) -> nn.Module:
        return WavLMEncoder(cfg, dtype, use_flash, quantize, device=device, posconv=posconv,
                            **fuse)

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None, sp=None):
        """wavs [B, T] padded 16 kHz, wav_lens [B] -> (hidden_states
        [L+1, B, T', C], feat_lens [B]); `generator`: train mode's dropouts
        (``dropout_input``, wavlm.py:276, and the encoder's). The JAX WavLM
        reads no ``encoder_layerdrop`` (wavlm.py:312-321), nor does this.
        `sp`: time-sharded extraction (`Wav2Vec2Trunk.forward`)."""
        return super().forward(wavs, wav_lens, generator=generator, sp=sp)
