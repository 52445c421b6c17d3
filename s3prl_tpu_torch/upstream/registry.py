"""Named upstream registry (port of s3prl_tpu/upstream/registry.py).

Ported entries, with the JAX package's names and configurations
(s3prl_tpu/upstream/registry.py:211-240, :290-308, :481-520, :693-716,
:1524-1528):
- HuBERT: ``hubert_large_ll60k`` (pre-LN, layer-norm extractor), ``hubert``
  / ``hubert_base`` (post-LN, group-norm extractor) and the HuBERT-Base
  aliases ``hubert_base_robust_mgr``, ``mhubert_base_vp_en_es_fr_it3``,
  ``contentvec``, ``contentvec_km100``, ``contentvec_km500``, ``ms_hubert``;
- wav2vec 2.0 (the conv length rule): ``wav2vec2`` / ``wav2vec2_base_960``,
  ``wav2vec2_large_ll60k`` / ``wav2vec2_large_lv60_cv_swbd_fsh`` and the
  Large aliases ``wav2vec2_large_960``, ``wav2vec2_large_voxpopuli_100k``,
  ``xlsr_53``, ``xls_r_300m``, ``xls_r_1b``, ``xls_r_2b`` (their published
  shapes come with ``ckpt=``);
- data2vec (post-LN, layer-norm extractor, the conv rule, the depth-5
  pos-conv stack): ``data2vec`` / ``data2vec_base_960``,
  ``data2vec_large_ll60k``;
- WavLM: ``wavlm`` / ``wavlm_base``, ``wavlm_base_plus``, ``wavlm_large``,
  and UniSpeech-SAT, which shares them: ``unispeech_sat`` /
  ``unispeech_sat_base``, ``unispeech_sat_base_plus``,
  ``unispeech_sat_large``;
- the parameter-free baseline front ends (models/baseline.py: one layer,
  stride 160, f32 features computed on the model's device): ``fbank``,
  ``fbank_no_cmvn``, ``mfcc``, ``spectrogram``, ``mel``, ``linear``, which
  take ``device=`` and `baseline_features`' keywords and none of the
  trunks';
- the mel-domain SSL models over their front ends (`FeatureEncoder`,
  stride 160; registry.py:313-444): ``mockingjay``, ``tera``,
  ``audio_albert`` (models/mockingjay.py), ``apc``, ``vq_apc``
  (models/apc.py) and ``npc`` (models/npc.py), and the MOS predictors
  ``mos_prediction`` / ``mos_wav2vec2``, ``mos_apc`` and ``mos_tera``
  (models/mos.py; registry.py:1044-1106), all on stock ops, which take
  ``dtype``, ``seed``, ``ckpt`` and ``device`` and none of the trunks'
  options;
- the conv, recurrent and windowed families on stock ops (registry.py:
  527-600, :735-880, :981-1038): wav2vec 1.0 / vq-wav2vec
  (models/wav2vec1.py; ``dtype`` f32 or bf16), CPC (models/cpc.py),
  DeCoAR 1 and 2 (models/decoar.py; DeCoAR 2.0 in f32 or bf16), BYOL-A /
  BYOL-S (models/byol.py), their loaders in upstream/convert_zoo.py, and
  the small front ends ``wav``, ``log_stft`` and ``example``;
- the hubconf name surface (upstream/aliases.py, imported at the end of
  this module): the generic loaders, the named checkpoint variants and
  ``baseline_local``;
- the rest of the wav2vec2-style zoo (registry.py:452-477, :883-910,
  :1149-1265, :1483-1539): ``wav2vec2_conformer`` /
  ``wav2vec2_conformer_relpos`` and ``wav2vec2_conformer_rope`` (trunk
  entries), the ESPnet torchaudio HuBERTs (``espnet_hubert`` and its five
  Base names, ``espnet_hubert_large_gs_ll60k`` and the three ``wavlablm``
  names: the L layer outputs), ``distilhubert`` / ``distiller``, the four
  ``lighthubert`` names and the six ``multires_hubert`` names, which raise
  for the keywords their JAX entries take and ignore;
- the rest of the hub (registry.py:641-660, :718-727, :814-852, :914-972,
  :1108-1146, :1273-1470, :1540-1543): ``spec_augment`` (models/baseline.py
  `SpecAugmentFeatures`, nn/specaug.py), ``vggish`` (models/audio_cnn.py),
  the AST family (models/ast.py) and the PaSST names (models/passt.py),
  ``vq_wav2vec_kmeans_roberta`` / ``discretebert`` (models/roberta.py),
  ``pase_plus`` (models/pase.py) and the ``hf_*`` entries (models/wav2vec2.py
  `HfWav2Vec2`, upstream/convert_hf.py), on stock ops but the ``hf_*``
  extractor's K3, their loaders in upstream/convert_zoo.py and
  upstream/convert_hf.py;
the trunks each in f32, bf16 and int8 W8A8 (``quantize=True``, the serving default),
the int8 path with its opt-in fused projections (``qkv_fuse``,
``full_fuse``; ``wavlm_fuse``), the front-end options ``int8_conv`` (HuBERT
int8), ``fused_conv`` and ``fused_midln``, and the pos-conv options
``fused_posconv`` and ``int8_posconv``, each where it can take effect
(`load`). The trunk entries (not WavLM / UniSpeech-SAT, as in the JAX
package) also serve the fused weighted sum, `TrunkUpstream.apply_weighted`.
A model is built on the card (``torch.device("cuda")``) unless
``device=`` says otherwise; without CUDA and without ``device=`` loading
raises rather than building on the CPU. With ``ckpt=`` (a local file:
`load_trunk_checkpoint`, `load_wavlm_checkpoint`) the configuration and
the weights come from the checkpoint; without one the weights are random,
drawn on the CPU from a `torch.Generator` seeded with `seed`, so one seed
gives the same model on every device. With ``quantize`` the encoder's
projections are quantized once, on the CPU from their f32 values, before
the model moves to its device (the JAX package's `_materialize_qcache`,
registry.py:117-148). Nothing is downloaded: ``download=True`` raises.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn as nn

from ..models.apc import APCConfig, APCModel
from ..models.ast import SSAST_FRAME, SSAST_PATCH, ASTConfig, ASTModel
from ..models.audio_cnn import PATCH_FRAMES, VGGish
from ..models.baseline import (BASELINE_CONFIGS, BaselineFeatures, ExampleModel, LogStft,
                               SpecAugmentFeatures, WavPassthrough, mel_ssl_features)
from ..models.byol import (BYOL_A_512, BYOL_A_1024, BYOL_A_2048, BYOL_S_CVT, BYOL_S_DEFAULT,
                           BYOL_S_RESNETISH34, ByolModel, CvtLayerNorm, byol_embedding_size)
from ..models.cpc import ChannelNorm, CPCConfig, CPCModel
from ..models.decoar import Decoar2Config, Decoar2Model, DecoarConfig, DecoarModel
from ..models.distiller import DistillerConfig, DistillerModel, SplitLinear
from ..models.hubert import HUBERT_BASE, HUBERT_LARGE
from ..models.lighthubert import SUBNET_BASE, SUBNET_SMALL, LightHubertConfig, LightHubertModel
from ..models.mockingjay import MockingjayConfig, MockingjayEncoder
from ..models.mos import MosConfig, MosModel
from ..models.multires_hubert import MultiresHubertConfig, MultiresHubertModel
from ..models.npc import NPCConfig, NPCModel
from ..models.pase import PaseConfig, PaseModel
from ..models.passt import PASST_ENTRIES, PasstConfig, PasstModel
from ..models.roberta import UNK, DiscreteBertPipeline, RobertaConfig
from ..models.transformer import EspnetSelfAttention, SelfAttention
from ..models.wav2vec1 import GumbelQuantizer, KmeansQuantizer, Wav2Vec1Config, Wav2Vec1Model
from ..models.wav2vec2 import BASE, LARGE, HfWav2Vec2, Wav2Vec2Config, Wav2Vec2Trunk, card_refusal
from ..models.wavlm import (WAVLM_BASE, WAVLM_BASE_PLUS, WAVLM_LARGE, GatedSelfAttention,
                            WavLMConfig, WavLMModel)
from ..nn.heads import lecun_normal_
from ..nn.upstream import init_params
from .base import TrunkUpstream, Upstream
from .convert import (load_distiller_checkpoint, load_espnet_hubert_checkpoint,
                      load_lighthubert_checkpoint, load_mel_ssl_checkpoint, load_mos_checkpoint,
                      load_multires_hubert_checkpoint, load_trunk_checkpoint,
                      load_wavlm_checkpoint)
from .convert_hf import HF_DEFAULT_ENTRY, hf_config, load_hf_directory
from .convert_zoo import (load_ast_checkpoint, load_byol_checkpoint, load_cpc_checkpoint,
                          load_decoar2_checkpoint, load_decoar_checkpoint, load_passt_checkpoint,
                          load_roberta_checkpoint, load_wav2vec1_checkpoint)

_REGISTRY: Dict[str, Callable[..., Upstream]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def options(only_registered_ckpt: bool = False) -> List[str]:
    """Every registered name, sorted; with `only_registered_ckpt` without
    the generic loaders (``*_local``, ``*_url``, ``*_gdriveid``,
    ``*_custom``), as the JAX package's (registry.py:39-50)."""
    names = sorted(_REGISTRY)
    if only_registered_ckpt:
        names = [n for n in names if not n.endswith(("_local", "_url", "_gdriveid", "_custom"))]
    return names


def load(name: str, **kwargs) -> Upstream:
    """Build a named upstream: ``load(name, dtype=torch.float32, flash=False,
    quantize=False, seed=0, device=None)``. ``device=None`` is the card
    (``"cuda"``); pass ``device="cpu"`` to build on the CPU. The fused int8
    projections of int8 serving (``quantize=True, flash=True``) are opt-in
    keywords, all False by default: ``qkv_fuse`` and ``full_fuse`` on
    HuBERT (K12), ``wavlm_fuse`` on WavLM (K11). The front-end options,
    also False by default: ``int8_conv`` (K13a + K13b; HuBERT with
    ``quantize=True``), ``fused_conv`` (K3 erf + K14) and ``fused_midln``
    (K15). The pos-conv options, also False by default and in every dtype:
    ``fused_posconv`` (K16a) and ``int8_posconv`` (K16b). A keyword that
    cannot take effect raises a ValueError before any weight is made. On
    the Base models (``hubert``, ``hubert_base``, ``wavlm``, ``wavlm_base``,
    ``wavlm_base_plus``): the front-end options raise (the group-norm
    extractor runs no kernel), ``qkv_fuse`` / ``full_fuse`` raise (post-LN
    blocks), ``wavlm_fuse`` works, and the pos-conv options work on the CPU
    but raise for the card, whose kernels take 64 channels a group (768 in
    16 groups is 48). A model bound for the card also raises for
    ``flash=True`` at a head dim other than 64 (every entry has 64; a
    checkpoint may not: XLS-R 1B / 2B have 80 / 120). data2vec's depth-5
    pos-conv stack runs no kernel, so the pos-conv options raise on it;
    ``wavlm_fuse`` raises on WavLM without the gate or the bias.

    ``ckpt``: a local checkpoint (s3prl's converted trunk checkpoints or a
    bare state_dict; Microsoft's WavLM checkpoints for the WavLM and
    UniSpeech-SAT entries; each family's reference layout for the others),
    whose configuration replaces the entry's (a bare state_dict keeps the
    entry's). Every check above runs on that configuration before the model
    is allocated. ``download=True`` raises NotImplementedError: the port
    downloads nothing, and a generic loader given a URL ``ckpt`` raises
    too.

    The stock-op families (the zoo trunks but ESPnet HuBERT's flash, the
    mel-domain and MOS models, wav2vec 1.0 / vq-wav2vec, CPC, DeCoAR 1 / 2,
    BYOL, the small front ends) raise for ``flash``, ``quantize`` and the
    trunk options switched on, which their JAX entries take and ignore, and
    for a ``dtype`` their JAX models cannot take or ignore (f32 only on
    CPC, DeCoAR 1 and BYOL; f32 or bf16 on wav2vec 1.0 and DeCoAR 2.0); a
    keyword no entry takes is a TypeError."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown upstream '{name}'; available: {options()}")
    if kwargs.pop("download", False) and kwargs.get("ckpt") is None:
        raise NotImplementedError(f"download= {NOT_DOWNLOADED}")
    return _REGISTRY[name](**kwargs)


NOT_DOWNLOADED = ("is not ported (it needs upstream/urls.py and util/download.py, ROADMAP.md "
                  "Queue 1 item 11): pass ckpt= with a local checkpoint")


def _device(device) -> torch.device:
    """The model's device: `device` when given, else the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its models on the card; pass "
            'device="cpu" to build on the CPU')
    return torch.device("cuda")


def _normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """LeCun normal (the JAX package's default kernel init), drawn in f32
    and cast, so every dtype rounds the same draw."""
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))


@torch.no_grad()
def _init_trunk(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights in module order with flax's initialisers: LeCun-normal
    matrices, zero biases, unit/zero norms, U[0, 1) mask embedding; WavLM's
    bias table normal(0.02) and gate scale ``grep_a`` ones; the Conformer's
    position biases normal(Dh ** -0.5) and BatchNorm statistics 0 / 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            _normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.ConvTranspose1d):  # [in, out, k]: in * k / stride inputs
            _normal_(m.weight, m.in_channels * m.kernel_size[0] // m.stride[0], gen)
        elif isinstance(m, EspnetSelfAttention) and m.pos_enc_type == "rel_pos":
            for p in (m.pos_bias_u, m.pos_bias_v):
                _normal_(p, p.shape[1], gen)
        elif isinstance(m, SplitLinear):
            _normal_(m.weight, m.weight.shape[1], gen)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, nn.Linear):
            _normal_(m.weight, m.in_features, gen)
        elif isinstance(m, SelfAttention):
            _normal_(m.qkv_weight, m.qkv_weight.shape[1], gen)
            m.qkv_bias.zero_()
            if isinstance(m, GatedSelfAttention) and m.gated:
                m.grep_a.fill_(1.0)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    if hasattr(model, "mask_emb"):
        model.mask_emb.copy_(torch.rand(model.mask_emb.shape, generator=gen))
    return model


def _build_trunk(model: nn.Module, state_dict, seed: int, device: torch.device) -> nn.Module:
    """A model built on "meta" materialised on the CPU with `state_dict`
    (strict; the load hooks build the int8 cache and the options' weights)
    or random weights from `seed` (`_init_trunk`, then `build_qcache` where
    the model has one), then moved to `device` in eval()."""
    model.to_empty(device="cpu")
    if state_dict is None:
        _init_trunk(model, torch.Generator().manual_seed(seed))
        if hasattr(model, "build_qcache"):
            model.build_qcache()
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def _trunk_upstream(name: str, cfg: Wav2Vec2Config, dtype=torch.float32,
                    flash: bool = False, quantize: bool = False, seed: int = 0,
                    device=None, ckpt=None, **fuse) -> Upstream:
    """A trunk model (WavLM for a `WavLMConfig`) on `device` (the card when
    None): from `ckpt`, whose configuration replaces `cfg` (a bare trunk
    state_dict keeps `cfg`), or with random weights from `seed`. ``fuse``:
    the model's fused int8 projection options (`Wav2Vec2Trunk.fuse_options`),
    front-end and pos-conv options, checked before any weight is made, and
    for the card also against its kernels' limits (`card_refusal`). The
    checkpoint's weights are loaded on the CPU (the int8 codes quantized
    there from its f32 weights by the load hooks) before the move."""
    wavlm = isinstance(cfg, WavLMConfig)
    state_dict = None
    if ckpt is not None:  # the JAX package's _trunk_upstream / _wavlm_upstream
        cfg, state_dict = (load_wavlm_checkpoint(ckpt) if wavlm
                           else load_trunk_checkpoint(ckpt, fallback_cfg=cfg))
    model_cls = WavLMModel if wavlm else Wav2Vec2Trunk
    model = model_cls(cfg, dtype=dtype, use_flash=flash, quantize=quantize, device="meta",
                      **fuse)
    device = _device(device)
    if device.type == "cuda":  # the meta model allocated nothing
        card_refusal(cfg, flash, getattr(model.encoder.pos_conv, "option", None))
    model = _build_trunk(model, state_dict, seed, device)
    up_cls = Upstream if wavlm else TrunkUpstream
    return up_cls(name=name, model=model, num_layers=cfg.encoder_layers + 1,
                  hidden_size=cfg.encoder_embed_dim, downsample_rate=cfg.downsample_rate)


# the parameter-free baseline front ends (registry.py:77-101): one "layer",
# the frame shift's stride, the reference yaml configs' feature dims
BASELINE_DIMS = {"fbank": 80 * 3, "fbank_no_cmvn": 80, "mfcc": 13 * 3, "spectrogram": 257,
                 "mel": 80, "linear": 201}


def _baseline_entry(config_name: str):
    def factory(device=None, **overrides) -> Upstream:
        model = BaselineFeatures(config_name, device=_device(device), **overrides)
        return Upstream(name=config_name, model=model, num_layers=1,
                        hidden_size=BASELINE_DIMS[config_name],
                        downsample_rate=model.stride)
    return factory


for _name in BASELINE_CONFIGS:
    _REGISTRY[_name] = _baseline_entry(_name)


# wav2vec2 derives its feature lengths with strict conv arithmetic
# (wav2vec2_model.py:2610-2669), HuBERT with its block-folded rule
W2V2_BASE = replace(BASE, feat_pad_rule="conv")
W2V2_LARGE = replace(LARGE, feat_pad_rule="conv")
# data2vec (registry.py:481-508): post-LN on the layer-norm extractor, the
# depth-5 pos-conv stack (k = 95 // 5 = 19), the projection at any width
DATA2VEC_BASE = Wav2Vec2Config(
    extractor_mode="layer_norm", conv_pos=95, pos_conv_depth=5, layer_norm_first=False,
    normalize=True, dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
    post_extract_proj_always=True, feat_pad_rule="conv")
DATA2VEC_LARGE = replace(DATA2VEC_BASE, encoder_layers=24, encoder_embed_dim=1024,
                         encoder_ffn_embed_dim=4096, encoder_attention_heads=16)


@register("wav2vec2")
@register("wav2vec2_base_960")
def wav2vec2_base(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2", W2V2_BASE, **kwargs)


@register("wav2vec2_large_ll60k")
@register("wav2vec2_large_lv60_cv_swbd_fsh")
def wav2vec2_large(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2_large", W2V2_LARGE, **kwargs)


@register("hubert")
@register("hubert_base")
def hubert_base(**kwargs) -> Upstream:
    return _trunk_upstream("hubert", HUBERT_BASE, **kwargs)


@register("hubert_large_ll60k")
def hubert_large(**kwargs) -> Upstream:
    return _trunk_upstream("hubert_large", HUBERT_LARGE, **kwargs)


@register("data2vec")
@register("data2vec_base_960")
def data2vec_base(**kwargs) -> Upstream:
    return _trunk_upstream("data2vec", DATA2VEC_BASE, **kwargs)


@register("data2vec_large_ll60k")
def data2vec_large(**kwargs) -> Upstream:
    return _trunk_upstream("data2vec_large", DATA2VEC_LARGE, **kwargs)


@register("wavlm")
@register("wavlm_base")
def wavlm_base(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm", WAVLM_BASE, **kwargs)


@register("wavlm_base_plus")
def wavlm_base_plus(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm_base_plus", WAVLM_BASE_PLUS, **kwargs)


@register("wavlm_large")
def wavlm_large(**kwargs) -> Upstream:
    return _trunk_upstream("wavlm_large", WAVLM_LARGE, **kwargs)


# UniSpeech-SAT shares WavLM's gated relative-position architecture
# (registry.py:693-716)
@register("unispeech_sat")
@register("unispeech_sat_base")
def unispeech_sat(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat", WAVLM_BASE, **kwargs)


@register("unispeech_sat_base_plus")
def unispeech_sat_base_plus(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat_base_plus", WAVLM_BASE_PLUS, **kwargs)


@register("unispeech_sat_large")
def unispeech_sat_large(**kwargs) -> Upstream:
    return _trunk_upstream("unispeech_sat_large", WAVLM_LARGE, **kwargs)


# the catalog's aliases (registry.py:1524-1528): without a checkpoint each
# builds its family's default; the published shape comes with ckpt=
for _alias in ("wav2vec2_large_960", "wav2vec2_large_voxpopuli_100k", "xlsr_53",
               "xls_r_300m", "xls_r_1b", "xls_r_2b"):
    _REGISTRY[_alias] = wav2vec2_large
for _alias in ("hubert_base_robust_mgr", "mhubert_base_vp_en_es_fr_it3",
               "contentvec", "contentvec_km100", "contentvec_km500", "ms_hubert"):
    _REGISTRY[_alias] = hubert_base


# -- the rest of the wav2vec2-style zoo (registry.py:452-477, :883-910,
# :1149-1265, :1483-1539)

# wav2vec2-Conformer: 24 layers at 1,024 wide, the layer-norm extractor, the
# conv length rule, an entry LN before the layers (layer_norm_first False)
CONFORMER_BASE = Wav2Vec2Config(
    layer_type="conformer", pos_enc_type="rel_pos", feat_pad_rule="conv",
    extractor_mode="layer_norm", encoder_layers=24, encoder_embed_dim=1024,
    encoder_ffn_embed_dim=4096, encoder_attention_heads=16, normalize=True, dropout=0.0,
    attention_dropout=0.0, dropout_input=0.0)


@register("wav2vec2_conformer")
@register("wav2vec2_conformer_relpos")
def wav2vec2_conformer(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2_conformer", CONFORMER_BASE, **kwargs)


@register("wav2vec2_conformer_rope")
def wav2vec2_conformer_rope(**kwargs) -> Upstream:
    return _trunk_upstream("wav2vec2_conformer_rope", replace(CONFORMER_BASE, pos_enc_type="rope"),
                           **kwargs)


# the keywords of the trunk entries that the stock-path families refuse
_TRUNK_OPTIONS = ("flash", "quantize", "qkv_fuse", "full_fuse", "wavlm_fuse", "int8_conv",
                  "fused_conv", "fused_midln", "fused_posconv", "int8_posconv")


def _refuse_options(name: str, why: str, options: dict) -> None:
    """A TypeError for a keyword no trunk entry takes; a ValueError for a
    trunk option switched on where it cannot take effect (`why`; the JAX
    entries take and ignore them)."""
    unknown = sorted(set(options) - set(_TRUNK_OPTIONS))
    if unknown:
        raise TypeError(f"{name}: unexpected keyword arguments {unknown}")
    on = sorted(k for k, v in options.items() if v)
    if on:
        raise ValueError(f"{', '.join(on)} cannot take effect on {name}: {why} (the JAX entry "
                         "takes and ignores it)")


class LayerOutputs(nn.Module):
    """A trunk's hidden states without the first, L layer outputs
    (torchaudio's ``extract_features`` layout, registry.py:1149-1189)."""

    def __init__(self, trunk: Wav2Vec2Trunk):
        super().__init__()
        self.trunk, self.cfg = trunk, trunk.cfg

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        hs, lens = self.trunk(wavs, wav_lens, generator=generator)
        return hs[1:], lens


def _espnet_hubert_upstream(name: str, default_cfg: Wav2Vec2Config, ckpt=None,
                            model_config=None, dtype=torch.float32, flash: bool = False,
                            seed: int = 0, device=None, **options) -> Upstream:
    """ESPnet's torchaudio HuBERT (registry.py:1149-1189): a trunk from
    `ckpt` (`load_espnet_hubert_checkpoint`, `model_config` its espnet
    config.yaml) or `default_cfg` with random weights from `seed`, whose
    upstream returns the L layer outputs. ``flash`` runs the trunk's
    kernels (K4 / K5 on a pre-LN bf16 model, as HuBERT-Large's bf16 path);
    ``quantize`` and the other trunk options raise."""
    _refuse_options(name, "its entry builds the trunk in its dtype with flash only", options)
    device = _device(device)
    cfg, state_dict = ((default_cfg, None) if ckpt is None
                       else load_espnet_hubert_checkpoint(ckpt, model_config))
    model = Wav2Vec2Trunk(cfg, dtype=dtype, use_flash=flash, device="meta")
    if device.type == "cuda":
        card_refusal(cfg, flash, None)
    model = LayerOutputs(_build_trunk(model, state_dict, seed, device))
    return Upstream(name=name, model=model, num_layers=cfg.encoder_layers,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=320)


@register("espnet_hubert")
@register("espnet_hubert_custom")
@register("espnet_hubert_local")
@register("espnet_hubert_base_iter0")
@register("espnet_hubert_base_iter1")
@register("cvhubert")
def espnet_hubert(**kwargs) -> Upstream:
    return _espnet_hubert_upstream("espnet_hubert", BASE, **kwargs)


@register("espnet_hubert_large_gs_ll60k")
@register("wavlablm_ek_40k")
@register("wavlablm_mk_40k")
@register("wavlablm_ms_40k")
def espnet_hubert_large(**kwargs) -> Upstream:
    return _espnet_hubert_upstream("espnet_hubert_large", LARGE, **kwargs)


def _stock_upstream(name: str, model: nn.Module, state_dict, seed: int, device,
                    num_layers: int, hidden: int, stride: int) -> Upstream:
    return Upstream(name=name, model=_build_trunk(model, state_dict, seed, device),
                    num_layers=num_layers, hidden_size=hidden, downsample_rate=stride)


@register("distilhubert")
@register("distiller")
def distilhubert(ckpt=None, dtype=torch.float32, seed: int = 0, device=None,
                 **options) -> Upstream:
    """DistilHuBERT (registry.py:452-477): `ckpt` through
    `load_distiller_checkpoint`, else the default config from `seed`; 1 +
    L + n_tasks hidden states; stock ops."""
    _refuse_options("distilhubert", "its model runs no kernel", options)
    device = _device(device)
    cfg, state_dict = (DistillerConfig(), None) if ckpt is None else load_distiller_checkpoint(ckpt)
    return _stock_upstream("distilhubert", DistillerModel(cfg, dtype, device="meta"), state_dict,
                           seed, device, 1 + cfg.encoder_layers + cfg.n_tasks,
                           cfg.encoder_embed_dim, cfg.downsample_rate)


def _lighthubert_upstream(name: str, subnet: dict, ckpt=None, dtype=torch.float32,
                          seed: int = 0, device=None, **options) -> Upstream:
    """LightHuBERT (registry.py:1219-1265): `ckpt` sliced to its subnet on
    the host (`load_lighthubert_checkpoint`), else `subnet` from `seed`;
    K3 in the extractor, the layers on stock ops."""
    _refuse_options(name, "its layers run no kernel", options)
    device = _device(device)
    cfg, state_dict = ((LightHubertConfig.of_subnet(subnet), None) if ckpt is None
                       else load_lighthubert_checkpoint(ckpt))
    return _stock_upstream(name, LightHubertModel(cfg, dtype, device="meta"), state_dict, seed,
                           device, cfg.num_layers + 1, cfg.embed_dim, 320)


@register("lighthubert")
@register("lighthubert_base")
@register("lighthubert_stage1")
def lighthubert(**kwargs) -> Upstream:
    return _lighthubert_upstream("lighthubert", SUBNET_BASE, **kwargs)


@register("lighthubert_small")
def lighthubert_small(**kwargs) -> Upstream:
    return _lighthubert_upstream("lighthubert_small", SUBNET_SMALL, **kwargs)


@register("multires_hubert")
@register("multires_hubert_base")
@register("multires_hubert_large")
@register("multires_hubert_multilingual_base")
@register("multires_hubert_multilingual_large400k")
@register("multires_hubert_multilingual_large600k")
def multires_hubert(ckpt=None, dtype=torch.float32, seed: int = 0, device=None,
                    **options) -> Upstream:
    """MR-HuBERT (registry.py:883-910, :1536-1539): `ckpt` through
    `load_multires_hubert_checkpoint`, else the default config from `seed`
    (every name builds it; the published shapes come with ``ckpt=``);
    stock ops."""
    _refuse_options("multires_hubert", "its model runs no kernel", options)
    device = _device(device)
    cfg, state_dict = ((MultiresHubertConfig(), None) if ckpt is None
                       else load_multires_hubert_checkpoint(ckpt))
    return _stock_upstream("multires_hubert", MultiresHubertModel(cfg, dtype, device="meta"),
                           state_dict, seed, device, cfg.num_hidden_states,
                           cfg.encoder_embed_dim, 320)


# -- the mel-domain SSL family (registry.py:313-444): mockingjay / tera /
# audio_albert (BERT-style), apc / vq_apc (GRUs), npc (masked convs). Their
# front ends follow pretrain/*/config_model.yaml: mockingjay fbank 80 + Δ +
# ΔΔ + CMVN (240 dims), the others log-mel 80 + CMVN; stride 160.


class FeatureEncoder(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (the model's hidden states, feat_lens):
    the mel front end (`mel_ssl_features`), then the model, on the model's
    device; in train mode the model's dropouts draw from `generator`.
    ``cfg`` is the model's (for `train_refusal`)."""

    def __init__(self, model: nn.Module, feat_kind: str):
        super().__init__()
        self.model, self.feat_kind, self.cfg = model, feat_kind, model.cfg

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        feats, feat_lens = mel_ssl_features(wavs, wav_lens, self.feat_kind)
        return self.model(feats, feat_lens, generator)[0], feat_lens


@torch.no_grad()
def _init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights for the mel-domain models and the MOS predictor: the
    probes' flax initialisers (`init_params`), the MOS featurizer's weights
    0 and its wav2vec2 trunk as `_init_trunk`."""
    init_params(model, gen)
    if isinstance(model, MosModel):
        model.featurizer_weights.zero_()
        if model.cfg.upstream == "wav2vec2":
            _init_trunk(model.trunk, gen)
    return model


def _build(model: nn.Module, state_dict, seed: int, device: torch.device,
           init=_init_weights) -> nn.Module:
    """A model built on "meta" materialised on the CPU with `state_dict`
    (strict) or random weights from `seed` (`init`), then moved to `device`
    in eval()."""
    model.to_empty(device="cpu")
    if state_dict is None:
        init(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def _f32_only(name: str, dtype) -> None:
    if dtype != torch.float32:
        raise ValueError(f"dtype={dtype} cannot take effect on {name}: its model runs in f32 "
                         "(the JAX package's takes no dtype)")


def _mel_upstream(name: str, feat_kind: str, cfg, num_layers: int, hidden: int,
                  dtype=torch.float32, seed: int = 0, ckpt=None, device=None) -> Upstream:
    """Entry `name`'s model over its mel front end (the JAX package's
    `_feat_encoder_upstream`, registry.py:336-370) on `device` (the card
    when None), from `ckpt` (`load_mel_ssl_checkpoint`) or random weights
    from `seed`. A Mockingjay checkpoint picks its own front end by its
    ``spec_transform`` width (240: fbank + deltas, else log-mel). APC and NPC
    run in f32: another `dtype` raises."""
    device = _device(device)
    state_dict = None
    if ckpt is not None:
        state_dict = load_mel_ssl_checkpoint(name, ckpt)
    if isinstance(cfg, MockingjayConfig):
        if state_dict is not None:
            in_dim = state_dict["input_representations.spec_transform.weight"].shape[1]
            feat_kind = "fbank_delta" if in_dim == 240 else "mel"
            cfg = replace(cfg, input_dim=in_dim)
        model = MockingjayEncoder(cfg, dtype, device="meta")
    else:
        _f32_only(name, dtype)
        model = (APCModel if isinstance(cfg, APCConfig) else NPCModel)(cfg, device="meta")
    model = FeatureEncoder(_build(model, state_dict, seed, device), feat_kind)
    return Upstream(name=name, model=model, num_layers=num_layers, hidden_size=hidden,
                    downsample_rate=160)


@register("mockingjay")
def mockingjay(**kwargs) -> Upstream:
    cfg = MockingjayConfig(input_dim=240)
    return _mel_upstream("mockingjay", "fbank_delta", cfg, cfg.num_hidden_layers + 1,
                         cfg.hidden_size, **kwargs)


@register("tera")
def tera(**kwargs) -> Upstream:
    cfg = MockingjayConfig(input_dim=80)
    return _mel_upstream("tera", "mel", cfg, cfg.num_hidden_layers + 1, cfg.hidden_size,
                         **kwargs)


@register("audio_albert")
def audio_albert(**kwargs) -> Upstream:
    cfg = MockingjayConfig(input_dim=80, share_layer=True)
    return _mel_upstream("audio_albert", "mel", cfg, cfg.num_hidden_layers + 1,
                         cfg.hidden_size, **kwargs)


@register("apc")
def apc(**kwargs) -> Upstream:
    cfg = APCConfig()
    return _mel_upstream("apc", "mel", cfg, cfg.num_layers, cfg.hidden_size, **kwargs)


@register("vq_apc")
def vq_apc(**kwargs) -> Upstream:
    cfg = APCConfig(vq_codebook_size=(512,), vq_code_dim=(512,))
    return _mel_upstream("vq_apc", "mel", cfg, cfg.num_layers, cfg.hidden_size, **kwargs)


@register("npc")
def npc(**kwargs) -> Upstream:
    cfg = NPCConfig()
    return _mel_upstream("npc", "mel", cfg, 2 * cfg.n_blocks + 1, cfg.hidden_size, **kwargs)


# the catalog's checkpoint names (registry.py:1530-1535)
for _alias in ("apc_360hr", "apc_960hr"):
    _REGISTRY[_alias] = apc
for _alias in ("vq_apc_360hr", "vq_apc_960hr"):
    _REGISTRY[_alias] = vq_apc
for _alias in ("npc_360hr", "npc_960hr"):
    _REGISTRY[_alias] = npc


# -- the MOS predictors (registry.py:1044-1106): one score an utterance,
# broadcast over [1, B, T', 1]


def _mos_upstream(name: str, default_cfg: MosConfig, ckpt=None, seed: int = 0,
                  dtype=torch.float32, device=None, **options) -> Upstream:
    """`MosModel` on `device` (the card when None) from `ckpt`
    (`load_mos_checkpoint`, whose configuration replaces `default_cfg`) or
    random weights from `seed`. Its upstream runs the stock paths, so
    ``flash``, ``quantize`` and the trunk options raise (the JAX entry takes
    and ignores them), and an APC upstream's any dtype but f32."""
    if options:
        raise ValueError(f"{', '.join(sorted(options))} cannot take effect on {name}: the MOS "
                         "predictor's upstream runs no kernel")
    device = _device(device)
    cfg, state_dict = (default_cfg, None) if ckpt is None else load_mos_checkpoint(ckpt)
    if cfg.upstream == "apc":
        _f32_only(name, dtype)
    model = _build(MosModel(cfg, dtype, device="meta"), state_dict, seed, device)
    return Upstream(name=name, model=model, num_layers=1, hidden_size=1,
                    downsample_rate=cfg.downsample_rate)


@register("mos_wav2vec2")
@register("mos_prediction")
def mos_prediction(**kwargs) -> Upstream:
    return _mos_upstream("mos_prediction", MosConfig(), **kwargs)


@register("mos_apc")
def mos_apc(**kwargs) -> Upstream:
    return _mos_upstream("mos_apc", MosConfig(upstream="apc", apc=APCConfig()), **kwargs)


@register("mos_tera")
def mos_tera(**kwargs) -> Upstream:
    return _mos_upstream(
        "mos_tera", MosConfig(upstream="tera", tera=MockingjayConfig(input_dim=80)), **kwargs)


# -- the conv, recurrent and windowed families (registry.py:527-562, :603-690,
# :735-810, :855-880, :981-1038): stock ops, no kernel; random weights from
# flax's default initialisers (`_init_flax`)


@torch.no_grad()
def _init_flax(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """flax's default initialisers in module order, drawn on the CPU from
    `gen`: lecun-normal conv and dense kernels (an EncoderLayer's fused QKV
    among them) with zero biases; an RNN's input kernels lecun-normal and
    each gate's recurrent [H, H] orthogonal with zero biases (flax's cells);
    norms ones and zeros (BatchNorm statistics 0 and 1); embeddings
    normal(1 / sqrt(width)); PReLU slopes 0.01; the vq-wav2vec codebooks,
    ChannelNorm and CvT's LayerNorm by their own `reset_parameters`, and a
    model's own tables by its `flax_init_`."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.RNNBase):
            H = m.hidden_size
            for layer in range(m.num_layers):
                lecun_normal_(getattr(m, f"weight_ih_l{layer}"),
                              m.input_size if layer == 0 else H, gen)
                w = getattr(m, f"weight_hh_l{layer}")
                for g in range(w.shape[0] // H):
                    w[g * H:(g + 1) * H].copy_(nn.init.orthogonal_(torch.empty(H, H),
                                                                   generator=gen))
                getattr(m, f"bias_ih_l{layer}").zero_()
                getattr(m, f"bias_hh_l{layer}").zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, (GumbelQuantizer, KmeansQuantizer, ChannelNorm, CvtLayerNorm)):
            m.reset_parameters(gen)
        elif isinstance(m, SelfAttention):  # the fused QKV of an EncoderLayer
            lecun_normal_(m.qkv_weight, m.qkv_weight.shape[1], gen)
            m.qkv_bias.zero_()
        elif isinstance(m, nn.Embedding):  # flax's variance_scaling(1, fan_in, normal)
            width = m.weight.shape[1]
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(width))
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.01)
        if hasattr(m, "flax_init_"):  # a model's own tables (positions, cls, sinc cutoffs)
            m.flax_init_(gen)
    return model


def _model_dtype(name: str, dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype={dtype} cannot take effect on {name}: f32 or bf16")


@register("wav")
def wav(device=None, **options) -> Upstream:
    """The waveform as one [1, B, T, 1] "layer", stride 1 (registry.py:603-618)."""
    _refuse_options("wav", "it has no model", options)
    return Upstream(name="wav", model=WavPassthrough(_device(device)), num_layers=1,
                    hidden_size=1, downsample_rate=1)


@register("log_stft")
def log_stft(device=None, **options) -> Upstream:
    """log(|STFT|^2 + 1e-10), 201 bins, stride 160 (registry.py:626-638)."""
    _refuse_options("log_stft", "it has no model", options)
    return Upstream(name="log_stft", model=LogStft(_device(device)), num_layers=1,
                    hidden_size=201, downsample_rate=160)


@register("example")
def example(device=None, **options) -> Upstream:
    """The contributor template (registry.py:664-690): Dense(64) over log-mel
    80, its weights from seed 0 as the JAX entry's."""
    _refuse_options("example", "its Dense runs no kernel", options)
    model = _build(ExampleModel(device="meta"), None, 0, _device(device), _init_flax)
    return Upstream(name="example", model=model, num_layers=1, hidden_size=64,
                    downsample_rate=160)


# wav2vec 1.0 and vq-wav2vec (registry.py:527-562, :1022-1038): without a
# checkpoint each builds its default; the published shapes come with ckpt=
W2V1 = Wav2Vec1Config()
VQ_WAV2VEC = Wav2Vec1Config(vq_type="gumbel", vq_dim=512)
VQ_WAV2VEC_KMEANS = Wav2Vec1Config(vq_type="kmeans", vq_dim=512)


def _w2v1_upstream(name: str, default_cfg: Wav2Vec1Config, ckpt=None, dtype=torch.float32,
                   seed: int = 0, device=None, **options) -> Upstream:
    """`Wav2Vec1Model` in f32 or bf16 from `ckpt` (`load_wav2vec1_checkpoint`,
    whose config replaces `default_cfg`) or from `seed`: z, the aggregator's
    layer inputs and its output."""
    _refuse_options(name, "its convs run on stock ops", options)
    _model_dtype(name, dtype)
    device = _device(device)
    cfg, state_dict = (default_cfg, None) if ckpt is None else load_wav2vec1_checkpoint(ckpt)
    model = _build(Wav2Vec1Model(cfg, dtype, device="meta"), state_dict, seed, device, _init_flax)
    agg = cfg.conv_aggregator_layers
    return Upstream(name=name, model=model, num_layers=len(agg) + 1, hidden_size=agg[-1][0],
                    downsample_rate=cfg.downsample_rate)


@register("wav2vec")
@register("wav2vec_large")
def wav2vec(**kwargs) -> Upstream:
    return _w2v1_upstream("wav2vec", W2V1, **kwargs)


@register("vq_wav2vec")
@register("vq_wav2vec_gumbel")
def vq_wav2vec(**kwargs) -> Upstream:
    return _w2v1_upstream("vq_wav2vec", VQ_WAV2VEC, **kwargs)


@register("vq_wav2vec_kmeans")
def vq_wav2vec_kmeans(**kwargs) -> Upstream:
    return _w2v1_upstream("vq_wav2vec_kmeans", VQ_WAV2VEC_KMEANS, **kwargs)


CPC = CPCConfig()


@register("cpc")
@register("modified_cpc")
def cpc(ckpt=None, dtype=torch.float32, seed: int = 0, device=None, **options) -> Upstream:
    """Modified CPC (registry.py:855-880): `ckpt` through `load_cpc_checkpoint`
    (its config replaces the default) or from `seed`; z and c; f32."""
    _refuse_options("cpc", "its model runs on stock ops", options)
    _f32_only("cpc", dtype)
    device = _device(device)
    cfg, state_dict = (CPC, None) if ckpt is None else load_cpc_checkpoint(ckpt)
    model = _build(CPCModel(cfg, device="meta"), state_dict, seed, device, _init_flax)
    return Upstream(name="cpc", model=model, num_layers=2, hidden_size=cfg.ar_size,
                    downsample_rate=160)


DECOAR = DecoarConfig()


def _decoar_upstream(name: str, per_layer: bool, ckpt=None, dtype=torch.float32,
                     seed: int = 0, device=None, **options) -> Upstream:
    """DeCoAR 1 (registry.py:981-1020) over fbank 80 + CMVN: the last
    layer's [forward; backward] or, `per_layer`, every layer's; f32."""
    _refuse_options(name, "its LSTMs run on stock ops", options)
    _f32_only(name, dtype)
    device = _device(device)
    cfg = replace(DECOAR, per_layer=per_layer)
    state_dict = None if ckpt is None else load_decoar_checkpoint(ckpt, cfg.num_layers)
    model = _build(DecoarModel(cfg, device="meta"), state_dict, seed, device, _init_flax)
    return Upstream(name=name, model=model, num_layers=cfg.num_layers if per_layer else 1,
                    hidden_size=2 * cfg.hidden, downsample_rate=160)


@register("decoar")
def decoar(**kwargs) -> Upstream:
    return _decoar_upstream("decoar", False, **kwargs)


@register("decoar_layers")
def decoar_layers(**kwargs) -> Upstream:
    return _decoar_upstream("decoar_layers", True, **kwargs)


DECOAR2 = Decoar2Config()


@register("decoar2")
def decoar2(ckpt=None, dtype=torch.float32, seed: int = 0, device=None, **options) -> Upstream:
    """DeCoAR 2.0 (registry.py:564-600) in f32 or bf16: `ckpt` through
    `load_decoar2_checkpoint` (its depth from the checkpoint) or 12 layers
    from `seed`; the trunk options raise."""
    _refuse_options("decoar2", "its JAX model builds its encoder without use_flash or quantize "
                    "(s3prl_tpu/models/decoar2.py:25-29), and its pos-conv (768 channels in 16 "
                    "groups, 48 a group) runs on stock ops: the card's pos-conv kernels take 64 "
                    "channels a group", options)
    _model_dtype("decoar2", dtype)
    device = _device(device)
    cfg, state_dict = (DECOAR2, None) if ckpt is None else load_decoar2_checkpoint(ckpt)
    model = _build_trunk(Decoar2Model(cfg, dtype, device="meta"), state_dict, seed, device)
    return Upstream(name="decoar2", model=model, num_layers=cfg.num_layers + 1, hidden_size=768,
                    downsample_rate=160)


def _byol_upstream(name: str, cfg, ckpt=None, dtype=torch.float32, seed: int = 0, device=None,
                   **options) -> Upstream:
    """BYOL-A / BYOL-S (registry.py:735-810): `ckpt` through
    `load_byol_checkpoint` or from `seed`; one state of a window each,
    stride 1 s (BYOL-A) or 50 ms (BYOL-S); f32."""
    _refuse_options(name, "its model runs on stock ops", options)
    _f32_only(name, dtype)
    device = _device(device)
    state_dict = None if ckpt is None else load_byol_checkpoint(ckpt, cfg)
    model = _build(ByolModel(cfg, device="meta"), state_dict, seed, device, _init_flax)
    return Upstream(name=name, model=model, num_layers=1, hidden_size=byol_embedding_size(cfg),
                    downsample_rate=int(cfg.stride_secs * 16000))


@register("byol_a")
@register("byol_a_2048")
def byol_a(**kwargs) -> Upstream:
    return _byol_upstream("byol_a", BYOL_A_2048, **kwargs)


@register("byol_a_1024")
def byol_a_1024(**kwargs) -> Upstream:
    return _byol_upstream("byol_a_1024", BYOL_A_1024, **kwargs)


@register("byol_a_512")
def byol_a_512(**kwargs) -> Upstream:
    return _byol_upstream("byol_a_512", BYOL_A_512, **kwargs)


@register("byol_s")
@register("byol_s_default")
def byol_s(**kwargs) -> Upstream:
    return _byol_upstream("byol_s", BYOL_S_DEFAULT, **kwargs)


@register("byol_s_resnetish34")
def byol_s_resnetish34(**kwargs) -> Upstream:
    return _byol_upstream("byol_s_resnetish34", BYOL_S_RESNETISH34, **kwargs)


@register("byol_s_cvt")
def byol_s_cvt(**kwargs) -> Upstream:
    return _byol_upstream("byol_s_cvt", BYOL_S_CVT, **kwargs)


# -- the rest of the hub (registry.py:641-660, :718-727, :814-852, :914-972,
# :1108-1146, :1273-1470, :1540-1543): SpecAugment, VGGish, the AST family,
# PaSST, the vq-wav2vec RoBERTa pipeline, PASE+ and the hf_* entries; stock
# ops but the hf_* extractor's K3


def _no_ckpt(name: str, ckpt) -> None:
    if ckpt is not None:
        raise ValueError(f"ckpt cannot take effect on {name}: the JAX entry reads no checkpoint "
                         "(it takes and ignores ckpt)")


@register("spec_augment")
def spec_augment(seed: int = 0, device=None, ckpt=None, **options) -> Upstream:
    """fbank 80 + deltas + CMVN (240 dims, stride 160), masked in train mode
    (registry.py:641-660; `SpecAugmentFeatures`); no weights, so ``ckpt``
    raises (the JAX entry swallows it)."""
    _no_ckpt("spec_augment", ckpt)
    _refuse_options("spec_augment", "it has no model", options)
    return Upstream(name="spec_augment", model=SpecAugmentFeatures(seed, _device(device)).eval(),
                    num_layers=1, hidden_size=240, downsample_rate=160)


@register("vggish")
def vggish(seed: int = 0, device=None, ckpt=None, **options) -> Upstream:
    """VGGish (registry.py:718-727): one 128-wide state a 0.96-s patch,
    stride 96 x 160; f32, random weights from `seed` (the JAX entry reads no
    checkpoint)."""
    _no_ckpt("vggish", ckpt)
    _refuse_options("vggish", "its CNN runs on stock ops", options)
    model = _build(VGGish(device="meta"), None, seed, _device(device), _init_flax)
    return Upstream(name="vggish", model=model, num_layers=1, hidden_size=128,
                    downsample_rate=PATCH_FRAMES * 160)


def _ast_upstream(name: str, cfg: ASTConfig, ckpt=None, dtype=torch.float32, seed: int = 0,
                  device=None, **options) -> Upstream:
    """An AST-family entry (registry.py:814-852) in f32 or bf16: `ckpt`
    through `load_ast_checkpoint` or from `seed`; depth + 1 states, stride
    160 * tstride."""
    _refuse_options(name, "its blocks take eps 1e-6, which no kernel serves", options)
    _model_dtype(name, dtype)
    device = _device(device)
    state_dict = None if ckpt is None else load_ast_checkpoint(ckpt, cfg)
    model = _build(ASTModel(cfg, dtype, device="meta"), state_dict, seed, device, _init_flax)
    return Upstream(name=name, model=model, num_layers=cfg.depth + 1, hidden_size=cfg.embed_dim,
                    downsample_rate=160 * cfg.tstride)


@register("ssast_patch_base")
@register("ast")
def ssast_patch(**kwargs) -> Upstream:
    return _ast_upstream("ssast_patch", SSAST_PATCH, **kwargs)


@register("ssast_frame_base")
@register("mae_ast")
def ssast_frame(**kwargs) -> Upstream:
    return _ast_upstream("ssast_frame", SSAST_FRAME, **kwargs)


# the catalog's MAE-AST names (registry.py:1540-1543)
_REGISTRY["mae_ast_patch"] = ssast_patch
_REGISTRY["mae_ast_frame"] = ssast_frame


def _passt_upstream(name: str, cfg: PasstConfig, ckpt=None, dtype=torch.float32, seed: int = 0,
                    device=None, **options) -> Upstream:
    """A PaSST entry (registry.py:1273-1298) in f32 or bf16: `ckpt` through
    `load_passt_checkpoint` or from `seed`; one state of the configuration's
    embedding size every 50 ms."""
    _refuse_options(name, "its blocks take eps 1e-6, which no kernel serves", options)
    _model_dtype(name, dtype)
    device = _device(device)
    state_dict = None if ckpt is None else load_passt_checkpoint(ckpt, cfg)
    model = _build(PasstModel(cfg, dtype, device="meta"), state_dict, seed, device, _init_flax)
    return Upstream(name=name, model=model, num_layers=1, hidden_size=cfg.embedding_size,
                    downsample_rate=int(cfg.timestamp_hop_ms * 16))


def _passt_entry(name: str):
    def factory(**kwargs) -> Upstream:
        return _passt_upstream(name, PASST_ENTRIES[name], **kwargs)
    factory.__name__ = name
    return factory


for _name in PASST_ENTRIES:
    _REGISTRY[_name] = _passt_entry(_name)
_REGISTRY["passt"] = _REGISTRY["passt_base"]


@register("vq_wav2vec_kmeans_roberta")
@register("discretebert")
def vq_wav2vec_kmeans_roberta(ckpt=None, frontend_ckpt=None, seed: int = 0,
                              dtype=torch.float32, device=None, **options) -> Upstream:
    """vq-wav2vec k-means codes -> RoBERTa (registry.py:1378-1470; models/
    roberta.py): `ckpt` an s3prl-converted RoBERTa checkpoint
    (`load_roberta_checkpoint`; its dictionary gives the code-pair lookup,
    else every pair is <unk>), `frontend_ckpt` a vq-wav2vec k-means one
    (`load_wav2vec1_checkpoint`); what neither gives is drawn from `seed`
    (RoBERTa at 4 layers over the dense lookup 4 + a V + b). f32, as the
    JAX pipeline (which takes and ignores ``dtype``)."""
    _refuse_options("vq_wav2vec_kmeans_roberta", "its RoBERTa and vq-wav2vec run on stock ops",
                    options)
    _f32_only("vq_wav2vec_kmeans_roberta", dtype)
    device = _device(device)
    w2v_cfg, w2v_sd = ((VQ_WAV2VEC_KMEANS, None) if frontend_ckpt is None
                       else load_wav2vec1_checkpoint(frontend_ckpt))
    V = w2v_cfg.vq_vars
    if ckpt is not None:
        rob_cfg, rob_sd, lookup = load_roberta_checkpoint(ckpt)
        if lookup is None:
            lookup = np.full((V, V), UNK, np.int64)
    else:
        rob_cfg, rob_sd = RobertaConfig(num_layers=4, vocab_size=V * V + 5), None
        lookup = np.minimum(4 + np.arange(V * V).reshape(V, V), rob_cfg.vocab_size - 1)
    model = DiscreteBertPipeline(w2v_cfg, rob_cfg, device="meta")
    model.to_empty(device="cpu")
    _init_flax(model, torch.Generator().manual_seed(seed))
    for part, state_dict in ((model.w2v, w2v_sd), (model.roberta, rob_sd)):
        if state_dict is not None:
            part.load_state_dict(state_dict, strict=True)
    model.set_lookup(lookup)
    return Upstream(name="vq_wav2vec_kmeans_roberta", model=model.to(device).eval(),
                    num_layers=rob_cfg.num_layers + 1, hidden_size=rob_cfg.hidden_size,
                    downsample_rate=160)


@register("pase_plus")
def pase_plus(ckpt=None, seed: int = 0, dtype=torch.float32, device=None,
              **options) -> Upstream:
    """PASE+ (registry.py:1108-1146; models/pase.py) from `seed`: nine
    256-wide states at stride 160, computed in f32 and cast to `dtype` (f32
    or bf16). A ``ckpt`` raises NotImplementedError, as the JAX entry's."""
    _refuse_options("pase_plus", "its model runs on stock ops", options)
    if ckpt is not None:
        raise NotImplementedError(
            "pase_plus: converting a checkpoint needs the external pase package's artifact "
            "layout, which neither package reads (s3prl_tpu/upstream/registry.py:1122-1127)")
    _model_dtype("pase_plus", dtype)
    model = _build(PaseModel(PaseConfig(), dtype, device="meta"), None, seed, _device(device),
                   _init_flax)
    return Upstream(name="pase_plus", model=model, num_layers=9, hidden_size=model.cfg.emb_dim,
                    downsample_rate=160)


def _hf_upstream(name: str, ckpt=None, seed: int = 0, dtype=torch.float32, device=None,
                 **options) -> Upstream:
    """transformers' wav2vec2 / HuBERT on the port's trunk (registry.py:
    914-972; `HfWav2Vec2`): `ckpt` a local directory (`load_hf_directory`),
    else transformers' Wav2Vec2Config(do_stable_layer_norm=True,
    feat_extract_norm="layer") from `seed`: 12 x 768, 13 states, stride
    320; f32, K3 in the extractor; eval computation in train mode too."""
    _refuse_options(name, "its layers run transformers' computation on stock ops (the JAX entry "
                    "runs FlaxWav2Vec2Model)", options)
    _f32_only(name, dtype)
    device = _device(device)
    cfg, state_dict = ((hf_config(HF_DEFAULT_ENTRY), None) if ckpt is None
                       else load_hf_directory(ckpt))
    model = _build_trunk(HfWav2Vec2(cfg, device="meta"), state_dict, seed, device)
    return Upstream(name=name, model=model, num_layers=cfg.encoder_layers + 1,
                    hidden_size=cfg.encoder_embed_dim, downsample_rate=cfg.downsample_rate)


@register("hf_wav2vec2")
@register("hf_wav2vec2_custom")
def hf_wav2vec2(**kwargs) -> Upstream:
    return _hf_upstream("hf_wav2vec2", **kwargs)


@register("hf_hubert")
@register("hf_hubert_custom")
def hf_hubert(**kwargs) -> Upstream:
    """HuBERT directories ride the same wav2vec2 model (registry.py:966-972)."""
    return _hf_upstream("hf_hubert", **kwargs)


# the hubconf name surface on top of these entries (the JAX package imports it
# in upstream/__init__.py; here nn.upstream imports upstream.base while the
# models import nn, so the registry registers it when it is imported)
from . import aliases  # noqa: E402,F401
