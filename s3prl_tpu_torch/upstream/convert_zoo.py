"""Checkpoints and JAX parameters of the conv, recurrent and windowed
families, the patch transformers (AST, PaSST), VGGish, RoBERTa and PASE+
-> the port's state_dicts (port of s3prl_tpu/upstream/convert.py:621-804,
:1119-1201, :1303-1436, :1595-1788).

The models keep the reference's keys (`models.wav2vec1`, `models.cpc`,
`models.decoar`, `models.byol`), so each loader reads the keys the JAX
loader reads and hands them on, f32, with three rewrites:
- flax's recurrent cells have one bias where torch's have two: an LSTM's
  two biases are summed into ``bias_hh`` (``bias_ih`` zeros), a GRU's r / z
  biases into ``bias_ih`` (their ``bias_hh`` zeros, n's kept), as the JAX
  converter sums them (convert.py:721-764);
- DeCoAR's one 4-layer ``forward_lstm`` / ``backward_lstm`` is renamed to
  decoar_layers' ``forward_lstms.{i}`` / ``backward_lstms.{i}``;
- DeCoAR 2.0's pos-conv weight norm is folded (`_pos_conv_keys`).
The AST, PaSST and RoBERTa models run the port's `EncoderLayer`, so their
loaders rename timm's blocks (``norm1``, ``attn.qkv`` split into q / k / v,
``attn.proj``, ``norm2``, ``mlp.fc1`` / ``fc2``) and fairseq RoBERTa's
``layernorm_embedding`` onto its keys, as the JAX converters map them onto
the JAX EncoderLayer. Where the JAX loader reads a checkpoint its model then cannot apply, the
port's raises at load and says so. Nothing is downloaded; a native msgpack
checkpoint raises (`_torch_load`).

`*_state_dict_from_jax` map the JAX package's trees onto the same keys
(the inverses of its `*_from_torch`).
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.ast import ASTConfig, ASTModel
from ..models.audio_cnn import STAGES as VGGISH_STAGES
from ..models.byol import ByolConfig, ByolModel, CvT
from ..models.cpc import CPCConfig, CPCModel
from ..models.decoar import Decoar2Config
from ..models.pase import PaseConfig
from ..models.passt import PasstConfig, PasstModel
from ..models.roberta import PAD, RobertaConfig
from ..models.wav2vec1 import W2V1_AGG_LAYERS, W2V1_FEATURE_LAYERS, Wav2Vec1Config, Wav2Vec1Model
from .convert import (_conv, _encoder, _encoder_keys, _linear, _lstm_cell, _norm, _pos_conv_keys,
                      _t, _tensor, _torch_load)


def _model_keys(model: torch.nn.Module):
    return list(model.state_dict(keep_vars=True))


def _picked(sd: Dict[str, Any], keys) -> Dict[str, torch.Tensor]:
    """`keys` of sd as f32 tensors; a BatchNorm's missing
    ``num_batches_tracked`` as 0."""
    return {key: torch.as_tensor(sd.get(key, 0), dtype=torch.int64)
            if key.endswith("num_batches_tracked") else _t(sd[key]) for key in keys}


def _fold_lstm(out: Dict[str, torch.Tensor], base: str, layer: int) -> None:
    """An LSTM layer's two biases summed into ``bias_hh`` (``bias_ih`` 0)."""
    b_ih, b_hh = out[f"{base}bias_ih_l{layer}"], out[f"{base}bias_hh_l{layer}"]
    out[f"{base}bias_hh_l{layer}"] = b_ih + b_hh
    out[f"{base}bias_ih_l{layer}"] = torch.zeros_like(b_ih)


def _fold_gru(out: Dict[str, torch.Tensor], base: str, layer: int) -> None:
    """A GRU layer's r / z biases summed into ``bias_ih`` (``bias_hh`` 0
    there); n's biases as they are."""
    b_ih, b_hh = out[f"{base}bias_ih_l{layer}"], out[f"{base}bias_hh_l{layer}"]
    rz = slice(0, 2 * b_ih.shape[0] // 3)
    b_ih, b_hh = b_ih.clone(), b_hh.clone()
    b_ih[rz] += b_hh[rz]
    b_hh[rz] = 0.0
    out[f"{base}bias_ih_l{layer}"], out[f"{base}bias_hh_l{layer}"] = b_ih, b_hh


def _conv2d(kernel) -> torch.Tensor:
    """A flax 2-D conv kernel [kh, kw, in, out] -> a Conv2d weight."""
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


# -- wav2vec 1.0 / vq-wav2vec ---------------------------------------------------


def w2v1_config_from_model_cfg(model_cfg: Dict[str, Any]) -> Wav2Vec1Config:
    """A `Wav2Vec1Config` of an s3prl-converted ``model_cfg`` (fairseq's
    Wav2VecConfig fields; a copy of convert.py:670-702)."""

    def layers(key, default):
        value = model_cfg.get(key, default)
        if isinstance(value, str):
            value = ast.literal_eval(value)
        return tuple(tuple(c) for c in value)

    return Wav2Vec1Config(
        conv_feature_layers=layers("conv_feature_layers", W2V1_FEATURE_LAYERS),
        conv_aggregator_layers=layers("conv_aggregator_layers", W2V1_AGG_LAYERS),
        log_compression=bool(model_cfg.get("log_compression", True)),
        skip_connections_feat=bool(model_cfg.get("skip_connections_feat", False)),
        skip_connections_agg=bool(model_cfg.get("skip_connections_agg", True)),
        residual_scale=float(model_cfg.get("residual_scale", 0.5)),
        non_affine_group_norm=bool(model_cfg.get("non_affine_group_norm", False)),
        agg_zero_pad=bool(model_cfg.get("agg_zero_pad", False)),
        conv_bias=not bool(model_cfg.get("no_conv_bias", False)),
        vq_type=str(model_cfg.get("vq_type", "none")),
        vq_vars=int(model_cfg.get("vq_vars", 320)),
        vq_groups=int(model_cfg.get("vq_groups", 2)),
        vq_dim=int(model_cfg.get("vq_dim", 0)),
        vq_depth=int(model_cfg.get("vq_depth", 1)),
        combine_groups=bool(model_cfg.get("combine_groups", False)),
    )


def load_wav2vec1_checkpoint(path) -> Tuple[Wav2Vec1Config, Dict[str, torch.Tensor]]:
    """An s3prl-converted wav2vec / vq-wav2vec checkpoint ``{"task_cfg",
    "model_cfg", "model_weight"}`` (or a bare state_dict, with the default
    config) -> (config, the port's state_dict): the extractor's and the
    aggregator's convs and norms, the residual projections and the
    quantizer (convert.py:621-720)."""
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict) and "model_weight" in ckpt:
        sd, cfg = ckpt["model_weight"], w2v1_config_from_model_cfg(ckpt.get("model_cfg", {}))
    else:
        sd, cfg = ckpt, w2v1_config_from_model_cfg({})
    return cfg, _picked(sd, _model_keys(Wav2Vec1Model(cfg, device="meta")))


def wav2vec1_state_dict_from_jax(params: Dict[str, Any], cfg: Wav2Vec1Config
                                 ) -> Dict[str, torch.Tensor]:
    """JAX Wav2Vec1Model params -> the port's state_dict (the inverse of
    convert.py `wav2vec1_params_from_torch`)."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.0.weight"] = _conv(p[f"feat_conv_{i}"]["kernel"])
        if f"feat_gn_{i}" in p:
            _norm(sd, f"{pre}.2", p[f"feat_gn_{i}"])
    for i in range(len(cfg.conv_aggregator_layers)):
        pre = f"feature_aggregator.conv_layers.{i}"
        conv = p[f"agg_conv_{i}"]
        sd[f"{pre}.1.weight"] = _conv(conv["kernel"])
        if "bias" in conv:
            sd[f"{pre}.1.bias"] = _tensor(conv["bias"])
        if f"agg_gn_{i}" in p:
            _norm(sd, f"{pre}.3", p[f"agg_gn_{i}"])
        if f"agg_rproj_{i}" in p:
            sd[f"feature_aggregator.residual_proj.{i}.weight"] = _conv(
                p[f"agg_rproj_{i}"]["kernel"])
    vq = p.get("vq")
    if vq is not None and "vars" in vq:
        sd["vector_quantizer.vars"] = _tensor(vq["vars"])
        depth = sum(k.startswith("weight_proj_") for k in vq) + 1
        if depth == 1:
            _linear(sd, "vector_quantizer.weight_proj", vq["weight_proj"])
        else:
            for i in range(depth - 1):
                _linear(sd, f"vector_quantizer.weight_proj.{i}.0", vq[f"weight_proj_{i}"])
            _linear(sd, f"vector_quantizer.weight_proj.{depth - 1}", vq["weight_proj"])
    elif vq is not None:
        sd["vector_quantizer.embedding"] = _tensor(vq["embedding"])
        sd["vector_quantizer.projection.0.weight"] = _conv(vq["projection"]["kernel"])
        _norm(sd, "vector_quantizer.projection.1", vq["proj_gn"])
    return sd


# -- CPC -----------------------------------------------------------------------------


def load_cpc_checkpoint(path) -> Tuple[CPCConfig, Dict[str, torch.Tensor]]:
    """A FAIR CPC checkpoint ``{"config", "weights"}`` (cpc/expert.py:27-34)
    -> (config, the port's state_dict): the encoder's convs and
    ChannelNorms, ``gAR.baseNet``'s layers with their biases folded
    (convert.py:767-804). An ``arMode`` RNN checkpoint raises: the JAX
    loader maps its tanh RNN through the GRU layout, which its model then
    cannot apply."""
    ckpt = _torch_load(path)
    config = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}
    sd = ckpt.get("weights", ckpt) if isinstance(ckpt, dict) else ckpt
    cfg = CPCConfig(hidden_size=int(config.get("hiddenEncoder", 256)),
                    ar_size=int(config.get("hiddenGar", 256)),
                    ar_layers=int(config.get("nLevelsGRU", 1)),
                    ar_mode=str(config.get("arMode", "LSTM")).lower())
    if cfg.ar_mode == "rnn":
        raise ValueError(
            f"{path}: an arMode RNN checkpoint; the JAX loader maps its tanh RNN through the "
            "GRU layout (s3prl_tpu/upstream/convert.py:762-764), which its SimpleCell model "
            "cannot apply")
    out = _picked(sd, _model_keys(CPCModel(cfg, device="meta")))
    fold = _fold_lstm if cfg.ar_mode == "lstm" else _fold_gru
    for k in range(cfg.ar_layers):
        fold(out, "gAR.baseNet.", k)
    return cfg, out


def cpc_state_dict_from_jax(params: Dict[str, Any], cfg: CPCConfig) -> Dict[str, torch.Tensor]:
    """JAX CPCModel params -> the port's state_dict: ``conv_{i}``,
    ``norm_{i}`` ([C] -> [1, C, 1]) and each ``ar_{k}`` cell (LSTM, GRU or
    flax's tanh SimpleCell, ``i`` with a bias and ``h`` without) as layer k
    of ``gAR.baseNet``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        sd[f"gEncoder.conv{i}.weight"] = _conv(p[f"conv_{i}"]["kernel"])
        sd[f"gEncoder.conv{i}.bias"] = _tensor(p[f"conv_{i}"]["bias"])
        sd[f"gEncoder.batchNorm{i}.weight"] = _tensor(p[f"norm_{i}"]["scale"]).view(1, -1, 1)
        sd[f"gEncoder.batchNorm{i}.bias"] = _tensor(p[f"norm_{i}"]["bias"]).view(1, -1, 1)
    base = "gAR.baseNet."
    for k in range(cfg.ar_layers):
        cell = p[f"ar_{k}"]
        if cfg.ar_mode == "lstm":
            _lstm_cell(sd, base, "", cell, layer=k)
            continue
        gates = "rzn" if cfg.ar_mode == "gru" else ("",)
        kernels = lambda kind: np.concatenate(  # noqa: E731
            [np.asarray(cell[f"{kind}{g}"]["kernel"]) for g in gates], axis=1).T
        sd[f"{base}weight_ih_l{k}"] = _tensor(kernels("i"))
        sd[f"{base}weight_hh_l{k}"] = _tensor(kernels("h"))
        b_ih = np.concatenate([np.asarray(cell[f"i{g}"]["bias"]) for g in gates])
        b_hh = np.zeros_like(b_ih)
        if cfg.ar_mode == "gru":
            b_hh[2 * b_hh.size // 3:] = np.asarray(cell["hn"]["bias"])
        sd[f"{base}bias_ih_l{k}"], sd[f"{base}bias_hh_l{k}"] = _tensor(b_ih), _tensor(b_hh)
    return sd


# -- DeCoAR 1 and 2 ------------------------------------------------------------------


def load_decoar_checkpoint(path, num_layers: int = 4) -> Dict[str, torch.Tensor]:
    """A DeCoAR checkpoint ``{"model"}`` (or a bare state_dict) in decoar's
    keys (one 4-layer ``forward_lstm`` / ``backward_lstm``) or
    decoar_layers' (``forward_lstms.{i}`` / ``backward_lstms.{i}``) -> the
    port's state_dict, the LSTM biases folded (convert.py:1119-1147)."""
    ckpt = _torch_load(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {k: _t(sd[k]) for k in ("post_extract_proj.weight", "post_extract_proj.bias")}
    for direction in ("forward", "backward"):
        for i in range(num_layers):
            base = f"{direction}_lstms.{i}."
            for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = (f"{direction}_lstm.{kind}_l{i}" if f"forward_lstm.weight_ih_l{i}" in sd
                       else f"{base}{kind}_l0")
                out[f"{base}{kind}_l0"] = _t(sd[key])
            _fold_lstm(out, base, 0)
    return out


def decoar_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DecoarModel params -> the port's state_dict: ``fwd_{i}`` /
    ``bwd_{i}`` -> ``forward_lstms.{i}`` / ``backward_lstms.{i}``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "post_extract_proj", p["post_extract_proj"])
    i = 0
    while f"fwd_{i}" in p:
        _lstm_cell(sd, f"forward_lstms.{i}.", "", p[f"fwd_{i}"])
        _lstm_cell(sd, f"backward_lstms.{i}.", "", p[f"bwd_{i}"])
        i += 1
    return sd


def load_decoar2_checkpoint(path) -> Tuple[Decoar2Config, Dict[str, torch.Tensor]]:
    """A DeCoAR 2.0 checkpoint ``{"model"}`` (or a bare state_dict) -> (its
    config, the depth counted from ``encoder.layers.{i}.fc1``; the port's
    state_dict): ``post_extract_proj``, the pos-conv with its weight norm
    folded, the encoder LN and the layers (convert.py:1148-1201)."""
    ckpt = _torch_load(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    depth = 0
    while f"encoder.layers.{depth}.fc1.weight" in sd:
        depth += 1
    out = {f"post_extract_proj.{kind}": _t(sd[f"post_extract_proj.{kind}"])
           for kind in ("weight", "bias")}
    _pos_conv_keys(out, sd)
    _encoder_keys(out, sd, depth)
    return Decoar2Config(num_layers=depth), out


def decoar2_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Decoar2Model params -> the port's state_dict (the encoder's
    stacked layers unstacked, `_encoder`)."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "post_extract_proj", p["post_extract_proj"])
    enc = p["encoder"]
    _encoder(sd, enc["pos_conv"], enc["layer_norm"], enc["layers"])
    return sd


# -- BYOL-A / BYOL-S -------------------------------------------------------------------

_NTT_KEY = re.compile(r"(^fc\.|\.fc\.|^features\.|\.features\.)")


def load_byol_checkpoint(path, cfg: ByolConfig) -> Dict[str, torch.Tensor]:
    """A BYOL-A / BYOL-S checkpoint (a state_dict, or one under
    ``"state_dict"``) -> the port's `ByolModel` state_dict: AudioNTT2020's
    ``features.*`` / ``fc.*`` wherever their wrapper put them (byol_a.py:60-77),
    ResNetish34's and CvT's keys as they are, with their BatchNorm
    statistics. Its encoder is told by the JAX loader's rule
    (convert.py:1712-1721); one other than `cfg`'s raises (the JAX model
    would fail at apply)."""
    sd = _torch_load(path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    kind = ("resnetish34" if any(k.startswith("layer1.") for k in sd) else
            "cvt" if any(".to_q." in k for k in sd) else "ntt")
    if kind != cfg.encoder:
        raise ValueError(f"{path}: a {kind} checkpoint, and this entry's window encoder is "
                         f"{cfg.encoder}")
    if kind == "ntt":
        normalised = {}
        for k, v in sd.items():
            m = _NTT_KEY.search(k)
            if m is not None:
                normalised[k[m.start():].lstrip(".")] = v
        sd = normalised
    keys = [k[len("net."):] for k in _model_keys(ByolModel(cfg, device="meta"))]
    return {f"net.{k}": v for k, v in _picked(sd, keys).items()}


# a BasicBlock's flax (conv, BatchNorm) names and their keys
_BLOCK_KEYS = (("conv1", "bn1", "conv1", "bn1"), ("conv2", "bn2", "conv2", "bn2"),
               ("down_conv", "down_bn", "downsample.0", "downsample.1"))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params, stats) -> None:
    _norm(sd, prefix, params)
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _conv2d_keys(sd: Dict[str, torch.Tensor], prefix: str, conv) -> None:
    sd[f"{prefix}.weight"] = _conv2d(conv["kernel"])
    if "bias" in conv:
        sd[f"{prefix}.bias"] = _tensor(conv["bias"])


def byol_state_dict_from_jax(variables: Dict[str, Any], cfg: ByolConfig
                             ) -> Dict[str, torch.Tensor]:
    """JAX ByolModel variables ({"params", "batch_stats"}, the encoder under
    "net") -> the port's state_dict (the inverses of convert.py
    `byol_variables_from_torch`, `resnetish34_variables_from_torch` and
    `cvt_variables_from_torch`)."""
    p, s = variables["params"]["net"], variables.get("batch_stats", {}).get("net", {})
    sd: Dict[str, torch.Tensor] = {}
    if cfg.encoder == "ntt":
        for i in range(3):
            _conv2d_keys(sd, f"net.features.{4 * i}", p[f"conv_{i}"])
            _bn(sd, f"net.features.{4 * i + 1}", p[f"bn_{i}"], s[f"bn_{i}"])
        _linear(sd, "net.fc.0", p["fc1"])
        _linear(sd, "net.fc.3", p["fc2"])
    elif cfg.encoder == "resnetish34":
        _conv2d_keys(sd, "net.conv1", p["conv1"])
        _bn(sd, "net.bn1", p["bn1"], s["bn1"])
        for name, block in p.items():
            if not name.startswith("layer"):
                continue
            li, b = name[len("layer"):].split("_")
            pre = f"net.layer{li}.{b}"
            for conv, bn, conv_key, bn_key in _BLOCK_KEYS:
                if conv in block:
                    _conv2d_keys(sd, f"{pre}.{conv_key}", block[conv])
                    _bn(sd, f"{pre}.{bn_key}", block[bn], s[name][bn])
    else:
        for si in range(len(CvT.STAGES)):
            stage = f"net.layers.{si}"
            _conv2d_keys(sd, f"{stage}.0", p[f"s{si}_embed"])
            _cvt_ln(sd, f"{stage}.1", p[f"s{si}_ln"])
            d = 0
            while f"s{si}_attn{d}" in p:
                base = f"{stage}.2.layers.{d}"
                attn, astats = p[f"s{si}_attn{d}"], s[f"s{si}_attn{d}"]
                _cvt_ln(sd, f"{base}.0.norm", p[f"s{si}_attn{d}_norm"])
                for proj in ("to_q", "to_kv"):
                    _conv2d_keys(sd, f"{base}.0.fn.{proj}.net.0", attn[proj]["dw"])
                    _bn(sd, f"{base}.0.fn.{proj}.net.1", attn[proj]["bn"], astats[proj]["bn"])
                    _conv2d_keys(sd, f"{base}.0.fn.{proj}.net.2", attn[proj]["pw"])
                _conv2d_keys(sd, f"{base}.0.fn.to_out.0", attn["to_out"])
                _cvt_ln(sd, f"{base}.1.norm", p[f"s{si}_ff{d}_norm"])
                _conv2d_keys(sd, f"{base}.1.fn.net.0", p[f"s{si}_ff{d}"]["fc1"])
                _conv2d_keys(sd, f"{base}.1.fn.net.3", p[f"s{si}_ff{d}"]["fc2"])
                d += 1
    return sd


def _cvt_ln(sd: Dict[str, torch.Tensor], prefix: str, ln) -> None:
    sd[f"{prefix}.g"] = _tensor(ln["g"]).view(1, -1, 1, 1)
    sd[f"{prefix}.b"] = _tensor(ln["b"]).view(1, -1, 1, 1)


# -- the patch transformers, VGGish, RoBERTa and PASE+ (convert.py:1303-1436,
# :1722-1788) ------------------------------------------------------------------


def _check_shapes(sd: Dict[str, torch.Tensor], model: torch.nn.Module, path) -> None:
    """Raises where a checkpoint's tensor has another shape than the entry's
    model takes: the JAX loader reads it and its model then fails at apply."""
    want = model.state_dict(keep_vars=True)
    bad = [f"{k} {tuple(v.shape)} (the model's {tuple(want[k].shape)})"
           for k, v in sd.items() if k in want and tuple(v.shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"{path}: {', '.join(bad)}; the JAX loader reads this checkpoint and "
                         "its model then fails at apply")


def _timm_block(out: Dict[str, torch.Tensor], sd: Dict[str, Any], src: str, dst: str) -> None:
    """A timm ViT block ``src`` (norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2) -> the port's `EncoderLayer` keys under ``dst``; the fused qkv
    rows split into q, k and v."""
    for a, b in (("norm1", "self_attn_layer_norm"), ("attn.proj", "self_attn.out_proj"),
                 ("norm2", "final_layer_norm"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
        for kind in ("weight", "bias"):
            out[f"{dst}.{b}.{kind}"] = _t(sd[f"{src}.{a}.{kind}"])
    for kind in ("weight", "bias"):
        for name, part in zip("qkv", _t(sd[f"{src}.attn.qkv.{kind}"]).chunk(3)):
            out[f"{dst}.self_attn.{name}_proj.{kind}"] = part


def _layer_from_jax(sd: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]) -> None:
    """A JAX EncoderLayer's params -> the port's `EncoderLayer` keys."""
    qkv = p["self_attn"]["qkv"]
    C = np.shape(qkv["kernel"])[0]
    w, b = np.asarray(qkv["kernel"]), np.asarray(qkv["bias"])
    for j, name in enumerate("qkv"):
        sd[f"{prefix}.self_attn.{name}_proj.weight"] = _tensor(w[:, j * C:(j + 1) * C].T)
        sd[f"{prefix}.self_attn.{name}_proj.bias"] = _tensor(b[j * C:(j + 1) * C])
    _linear(sd, f"{prefix}.self_attn.out_proj", p["self_attn"]["out_proj"])
    _norm(sd, f"{prefix}.self_attn_layer_norm", p["self_attn_layer_norm"])
    _linear(sd, f"{prefix}.fc1", p["fc1"])
    _linear(sd, f"{prefix}.fc2", p["fc2"])
    _norm(sd, f"{prefix}.final_layer_norm", p["final_layer_norm"])


def _nested(ckpt, keys) -> Dict[str, Any]:
    """The state_dict of a checkpoint: itself when a key holds
    ``patch_embed``, else the first of `keys` that holds a dict."""
    if isinstance(ckpt, dict) and not any("patch_embed" in k for k in ckpt):
        for key in keys:
            if isinstance(ckpt.get(key), dict):
                return ckpt[key]
    return ckpt


def ast_state_dict_from_torch(sd: Dict[str, Any], cfg: ASTConfig) -> Dict[str, torch.Tensor]:
    """A timm-format AST / SSAST state_dict (bare or under the reference's
    ``v.``) -> the port's `ASTModel` keys (convert.py:1400-1434). The patch
    conv's weight is taken as it is, its first kernel axis on time, as the
    JAX converter transposes it."""
    if any(k.startswith("v.") for k in sd):
        sd = {**{k[2:]: v for k, v in sd.items() if k.startswith("v.")},
              **{k: v for k, v in sd.items() if not k.startswith("v.")}}
    out = {"encoder.patch_embed.weight": _t(sd["patch_embed.proj.weight"]),
           "encoder.patch_embed.bias": _t(sd["patch_embed.proj.bias"]),
           "encoder.cls_token": _t(sd["cls_token"]).reshape(1, 1, -1),
           "encoder.pos_embed": _t(sd["pos_embed"]),
           "encoder.norm.weight": _t(sd["norm.weight"]), "encoder.norm.bias": _t(sd["norm.bias"])}
    for i in range(cfg.depth):
        _timm_block(out, sd, f"blocks.{i}", f"encoder.blocks.{i}")
    return out


def load_ast_checkpoint(path, cfg: ASTConfig) -> Dict[str, torch.Tensor]:
    """An AST / SSAST / MAE-AST checkpoint -> the port's state_dict
    (convert.py:1770-1788): a timm state_dict, or one nested under
    ``model`` / ``state_dict`` / ``module``; a DataParallel ``module.``
    prefix dropped (the JAX loader then cuts seven characters from every
    key, and so does this one)."""
    sd = _nested(_torch_load(path), ("model", "state_dict", "module"))
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    out = ast_state_dict_from_torch(sd, cfg)
    _check_shapes(out, ASTModel(cfg, device="meta"), path)
    return out


def ast_state_dict_from_jax(params: Dict[str, Any], cfg: ASTConfig) -> Dict[str, torch.Tensor]:
    """JAX ASTEncoder params -> the port's `ASTModel` state_dict."""
    p = params.get("params", params)
    sd = {"encoder.patch_embed.weight": _conv2d(p["patch_embed"]["kernel"]),
          "encoder.patch_embed.bias": _tensor(p["patch_embed"]["bias"]),
          "encoder.cls_token": _tensor(p["cls_token"]),
          "encoder.pos_embed": _tensor(p["pos_embed"])}
    _norm(sd, "encoder.norm", p["norm"])
    for i in range(cfg.depth):
        _layer_from_jax(sd, f"encoder.blocks.{i}", p[f"block_{i}"])
    return sd


def passt_state_dict_from_torch(sd: Dict[str, Any], cfg: PasstConfig) -> Dict[str, torch.Tensor]:
    """A hear21passt PaSST state_dict (the wrapper's ``net.*`` or the bare
    net's) -> the port's `PasstModel` keys (convert.py:1722-1753): the
    decomposed position tables [1, E, F, 1] / [1, E, 1, T] as [F, E] / [T,
    E], ``head.0`` / ``head.1`` as ``head_norm`` / ``head``."""
    if any(k.startswith("net.") for k in sd):
        sd = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    out = {"net.patch_embed.weight": _t(sd["patch_embed.proj.weight"]),
           "net.patch_embed.bias": _t(sd["patch_embed.proj.bias"]),
           "net.cls_token": _t(sd["cls_token"]).reshape(1, 1, -1),
           "net.new_pos_embed": _t(sd["new_pos_embed"]).reshape(1, 1, -1),
           "net.freq_pos_embed": _t(sd["freq_new_pos_embed"])[0, :, :, 0].T.contiguous(),
           "net.time_pos_embed": _t(sd["time_new_pos_embed"])[0, :, 0, :].T.contiguous()}
    for a, b in (("norm", "norm"), ("head.0", "head_norm"), ("head.1", "head")):
        for kind in ("weight", "bias"):
            out[f"net.{b}.{kind}"] = _t(sd[f"{a}.{kind}"])
    for i in range(cfg.depth):
        _timm_block(out, sd, f"blocks.{i}", f"net.blocks.{i}")
    return out


def load_passt_checkpoint(path, cfg: PasstConfig) -> Dict[str, torch.Tensor]:
    """A PaSST checkpoint (a state_dict, or one under ``model`` /
    ``state_dict``) -> the port's state_dict (convert.py:1756-1767)."""
    out = passt_state_dict_from_torch(_nested(_torch_load(path), ("model", "state_dict")), cfg)
    _check_shapes(out, PasstModel(cfg, device="meta"), path)
    return out


def passt_state_dict_from_jax(params: Dict[str, Any], cfg: PasstConfig
                              ) -> Dict[str, torch.Tensor]:
    """JAX PasstModel params (the net under ``net``) -> the port's
    `PasstModel` state_dict."""
    p = params.get("params", params)["net"]
    sd = {"net.patch_embed.weight": _conv2d(p["patch_embed"]["kernel"]),
          "net.patch_embed.bias": _tensor(p["patch_embed"]["bias"])}
    for name in ("freq_pos_embed", "time_pos_embed", "cls_token", "new_pos_embed"):
        sd[f"net.{name}"] = _tensor(p[name])
    for name in ("norm", "head_norm"):
        _norm(sd, f"net.{name}", p[name])
    _linear(sd, "net.head", p["head"])
    for i in range(cfg.depth):
        _layer_from_jax(sd, f"net.blocks.{i}", p[f"block_{i}"])
    return sd


def vggish_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VGGishCNN params (``conv{i}_{r}``, ``fc1_1``, ``fc1_2``, ``fc2``)
    -> the port's `VGGish` keys (torchvggish's ``features.{j}`` /
    ``embeddings.{j}``)."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    j = 0
    for i, (_, convs) in enumerate(VGGISH_STAGES):
        for r in range(convs):
            _conv2d_keys(sd, f"features.{j}", p[f"conv{i}_{r}"])
            j += 2  # conv, ReLU
        j += 1  # the max pool
    for j, name in enumerate(("fc1_1", "fc1_2", "fc2")):
        _linear(sd, f"embeddings.{2 * j}", p[name])
    return sd


def parse_fairseq_dictionary(text: str, num_codes: int = 320) -> Tuple[np.ndarray, int]:
    """A fairseq dict.txt of "a-b count" code-pair symbols -> (lookup
    [num_codes, num_codes] of token ids, <unk> = 3 where no symbol names
    the pair; the vocabulary size with the appended <mask>): the specials
    <s> <pad> </s> <unk> first, then the symbols in file order (a copy of
    convert.py:1340-1357)."""
    lookup = np.full((num_codes, num_codes), 3, np.int32)
    idx = 4
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.rsplit(" ", 1)[0].split("-")
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            a, b = int(parts[0]), int(parts[1])
            if a < num_codes and b < num_codes:
                lookup[a, b] = idx
        idx += 1
    return lookup, idx + 1


def roberta_state_dict_from_torch(sd: Dict[str, Any], num_layers: int
                                  ) -> Dict[str, torch.Tensor]:
    """A fairseq RobertaModel state_dict (``encoder.sentence_encoder.*`` or
    the bare sentence encoder's) -> the port's `RobertaModel` keys
    (convert.py:1303-1337): ``layernorm_embedding`` (or the older
    ``emb_layer_norm``) as ``emb_layer_norm``, the layers' keys as they are."""
    pref = ("encoder.sentence_encoder."
            if any(k.startswith("encoder.sentence_encoder.") for k in sd) else "")
    ln = "layernorm_embedding" if f"{pref}layernorm_embedding.weight" in sd else "emb_layer_norm"
    out = {f"{name}.weight": _t(sd[f"{pref}{name}.weight"])
           for name in ("embed_tokens", "embed_positions")}
    for kind in ("weight", "bias"):
        out[f"emb_layer_norm.{kind}"] = _t(sd[f"{pref}{ln}.{kind}"])
    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj",
             "self_attn_layer_norm", "fc1", "fc2", "final_layer_norm")
    for i in range(num_layers):
        for name in names:
            for kind in ("weight", "bias"):
                out[f"layers.{i}.{name}.{kind}"] = _t(sd[f"{pref}layers.{i}.{name}.{kind}"])
    return out


def load_roberta_checkpoint(path) -> Tuple[RobertaConfig, Dict[str, torch.Tensor], Any]:
    """An s3prl-converted RoBERTa checkpoint ``{"model_weight", "model_cfg",
    "text_dictionary"}`` -> (config, the port's `RobertaModel` state_dict,
    the dictionary's code-pair lookup or None) (convert.py:1360-1395): the
    vocabulary and positions from the embeddings' shapes, the widths and
    rates from ``model_cfg`` (a Namespace or a dict)."""
    ckpt = _torch_load(path)
    sd = ckpt["model_weight"]
    mc = ckpt.get("model_cfg")
    mc = vars(mc) if mc is not None and not isinstance(mc, dict) else (mc or {})
    tok = sd.get("encoder.sentence_encoder.embed_tokens.weight", sd.get("embed_tokens.weight"))
    pos = sd.get("encoder.sentence_encoder.embed_positions.weight",
                 sd.get("embed_positions.weight"))
    cfg = RobertaConfig(
        vocab_size=tok.shape[0], max_positions=pos.shape[0] - PAD - 1,
        hidden_size=int(mc.get("encoder_embed_dim", tok.shape[1])),
        num_layers=int(mc.get("encoder_layers", 12)),
        num_heads=int(mc.get("encoder_attention_heads", 12)),
        ffn_size=int(mc.get("encoder_ffn_embed_dim", 3072)),
        dropout=float(mc.get("dropout", 0.1)),
        attention_dropout=float(mc.get("attention_dropout", 0.1)),
        activation_dropout=float(mc.get("activation_dropout", 0.0)), pad_idx=PAD)
    lookup = None
    if "text_dictionary" in ckpt:
        lookup, _ = parse_fairseq_dictionary(ckpt["text_dictionary"])
    return cfg, roberta_state_dict_from_torch(sd, cfg.num_layers), lookup


def roberta_state_dict_from_jax(params: Dict[str, Any], cfg: RobertaConfig
                                ) -> Dict[str, torch.Tensor]:
    """JAX RobertaModel params -> the port's `RobertaModel` state_dict."""
    p = params.get("params", params)
    sd = {f"{name}.weight": _tensor(p[name]["embedding"])
          for name in ("embed_tokens", "embed_positions")}
    _norm(sd, "emb_layer_norm", p["emb_layer_norm"])
    for i in range(cfg.num_layers):
        _layer_from_jax(sd, f"layers.{i}", p[f"layer_{i}"])
    return sd


def pase_state_dict_from_jax(variables: Dict[str, Any], cfg: PaseConfig
                             ) -> Dict[str, torch.Tensor]:
    """JAX PaseModel variables ({"params", "batch_stats"}) -> the port's
    `PaseModel` state_dict: flax's (k, in, out) conv kernels, its scalar
    PReLU slopes as [1], its BatchNorm statistics as the running ones."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {"sinc.low_hz": _tensor(p["sinc"]["low_hz"]),
          "sinc.band_hz": _tensor(p["sinc"]["band_hz"])}
    names = [("sinc_bn", "sinc_bn", "sinc_act", "sinc_act")] + [
        (f"blocks.{i}.bn", f"block{i}_bn", f"blocks.{i}.act", f"block{i}_act")
        for i in range(len(cfg.fmaps))]
    for bn, jax_bn, act, jax_act in names:
        _bn(sd, bn, p[jax_bn], s[jax_bn])
        sd[f"{act}.weight"] = _tensor(p[jax_act]["negative_slope"]).reshape(1)
    for i in range(len(cfg.fmaps)):
        conv = p[f"block{i}_conv"]
        sd[f"blocks.{i}.conv.weight"] = _conv(conv["kernel"])
        sd[f"blocks.{i}.conv.bias"] = _tensor(conv["bias"])
        _linear(sd, f"denseskips.{i}", p[f"denseskip{i}"])
    sd["qrnn.gates.weight"] = _conv(p["qrnn"]["gates"]["kernel"])
    sd["qrnn.gates.bias"] = _tensor(p["qrnn"]["gates"]["bias"])
    _linear(sd, "W", p["W"])
    return sd
