"""Checkpoints and JAX trunk parameters -> the port's state_dict.

From a checkpoint on disk (port of s3prl_tpu/upstream/convert.py): s3prl's
converted checkpoints ``{"model_weight", "model_cfg", "task_cfg"}`` or a
bare fairseq state_dict through `load_trunk_checkpoint`, Microsoft's WavLM
checkpoints ``{"cfg", "model"}`` through `load_wavlm_checkpoint`; each reads
the keys the JAX loader reads and returns (config, state_dict) in the keys
the port's models load (`trunk_state_dict_from_torch`,
`wavlm_state_dict_from_torch`). Nothing is downloaded. A Conformer trunk's
keys include its BatchNorm statistics. The rest of the wav2vec2-style zoo
keeps the reference's keys: `load_distiller_checkpoint`,
`load_lighthubert_checkpoint` (the supernet sliced to its subnet on the
host), `load_multires_hubert_checkpoint` and `load_espnet_hubert_checkpoint`
(torchaudio's keys renamed to fairseq's), with `*_state_dict_from_jax`
mapping the JAX package's trees onto them.

`probe_state_dict_from_jax(params)` maps a probe's flax params (featurizer
and head) onto the port's `UpstreamDownstreamModel`.

Pretraining (s3prl_tpu/problem/pretrain.py): `native_checkpoint` reads a
checkpoint of either package's pretraining (the JAX Trainer's
``params.msgpack`` through `util.msgpack`, the port's ``model.pt``; a file,
a step directory or a train directory), which the trunk loader (HuBERT's
``trunk``, data2vec's ``student``, a bare trunk) and the mel-domain loader
(the MAM task's ``encoder``, ``apc``, NPC's variables) take apart as the
JAX loaders do (convert.py:278-303, :805-874); the other loaders refuse
one (`_torch_only`), as the JAX loaders cannot read it.
`hubert_pretrain_state_dict_from_jax`, `data2vec_pretrain_state_dict_from_jax`,
`mam_pretrain_state_dict_from_jax`, `apc_pretrain_state_dict_from_jax` and
`npc_pretrain_state_dict_from_jax` map the pretraining tasks' trees onto the
port's task modules.

The mel-domain SSL models and the MOS predictor keep the reference's keys:
`load_mel_ssl_checkpoint` and `load_mos_checkpoint` read the reference's
checkpoints (the torch branches of convert.py:846-914, :1214-1300), and
`mockingjay_state_dict_from_jax`, `apc_state_dict_from_jax`,
`npc_state_dict_from_jax` and `mos_state_dict_from_jax` map the JAX
package's trees onto them (the inverses of its `*_from_torch`).

`trunk_state_dict_from_jax(params, cfg)` takes the param tree of
s3prl_tpu.models.wav2vec2.Wav2Vec2Trunk (numpy or jax arrays; a variables
dict with a "params" entry also works) and returns the fairseq-keyed
state_dict that s3prl_tpu_torch's `Wav2Vec2Trunk.load_state_dict` reads and
that s3prl_tpu/upstream/convert.py `trunk_params_from_torch` maps back to
the same tree, bit for bit; `wavlm_state_dict_from_jax(params, cfg)` does
the same for s3prl_tpu.models.wavlm.WavLMModel (Microsoft's keys):

- conv kernels [k, in, out] -> Conv1d weights [out, in, k];
- Dense kernels [in, out] -> Linear weights [out, in];
- the fused qkv kernel [C, 3C] -> q/k/v_proj weights [C, C] each;
- the stacked encoder layers (leading L axis) -> encoder.layers.{i}.*;
- LayerNorm and GroupNorm scale/bias -> weight/bias: the layer-norm
  extractor's ``ln_{i}`` at ``conv_layers.{i}.2.1``, the default
  extractor's ``gn_0`` at ``conv_layers.0.2``;
- with ``conv_bias`` each ``conv_{i}`` bias -> ``conv_layers.{i}.0.bias``;
- data2vec's depth-N pos-conv ``pos_conv.conv_{i}`` -> ``pos_conv.{i}.0``.
"""

from __future__ import annotations

import ast
import math
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.distiller import DistillerConfig
from ..models.lighthubert import (SUBNET_BASE, SUBNET_BASE_MAX, SUBNET_SMALL, SUBNET_SMALL_MAX,
                                  LightHubertConfig)
from ..models.multires_hubert import MultiresHubertConfig
from ..models.wav2vec2 import Wav2Vec2Config
from ..models.wavlm import WavLMConfig


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd, prefix: str, p: Dict[str, Any], index=None) -> None:
    kernel, bias = p["kernel"], p["bias"]
    if index is not None:
        kernel, bias = kernel[index], bias[index]
    sd[f"{prefix}.weight"] = _tensor(np.asarray(kernel).T)
    sd[f"{prefix}.bias"] = _tensor(bias)


def _norm(sd, prefix: str, p: Dict[str, Any], index=None) -> None:
    scale, bias = p["scale"], p["bias"]
    if index is not None:
        scale, bias = scale[index], bias[index]
    sd[f"{prefix}.weight"] = _tensor(scale)
    sd[f"{prefix}.bias"] = _tensor(bias)


def _conv(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).transpose(2, 1, 0))


def _front_end(p: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The extractor, the feature LN, the projection and the mask embedding
    (the inverse of s3prl_tpu/upstream/convert.py:99-119), each that the
    tree holds (DistilHuBERT has no feature LN; only the trunks have the
    mask embedding)."""
    sd: Dict[str, torch.Tensor] = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.0.weight"] = _conv(fe[f"conv_{i}"]["kernel"])
        if getattr(cfg, "conv_bias", False):
            sd[f"{pre}.0.bias"] = _tensor(fe[f"conv_{i}"]["bias"])
        if cfg.extractor_mode == "layer_norm":
            _norm(sd, f"{pre}.2.1", fe[f"ln_{i}"])
        elif i == 0:
            _norm(sd, f"{pre}.2", fe["gn_0"])
    if "layer_norm" in p:
        _norm(sd, "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _linear(sd, "post_extract_proj", p["post_extract_proj"])
    if "mask_emb" in p:
        sd["mask_emb"] = _tensor(p["mask_emb"])
    return sd


def _encoder(sd, pos_conv: Dict[str, Any] | None, layer_norm: Dict[str, Any],
             layers: Dict[str, Any], prefix: str = "encoder") -> None:
    """The pos-conv (one conv, the depth-N stack's ``conv_{i}``, or none),
    the final LN and the stacked layers' common parameters, under
    `prefix`; the widths and the depth come from the stacked QKV kernel
    [L, C, 3C]."""
    convs = ({} if pos_conv is None else {"0": pos_conv["conv"]} if "conv" in pos_conv else
             {f"{i}.0": pos_conv[f"conv_{i}"] for i in range(len(pos_conv))})
    for key, conv in convs.items():
        sd[f"{prefix}.pos_conv.{key}.weight"] = _conv(conv["kernel"])
        sd[f"{prefix}.pos_conv.{key}.bias"] = _tensor(conv["bias"])
    _norm(sd, f"{prefix}.layer_norm", layer_norm)
    L, C = np.shape(layers["self_attn"]["qkv"]["kernel"])[:2]
    for i in range(L):
        pre = f"{prefix}.layers.{i}"
        qkv_w = np.asarray(layers["self_attn"]["qkv"]["kernel"][i])
        qkv_b = np.asarray(layers["self_attn"]["qkv"]["bias"][i])
        for j, name in enumerate("qkv"):
            sd[f"{pre}.self_attn.{name}_proj.weight"] = _tensor(qkv_w[:, j * C:(j + 1) * C].T)
            sd[f"{pre}.self_attn.{name}_proj.bias"] = _tensor(qkv_b[j * C:(j + 1) * C])
        _linear(sd, f"{pre}.self_attn.out_proj", layers["self_attn"]["out_proj"], i)
        _norm(sd, f"{pre}.self_attn_layer_norm", layers["self_attn_layer_norm"], i)
        _linear(sd, f"{pre}.fc1", layers["fc1"], i)
        _linear(sd, f"{pre}.fc2", layers["fc2"], i)
        _norm(sd, f"{pre}.final_layer_norm", layers["final_layer_norm"], i)


def _conformer_layers(sd, layers: Dict[str, Any], stats: Dict[str, Any], cfg) -> None:
    """The stacked ConformerLayer params and their BatchNorm statistics ->
    ``encoder.layers.{i}.*`` (the inverse of s3prl_tpu/upstream/convert.py
    `_conformer_layer_variables`, :178-213)."""
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        for ours, theirs in (("ffn1_w1", "ffn1.w_1"), ("ffn1_w2", "ffn1.w_2"),
                             ("ffn2_w1", "ffn2.w_1"), ("ffn2_w2", "ffn2.w_2")):
            _linear(sd, f"{pre}.{theirs}", layers[ours], i)
        for ours, theirs in (("ffn1_layer_norm", "ffn1.layer_norm"),
                             ("self_attn_layer_norm", "self_attn_layer_norm"),
                             ("conv_ln", "conv_module.layer_norm"),
                             ("conv_bn", "conv_module.batch_norm"),
                             ("ffn2_layer_norm", "ffn2.layer_norm"),
                             ("final_layer_norm", "final_layer_norm")):
            _norm(sd, f"{pre}.{theirs}", layers[ours], i)
        attn = layers["self_attn"]
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            _linear(sd, f"{pre}.self_attn.{name}", attn[name], i)
        if cfg.pos_enc_type == "rel_pos":
            sd[f"{pre}.self_attn.linear_pos.weight"] = _tensor(
                np.asarray(attn["linear_pos"]["kernel"][i]).T)
            for name in ("pos_bias_u", "pos_bias_v"):
                sd[f"{pre}.self_attn.{name}"] = _tensor(attn[name][i])
        for name in ("pw1", "pw2"):  # Dense [in, out] -> a k = 1 Conv1d [out, in, 1]
            sd[f"{pre}.conv_module.pointwise_conv{name[-1]}.weight"] = _tensor(
                np.asarray(layers[f"conv_{name}"]["kernel"][i]).T[:, :, None])
        sd[f"{pre}.conv_module.depthwise_conv.weight"] = _conv(layers["conv_dw"]["kernel"][i])
        bn = stats["conv_bn"]
        sd[f"{pre}.conv_module.batch_norm.running_mean"] = _tensor(bn["mean"][i])
        sd[f"{pre}.conv_module.batch_norm.running_var"] = _tensor(bn["var"][i])


def trunk_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX Wav2Vec2Trunk params -> the port's (fairseq-keyed) state_dict.
    A Conformer trunk takes the variables dict, whose ``batch_stats`` hold
    its BatchNorm statistics."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    enc = p["encoder"]
    if cfg.layer_type == "conformer":
        _norm(sd, "encoder.layer_norm", enc["layer_norm"])
        _conformer_layers(sd, enc["layers"], params["batch_stats"]["encoder"]["layers"], cfg)
    else:
        _encoder(sd, enc["pos_conv"], enc["layer_norm"], enc["layers"])
    return sd


def wavlm_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX WavLMModel params -> the port's (Microsoft-keyed) state_dict, the
    inverse of s3prl_tpu/upstream/convert.py `wavlm_params_from_torch`
    (:359-416) but for the pos-conv, which the port keeps folded as
    ``encoder.pos_conv.0.weight``. The JAX tree keeps the pos-conv, the
    final LN (``enc_layer_norm``) and the bias table at its top level; the
    table goes to layer 0, as in Microsoft's WavLM."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    layers = p["layers"]
    _encoder(sd, p["pos_conv"], p["enc_layer_norm"], layers)
    if cfg.relative_position_embedding:
        sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _tensor(
            p["relative_attention_bias"])
    for i in range(cfg.encoder_layers if cfg.gated else 0):
        pre = f"encoder.layers.{i}.self_attn"
        _linear(sd, f"{pre}.grep_linear", layers["grep_linear"], i)
        sd[f"{pre}.grep_a"] = _tensor(layers["grep_a"][i])
    return sd


def distiller_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX DistillerModel params -> the port's `DistillerModel` state_dict
    (the reference's keys), the inverse of convert.py
    `distiller_params_from_torch` (:477-532) but for the pos-conv, kept
    folded: ``out_expand`` -> ``output_layer.0``, ``split_out`` ->
    ``output_layer.2`` (bias [1, 1, n_tasks, final_dim])."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    enc = p["encoder"]
    _encoder(sd, enc["pos_conv"], enc["layer_norm"], enc["layers"])
    _linear(sd, "output_layer.0", p["out_expand"])
    sd["output_layer.2.weight"] = _tensor(p["split_out"]["weight"])
    sd["output_layer.2.bias"] = _tensor(p["split_out"]["bias"])[None, None]
    return sd


def lighthubert_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX LightHubertModel params -> the port's `LightHubertModel`
    state_dict (fairseq's keys at the subnet's widths)."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    enc = p["encoder"]
    _encoder(sd, enc["pos_conv"], enc["layer_norm"], enc["layers"])
    return sd


def _gn_conv(sd, prefix: str, p: Dict[str, Any], transpose: bool) -> None:
    """A `_GNConv` -> ``{prefix}.0.weight`` (a transposed conv's flipped
    flax kernel [k, in, out] back to torch's [in, out, k]) and the norm's
    ``{prefix}.2``."""
    kernel = np.asarray(p["conv"]["kernel"])
    sd[f"{prefix}.0.weight"] = (_tensor(kernel[::-1].transpose(1, 2, 0)) if transpose
                                else _conv(kernel))
    _norm(sd, f"{prefix}.2", p["norm"])


def multires_hubert_state_dict_from_jax(params: Dict[str, Any], cfg
                                        ) -> Dict[str, torch.Tensor]:
    """JAX MultiresHubertModel params -> the port's `MultiresHubertModel`
    state_dict (the reference's keys), the inverse of convert.py
    `multires_hubert_params_from_torch` (:1015-1060) but for the pos-conv,
    kept folded."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    blocks = [("middle_encoder", "middle_encoder")] + [
        (f"{kind}s_{i}", f"{kind}s.{i}") for kind in ("encoder", "decoder")
        for i in range(cfg.n_pairs)]
    for ours, theirs in blocks:
        enc = p[ours]
        _encoder(sd, enc.get("pos_conv"), enc["layer_norm"], enc["layers"], theirs)
    for i in range(cfg.n_pairs):
        for kind in ("downsample", "upsample"):
            for half in p[f"{kind}_{i}"]:
                _gn_conv(sd, f"{kind}_modules.{i}.{half}", p[f"{kind}_{i}"][half],
                         transpose=half == "upsample_conv")
    return sd


# -- checkpoints on disk ------------------------------------------------------------

def _t(x) -> torch.Tensor:
    """A checkpoint tensor as an f32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _conv_layers(value):
    """``conv_feature_layers`` as a tuple of (dim, k, stride), from its
    string form or a sequence; None when absent."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    return None if value is None else tuple(tuple(c) for c in value)


def config_from_model_cfg(model_cfg: Dict[str, Any],
                          task_cfg: Dict[str, Any] | None = None) -> Wav2Vec2Config:
    """The trunk config of an s3prl / fairseq ``model_cfg`` (a copy of
    s3prl_tpu/upstream/convert.py:53-91): wav2vec2 and data2vec checkpoints
    (``_name`` "wav2vec2" / "data2vec_audio") take the conv length rule,
    HuBERT the block rule; ``normalize`` comes from ``task_cfg``. As in the
    JAX loader, ``pos_conv_depth`` and ``post_extract_proj_always`` keep
    their defaults."""
    kwargs = dict(
        extractor_mode=model_cfg.get("extractor_mode", "default"),
        encoder_layers=model_cfg.get("encoder_layers", 12),
        encoder_embed_dim=model_cfg.get("encoder_embed_dim", 768),
        encoder_ffn_embed_dim=model_cfg.get("encoder_ffn_embed_dim", 3072),
        encoder_attention_heads=model_cfg.get("encoder_attention_heads", 12),
        activation_fn=model_cfg.get("activation_fn", "gelu"),
        layer_norm_first=model_cfg.get("layer_norm_first", False),
        conv_bias=model_cfg.get("conv_bias", False),
        conv_pos=model_cfg.get("conv_pos", 128),
        conv_pos_groups=model_cfg.get("conv_pos_groups", 16),
        dropout=model_cfg.get("dropout", 0.1),
        attention_dropout=model_cfg.get("attention_dropout", 0.1),
        activation_dropout=model_cfg.get("activation_dropout", 0.0),
        dropout_input=model_cfg.get("dropout_input", 0.1),
        encoder_layerdrop=model_cfg.get("encoder_layerdrop", 0.0),
        layer_type=model_cfg.get("layer_type", "transformer"),
        feat_pad_rule="conv"
        if model_cfg.get("_name", "") in ("wav2vec2", "data2vec_audio")
        or model_cfg.get("layer_type") == "conformer"
        else "block",
        pos_enc_type=model_cfg.get("pos_enc_type", "rel_pos"),
        depthwise_conv_kernel_size=model_cfg.get("depthwise_conv_kernel_size", 31),
        normalize=(task_cfg or {}).get("normalize", False),
    )
    conv = _conv_layers(model_cfg.get("conv_feature_layers", None))
    if conv is not None:
        kwargs["conv_feature_layers"] = conv
    return Wav2Vec2Config(**kwargs)


def wavlm_config_from_cfg(cfg_dict: Dict[str, Any]) -> WavLMConfig:
    """The WavLM config of a Microsoft checkpoint's ``cfg`` (a copy of
    s3prl_tpu/upstream/convert.py:324-356)."""
    kwargs = dict(
        extractor_mode=cfg_dict.get("extractor_mode", "default"),
        encoder_layers=cfg_dict.get("encoder_layers", 12),
        encoder_embed_dim=cfg_dict.get("encoder_embed_dim", 768),
        encoder_ffn_embed_dim=cfg_dict.get("encoder_ffn_embed_dim", 3072),
        encoder_attention_heads=cfg_dict.get("encoder_attention_heads", 12),
        activation_fn=cfg_dict.get("activation_fn", "gelu"),
        layer_norm_first=cfg_dict.get("layer_norm_first", False),
        conv_bias=cfg_dict.get("conv_bias", False),
        conv_pos=cfg_dict.get("conv_pos", 128),
        conv_pos_groups=cfg_dict.get("conv_pos_groups", 16),
        dropout=cfg_dict.get("dropout", 0.1),
        attention_dropout=cfg_dict.get("attention_dropout", 0.1),
        activation_dropout=cfg_dict.get("activation_dropout", 0.0),
        dropout_input=cfg_dict.get("dropout_input", 0.0),
        normalize=cfg_dict.get("normalize", False),
        relative_position_embedding=cfg_dict.get("relative_position_embedding", True),
        num_buckets=cfg_dict.get("num_buckets", 320),
        max_distance=cfg_dict.get("max_distance", 800),
        gru_rel_pos=cfg_dict.get("gru_rel_pos", True),
    )
    conv = _conv_layers(cfg_dict.get("conv_feature_layers"))
    if conv is not None:
        kwargs["conv_feature_layers"] = conv
    return WavLMConfig(**kwargs)


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight_norm(dim=2) on a conv [out, in, k]: W = g * v /
    ||v||_{0,1}, in numpy as the JAX converter folds it (convert.py:47-50)."""
    g, v = g.numpy(), v.numpy()
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def _copy(out, sd, key: str) -> None:
    out[key] = _t(sd[key])


# a layer's modules with a weight and a bias, and its bias-free weights and
# tensors, in fairseq's keys: the transformer layer, the Conformer's
# (ConformerWav2Vec2EncoderLayer, convert.py:178-213; its rel-pos keys apart)
_LAYER_KEYS = {
    "transformer": (("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
                     "final_layer_norm"), ()),
    "conformer": (("ffn1.layer_norm", "ffn1.w_1", "ffn1.w_2", "self_attn_layer_norm",
                   "self_attn.linear_q", "self_attn.linear_k", "self_attn.linear_v",
                   "self_attn.linear_out", "conv_module.layer_norm", "conv_module.batch_norm",
                   "ffn2.layer_norm", "ffn2.w_1", "ffn2.w_2", "final_layer_norm"),
                  ("conv_module.pointwise_conv1.weight", "conv_module.depthwise_conv.weight",
                   "conv_module.pointwise_conv2.weight", "conv_module.batch_norm.running_mean",
                   "conv_module.batch_norm.running_var")),
}
_REL_POS_KEYS = ("self_attn.linear_pos.weight", "self_attn.pos_bias_u", "self_attn.pos_bias_v")


def _extractor_keys(out, sd: Dict[str, Any], cfg) -> None:
    """The conv extractor's weights (and biases with ``conv_bias``) and its
    norms: every layer's LN in the layer-norm mode, layer 0's group norm in
    the default one."""
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        _copy(out, sd, f"{pre}.0.weight")
        if getattr(cfg, "conv_bias", False):
            _copy(out, sd, f"{pre}.0.bias")
        norm = (f"{pre}.2.1" if cfg.extractor_mode == "layer_norm" else
                f"{pre}.2" if cfg.extractor_mode == "default" and i == 0 else None)
        for kind in ("weight", "bias") if norm else ():
            _copy(out, sd, f"{norm}.{kind}")


def _pos_conv_keys(out, sd: Dict[str, Any], prefix: str = "encoder") -> None:
    """One pos-conv under `prefix`, its weight norm (``weight_g`` /
    ``weight_v``) folded when the checkpoint has it."""
    pre = f"{prefix}.pos_conv.0"
    if f"{pre}.weight_g" in sd:
        out[f"{pre}.weight"] = _fold_weight_norm(_t(sd[f"{pre}.weight_g"]),
                                                 _t(sd[f"{pre}.weight_v"]))
    else:
        _copy(out, sd, f"{pre}.weight")
    _copy(out, sd, f"{pre}.bias")


def _encoder_keys(out, sd: Dict[str, Any], num_layers: int, prefix: str = "encoder",
                  layer_type: str = "transformer", rel_pos: bool = False) -> None:
    """An encoder's final LN and every layer's attention, LNs and FFN
    (convert.py:94-175, :966-1002) or, for a Conformer, its modules and
    BatchNorm statistics (:178-258; ``rel_pos``: its position keys)."""
    for kind in ("weight", "bias"):
        _copy(out, sd, f"{prefix}.layer_norm.{kind}")
    affine, bare = _LAYER_KEYS[layer_type]
    bare = bare + (_REL_POS_KEYS if rel_pos else ())
    for i in range(num_layers):
        pre = f"{prefix}.layers.{i}"
        for name in affine:
            for kind in ("weight", "bias"):
                _copy(out, sd, f"{pre}.{name}.{kind}")
        for name in bare:
            _copy(out, sd, f"{pre}.{name}")


def _trunk_keys(sd: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The extractor, the feature LN, the projection, the mask embedding
    (zeros when the checkpoint has none) and the encoder but its pos-conv
    (convert.py:94-175, :178-258, :359-416), in the port's keys; the
    pos-conv is the caller's."""
    out: Dict[str, torch.Tensor] = {}
    _extractor_keys(out, sd, cfg)
    for prefix in ["layer_norm"] + (["post_extract_proj"] if "post_extract_proj.weight" in sd
                                    else []):
        for kind in ("weight", "bias"):
            _copy(out, sd, f"{prefix}.{kind}")
    out["mask_emb"] = (_t(sd["mask_emb"]) if "mask_emb" in sd
                       else torch.zeros(cfg.encoder_embed_dim))
    _encoder_keys(out, sd, cfg.encoder_layers, layer_type=cfg.layer_type,
                  rel_pos=cfg.layer_type == "conformer" and cfg.pos_enc_type == "rel_pos")
    return out


def trunk_state_dict_from_torch(sd: Dict[str, Any], cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """A wav2vec2 / HuBERT / data2vec fairseq or s3prl state_dict -> the
    port's `Wav2Vec2Trunk` state_dict, reading what the JAX
    `trunk_params_from_torch` reads (convert.py:94-175): the pos-conv under
    weight norm (``weight_g`` / ``weight_v``) folded, data2vec's depth-N
    stack (``encoder.pos_conv.{i}.0.*``) kept, a missing ``mask_emb`` as
    zeros, every other key (``final_proj``, ``label_embs_concat``,
    ``quantizer``, ``project_q``, ...) left out. Tensors come out f32. A
    Conformer's pos-conv, which its encoder never applies, is left out
    (`conformer_trunk_variables_from_torch`, convert.py:216-258)."""
    if cfg.layer_type == "conformer":
        return _trunk_keys(sd, cfg)
    out: Dict[str, torch.Tensor] = {}
    if "encoder.pos_conv.0.0.weight" in sd:  # data2vec's stack
        depth = 0
        while f"encoder.pos_conv.{depth}.0.weight" in sd:
            depth += 1
        if depth != cfg.pos_conv_depth:
            raise ValueError(f"the checkpoint holds a depth-{depth} pos-conv stack "
                             "(encoder.pos_conv.{i}.0.*), the config a depth-"
                             f"{cfg.pos_conv_depth} pos-conv")
        for i in range(depth):
            for kind in ("weight", "bias"):
                _copy(out, sd, f"encoder.pos_conv.{i}.0.{kind}")
    elif cfg.pos_conv_depth != 1:
        raise ValueError(f"the config has a depth-{cfg.pos_conv_depth} pos-conv stack, the "
                         "checkpoint one pos-conv (encoder.pos_conv.0.*)")
    else:
        _pos_conv_keys(out, sd)
    return {**_trunk_keys(sd, cfg), **out}


def wavlm_state_dict_from_torch(sd: Dict[str, Any], cfg: WavLMConfig) -> Dict[str, torch.Tensor]:
    """A Microsoft WavLM state_dict -> the port's `WavLMModel` state_dict,
    reading what the JAX `wavlm_params_from_torch` reads (convert.py:
    359-416): the pos-conv from ``weight_g`` / ``weight_v``, folded; the
    bias table (layer 0) only with ``relative_position_embedding``, the gate
    (``grep_linear``, ``grep_a``) only where it runs, with the bias and
    ``gru_rel_pos`` (the JAX loader also reads it without the bias, where
    its model never calls it)."""
    out = _trunk_keys(sd, cfg)
    out["encoder.pos_conv.0.weight"] = _fold_weight_norm(
        _t(sd["encoder.pos_conv.0.weight_g"]), _t(sd["encoder.pos_conv.0.weight_v"]))
    _copy(out, sd, "encoder.pos_conv.0.bias")
    if cfg.relative_position_embedding:
        _copy(out, sd, "encoder.layers.0.self_attn.relative_attention_bias.weight")
    for i in range(cfg.encoder_layers if cfg.gated else 0):
        pre = f"encoder.layers.{i}.self_attn"
        for key in ("grep_linear.weight", "grep_linear.bias", "grep_a"):
            _copy(out, sd, f"{pre}.{key}")
    return out


def _step_number(d: Path) -> int | None:
    tail = d.name[len("step_"):]
    return int(tail) if tail.isdigit() else None


def native_checkpoint(path):
    """A checkpoint of pretraining in either package -> ("jax", the tree of
    numpy arrays) or ("torch", the task module's state_dict), or None for
    any other `path`. A ``.msgpack`` file, a step directory holding
    ``params.msgpack`` (the JAX Trainer's) or ``model.pt`` (the port's), or
    a train directory of ``step_<N>`` ones (the highest N holding either
    wins), as the JAX package's ``_native_pretrain_msgpack`` (convert.py:
    805-827) resolves its own. The msgpack is read by `util.msgpack` (no
    msgpack package)."""
    from ..util.msgpack import msgpack_restore

    p = _native_file(path)
    if p is None:
        return None
    if p.name == "model.pt":
        return "torch", torch.load(p, map_location="cpu", weights_only=True)
    return "jax", _numpy_tree(msgpack_restore(p.read_bytes()))


def _native_file(path) -> Path | None:
    """The file `native_checkpoint` reads for `path`, or None."""
    p = Path(path)
    if p.is_dir():
        files = ("params.msgpack", "model.pt")
        if not any((p / f).exists() for f in files):
            steps = sorted((d for d in p.glob("step_*") if _step_number(d) is not None
                            and any((d / f).exists() for f in files)), key=_step_number)
            if not steps:
                return None
            p = steps[-1]
        return p / "params.msgpack" if (p / "params.msgpack").exists() else p / "model.pt"
    return p if p.suffix == ".msgpack" else None


def _torch_only(path) -> None:
    """A loader other than the trunks' and the mel-domain models' reads no
    pretraining checkpoint, as the JAX package's loaders read none (their
    ``torch.load`` fails on one): NotImplementedError."""
    if _native_file(path) is not None:
        raise NotImplementedError(
            f"{path}: a pretraining checkpoint (the JAX package's msgpack or the port's "
            "model.pt); only the trunk entries (HuBERT / data2vec pretraining) and the "
            "mel-domain ones read one, as in the JAX package, whose other loaders read torch "
            "checkpoints only")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.float().numpy() if isinstance(tree, torch.Tensor) else tree


def _subtree(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of a state_dict under ``prefix.``, the prefix taken off."""
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _native_layout_error(path, keys, expected: str) -> ValueError:
    return ValueError(f"native pretrain checkpoint {path} has top-level keys {sorted(keys)}: "
                      f"expected {expected}")


def _native_trunk(path, kind: str, tree, cfg) -> Dict[str, torch.Tensor]:
    """A trunk's state_dict from a pretraining checkpoint: the ``trunk``
    (HuBERT) or ``student`` (data2vec) subtree, or a bare trunk tree
    (convert.py:290-303)."""
    if kind == "jax":
        for key in ("trunk", "student"):
            if key in tree:
                return trunk_state_dict_from_jax(tree[key], cfg)
        if "feature_extractor" in tree:
            return trunk_state_dict_from_jax(tree, cfg)
        raise _native_layout_error(path, tree, "a 'trunk' (hubert pretrain) / 'student' "
                                   "(data2vec pretrain) subtree or a bare Wav2Vec2Trunk tree")
    for key in ("trunk", "student"):
        if any(k.startswith(key + ".") for k in tree):
            return _subtree(tree, key)
    if any(k.startswith("feature_extractor.") for k in tree):
        return dict(tree)
    raise _native_layout_error(path, {k.split(".")[0] for k in tree},
                               "a 'trunk' / 'student' subtree or a bare trunk state_dict")


# -- the pretraining tasks' trees (s3prl_tpu/problem/pretrain.py) -> the port's
# task modules' state_dicts


def hubert_pretrain_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX HubertForPretrain params ``{trunk, final_proj, label_embs}`` ->
    the port's `HubertForPretrain` state_dict."""
    p = params.get("params", params)
    sd = {f"trunk.{k}": v for k, v in trunk_state_dict_from_jax(p["trunk"], cfg).items()}
    _linear(sd, "final_proj", p["final_proj"])
    sd["label_embs"] = _tensor(p["label_embs"])
    return sd


def data2vec_pretrain_state_dict_from_jax(params: Dict[str, Any], cfg
                                          ) -> Dict[str, torch.Tensor]:
    """JAX data2vec task params ``{student, teacher}`` -> the port's
    `StudentTeacher` state_dict."""
    p = params.get("params", params)
    return {f"{key}.{k}": v for key in ("student", "teacher")
            for k, v in trunk_state_dict_from_jax(p[key], cfg).items()}


def mam_pretrain_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX masked-reconstruction params ``{encoder, head}`` (a
    MockingjayEncoder and its SpecPredictionHead) -> the port's
    `MamPretrainModel` state_dict."""
    p = params.get("params", params)
    sd = mockingjay_state_dict_from_jax(p["encoder"], prefix="encoder.")
    head = p["head"]
    _linear(sd, "head.dense", head["dense"])
    _norm(sd, "head.LayerNorm", head["layer_norm"])
    _linear(sd, "head.output", head["output"])
    return sd


def apc_pretrain_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX APC task params ``{apc}`` -> the port's `ApcPretrainModel`
    state_dict."""
    return apc_state_dict_from_jax(params.get("params", params)["apc"], prefix="apc.")


def npc_pretrain_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NPC task variables ``{params: {npc}, batch_stats: {npc}}`` -> the
    port's `NpcPretrainModel` state_dict."""
    inner = {"params": variables["params"]["npc"],
             "batch_stats": variables.get("batch_stats", {}).get("npc", {})}
    return {f"npc.{k}": v for k, v in npc_state_dict_from_jax(inner).items()}


def _torch_load(path):
    _torch_only(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def load_trunk_checkpoint(path, fallback_cfg: Wav2Vec2Config | None = None
                          ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """A trunk checkpoint -> (config, the port's state_dict) (the JAX
    `load_trunk_variables`, convert.py:260-321): s3prl's ``{"model_weight",
    "model_cfg", "task_cfg"}`` takes its config from the checkpoint
    (`config_from_model_cfg`), a bare state_dict ``fallback_cfg`` (the
    entry's). A Conformer's keys include its BatchNorm statistics.
    A checkpoint of HuBERT or data2vec pretraining (`native_checkpoint`: the
    JAX package's msgpack or the port's ``model.pt``, the train or step
    directory or the file) gives its trunk under ``fallback_cfg`` (the JAX
    `load_trunk_variables`' rule: the entry's configuration)."""
    native = native_checkpoint(path)
    if native is not None:
        cfg = fallback_cfg or Wav2Vec2Config()
        return cfg, _native_trunk(path, *native, cfg)
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict) and any(k.startswith(("trunk.", "student.")) for k in ckpt):
        cfg = fallback_cfg or Wav2Vec2Config()  # a pretraining task's model.pt itself
        return cfg, _native_trunk(path, "torch", ckpt, cfg)
    if isinstance(ckpt, dict) and "model_weight" in ckpt:
        sd = ckpt["model_weight"]
        cfg = config_from_model_cfg(ckpt.get("model_cfg", {}), ckpt.get("task_cfg", {}))
    else:
        sd, cfg = ckpt, fallback_cfg or Wav2Vec2Config()
    return cfg, trunk_state_dict_from_torch(sd, cfg)


def load_wavlm_checkpoint(path) -> Tuple[WavLMConfig, Dict[str, torch.Tensor]]:
    """A Microsoft-style WavLM checkpoint ``{"cfg", "model"}`` -> (config,
    the port's state_dict) (convert.py:419-431). A native pretraining
    checkpoint raises NotImplementedError (`_torch_only`)."""
    ckpt = _torch_load(path)
    cfg = wavlm_config_from_cfg(ckpt.get("cfg", {}))
    return cfg, wavlm_state_dict_from_torch(ckpt["model"], cfg)


# -- the wav2vec2-style zoo: DistilHuBERT, LightHuBERT, MR-HuBERT, ESPnet HuBERT ------

def load_distiller_checkpoint(path) -> Tuple[DistillerConfig, Dict[str, torch.Tensor]]:
    """A DistilHuBERT pretraining checkpoint ``{"Distiller": state_dict,
    "Config": {"distiller": {...}}}`` (or a bare state_dict) -> (config, the
    port's `DistillerModel` state_dict) (convert.py:535-566): the pos-conv's
    weight norm folded, the prediction heads ``output_layer.{0,2}``."""
    ckpt = _torch_load(path)
    dcfg = ckpt.get("Config", {}).get("distiller", {}) if isinstance(ckpt, dict) else {}
    sd = ckpt.get("Distiller", ckpt) if isinstance(ckpt, dict) else ckpt
    conv = dcfg.get("extractor_conv_feature_layers",
                    "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2")
    cfg = DistillerConfig(
        conv_feature_layers=_conv_layers(str(conv)),
        extractor_mode=str(dcfg.get("extractor_mode", "default")),
        encoder_layers=int(dcfg.get("encoder_layers", 2)),
        encoder_embed_dim=int(dcfg.get("encoder_embed_dim", 768)),
        encoder_ffn_embed_dim=int(dcfg.get("encoder_ffn_embed_dim", 3072)),
        encoder_attention_heads=int(dcfg.get("encoder_attention_heads", 12)),
        layer_norm_first=bool(dcfg.get("layer_norm_first", False)),
        conv_pos=int(dcfg.get("conv_pos", 128)),
        conv_pos_groups=int(dcfg.get("conv_pos_groups", 16)),
        final_dim=int(dcfg.get("final_dim", 768)),
        n_tasks=int(dcfg.get("n_tasks", 12)),
        out_layer_inter_dim=int(dcfg.get("out_layer_inter_dim", -1)))
    out: Dict[str, torch.Tensor] = {}
    _extractor_keys(out, sd, cfg)
    keys = ["output_layer.0.weight", "output_layer.0.bias", "output_layer.2.weight"]
    if cfg.conv_feature_layers[-1][0] != cfg.encoder_embed_dim:
        keys += ["post_extract_proj.weight", "post_extract_proj.bias"]
    for key in keys:
        _copy(out, sd, key)
    out["output_layer.2.bias"] = _t(sd["output_layer.2.bias"]).reshape(
        1, 1, cfg.n_tasks, cfg.final_dim)
    _pos_conv_keys(out, sd)
    _encoder_keys(out, sd, cfg.encoder_layers)
    return cfg, out


def lighthubert_state_dict_from_torch(sd: Dict[str, Any], cfg: LightHubertConfig
                                      ) -> Dict[str, torch.Tensor]:
    """A LightHuBERT supernet state_dict sliced to the subnet of `cfg`, on
    the host (convert.py:1437-1543): every scaling module takes a weight
    prefix, q / k / v [:A, :E], out_proj [:E, :A], norms [:E] (A = heads x
    64); fc1 / fc2 take the first E rows / columns of each of the
    supernet's FFN blocks (F_super / E_super of them, E_super wide); the
    pos-conv's weight norm is folded over the whole supernet weight, then
    sliced [:E, :E / groups]."""
    E, Fd = cfg.embed_dim, cfg.ffn_dim
    A = cfg.num_heads * 64  # the head dim stays 64 (scaling_multihead.py:156)
    E_super = _t(sd["post_extract_proj.weight"]).shape[0]
    F_super = _t(sd["encoder.layers.0.fc1.bias"]).shape[0]
    block = F_super // (F_super // E_super)
    splits = Fd / E
    size = int(Fd / splits)
    block_rows = torch.cat([torch.arange(i * block, i * block + min(size, Fd - i * size))
                            for i in range(math.ceil(splits))])
    out: Dict[str, torch.Tensor] = {}
    _extractor_keys(out, sd, cfg)
    for kind in ("weight", "bias"):
        _copy(out, sd, f"layer_norm.{kind}")
        out[f"post_extract_proj.{kind}"] = _t(sd[f"post_extract_proj.{kind}"])[:E]
        out[f"encoder.layer_norm.{kind}"] = _t(sd[f"encoder.layer_norm.{kind}"])[:E]
    w = _fold_weight_norm(_t(sd["encoder.pos_conv.0.weight_g"]),
                          _t(sd["encoder.pos_conv.0.weight_v"]))
    out["encoder.pos_conv.0.weight"] = w[:E, :E // cfg.conv_pos_groups].contiguous()
    out["encoder.pos_conv.0.bias"] = _t(sd["encoder.pos_conv.0.bias"])[:E]
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        for name in "qkv":
            key = f"{pre}.self_attn.{name}_proj"
            out[f"{key}.weight"] = _t(sd[f"{key}.weight"])[:A, :E].contiguous()
            out[f"{key}.bias"] = _t(sd[f"{key}.bias"])[:A]
        key = f"{pre}.self_attn.out_proj"
        out[f"{key}.weight"] = _t(sd[f"{key}.weight"])[:E, :A].contiguous()
        out[f"{key}.bias"] = _t(sd[f"{key}.bias"])[:E]
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            for kind in ("weight", "bias"):
                out[f"{pre}.{norm}.{kind}"] = _t(sd[f"{pre}.{norm}.{kind}"])[:E]
        out[f"{pre}.fc1.weight"] = _t(sd[f"{pre}.fc1.weight"])[block_rows, :E].contiguous()
        out[f"{pre}.fc1.bias"] = _t(sd[f"{pre}.fc1.bias"])[block_rows]
        out[f"{pre}.fc2.weight"] = _t(sd[f"{pre}.fc2.weight"])[:E][:, block_rows].contiguous()
        out[f"{pre}.fc2.bias"] = _t(sd[f"{pre}.fc2.bias"])[:E]
    return out


def load_lighthubert_checkpoint(path) -> Tuple[LightHubertConfig, Dict[str, torch.Tensor]]:
    """A LightHuBERT checkpoint ``{"cfg": {"model": {...}}, "model":
    state_dict}`` -> (config, the port's state_dict) with the expert's
    subnet choice (convert.py:1546-1593): a pruner checkpoint (the default
    ``_name``) takes its supernet type's published subnet, a
    ``student_hubert`` the largest subnet; ``pruner_supernet`` naming a
    small / base yaml sets the type."""
    ckpt = _torch_load(path)
    model_cfg = ckpt.get("cfg", {}).get("model", {}) if isinstance(ckpt, dict) else {}
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    kind = str(model_cfg.get("supernet_type", "base")).lower()
    pruner = str(model_cfg.get("pruner_supernet", "")).lower()
    if pruner.endswith("small.yaml"):
        kind = "small"
    elif pruner.endswith("base.yaml"):
        kind = "base"
    if model_cfg.get("_name", "hubert_pruner") == "student_hubert":
        subnet = SUBNET_BASE_MAX if kind == "base" else SUBNET_SMALL_MAX
    else:
        subnet = SUBNET_BASE if kind == "base" else SUBNET_SMALL
    conv = model_cfg.get("conv_feature_layers",
                         "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2")
    cfg = LightHubertConfig.of_subnet(
        subnet, conv_feature_layers=_conv_layers(conv),
        extractor_mode=str(model_cfg.get("extractor_mode", "layer_norm")),
        conv_bias=bool(model_cfg.get("conv_bias", False)),
        conv_pos=int(model_cfg.get("conv_pos", 128)),
        conv_pos_groups=int(model_cfg.get("conv_pos_groups", 16)),
        layer_norm_first=bool(model_cfg.get("layer_norm_first", False)))
    return cfg, lighthubert_state_dict_from_torch(sd, cfg)


def multires_config_from_model_cfg(model_cfg: Dict[str, Any],
                                   task_cfg: Dict[str, Any] | None = None
                                   ) -> MultiresHubertConfig:
    """The MR-HuBERT config of an s3prl ``model_cfg`` (a copy of
    convert.py:1063-1096)."""
    override = model_cfg.get("override_encoder_layers", "")
    kwargs = dict(
        extractor_mode=model_cfg.get("extractor_mode", "default"),
        conv_bias=model_cfg.get("conv_bias", False),
        encoder_embed_dim=model_cfg.get("encoder_embed_dim", 768),
        encoder_ffn_embed_dim=model_cfg.get("encoder_ffn_embed_dim", 3072),
        encoder_attention_heads=model_cfg.get("encoder_attention_heads", 12),
        activation_fn=model_cfg.get("activation_fn", "gelu"),
        layer_norm_first=model_cfg.get("layer_norm_first", False),
        conv_pos=model_cfg.get("conv_pos", 128),
        conv_pos_groups=model_cfg.get("conv_pos_groups", 16),
        label_rate_ratios=tuple(model_cfg.get("label_rate_ratios", (1, 2))),
        encoder_layers=int(model_cfg.get("encoder_layers", 2)),
        override_encoder_layers=tuple(ast.literal_eval(override) if isinstance(override, str)
                                      else override) if override else (),
        conv_adapator_kernal=int(model_cfg.get("conv_adapator_kernal", 7)),
        use_plain_updownsample=bool(model_cfg.get("use_plain_updownsample", False)),
        dropout=model_cfg.get("dropout", 0.1),
        attention_dropout=model_cfg.get("attention_dropout", 0.1),
        activation_dropout=model_cfg.get("activation_dropout", 0.0),
        dropout_input=model_cfg.get("dropout_input", 0.1),
        normalize=(task_cfg or {}).get("normalize", False))
    conv = _conv_layers(model_cfg.get("conv_feature_layers"))
    if conv is not None:
        kwargs["conv_feature_layers"] = conv
    return MultiresHubertConfig(**kwargs)


def load_multires_hubert_checkpoint(path) -> Tuple[MultiresHubertConfig,
                                                   Dict[str, torch.Tensor]]:
    """An s3prl MR-HuBERT checkpoint ``{"model_weight", "model_cfg",
    "task_cfg"}`` -> (config, the port's state_dict) (convert.py:1015-1131):
    each block's encoder (the first one's pos-conv folded), the resampling
    modules' convs and group norms."""
    ckpt = _torch_load(path)
    cfg = multires_config_from_model_cfg(ckpt.get("model_cfg", {}), ckpt.get("task_cfg", {}))
    sd = ckpt["model_weight"]
    out: Dict[str, torch.Tensor] = {}
    _extractor_keys(out, sd, cfg)
    for prefix in ["layer_norm"] + (["post_extract_proj"] if "post_extract_proj.weight" in sd
                                    else []):
        for kind in ("weight", "bias"):
            _copy(out, sd, f"{prefix}.{kind}")
    blocks, n = cfg.block_layers, cfg.n_pairs
    for i in range(n):
        _encoder_keys(out, sd, blocks[i], f"encoders.{i}")
        _encoder_keys(out, sd, blocks[n + 1 + i], f"decoders.{i}")
        halves = ({"downsample": ("downsample_conv",), "upsample": ("upsample_conv",)}
                  if cfg.use_plain_updownsample else
                  dict.fromkeys(("downsample", "upsample"), ("upsample_conv", "downsample_conv")))
        for kind, names in halves.items():
            for name in names:
                pre = f"{kind}_modules.{i}.{name}"
                for key in (f"{pre}.0.weight", f"{pre}.2.weight", f"{pre}.2.bias"):
                    _copy(out, sd, key)
    _encoder_keys(out, sd, blocks[n], "middle_encoder")
    _pos_conv_keys(out, sd, "encoders.0" if n else "middle_encoder")
    return cfg, out


# torchaudio's names of a transformer layer's modules -> fairseq's (convert.py:1796-1805)
_TORCHAUDIO_LAYER_KEYS = {
    "attention.k_proj": "self_attn.k_proj", "attention.v_proj": "self_attn.v_proj",
    "attention.q_proj": "self_attn.q_proj", "attention.out_proj": "self_attn.out_proj",
    "layer_norm": "self_attn_layer_norm", "feed_forward.intermediate_dense": "fc1",
    "feed_forward.output_dense": "fc2", "final_layer_norm": "final_layer_norm"}


def torchaudio_to_fairseq_keys(sd: Dict[str, Any], extractor_mode: str) -> Dict[str, Any]:
    """torchaudio Wav2Vec2Model keys -> fairseq's (a copy of convert.py:
    1808-1851); keys without a fairseq name are dropped."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        nk = None
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            if rest.startswith("conv."):
                nk = f"feature_extractor.conv_layers.{i}.0.{rest[len('conv.'):]}"
            elif rest.startswith("layer_norm."):
                suffix = rest[len("layer_norm."):]
                nk = (f"feature_extractor.conv_layers.{i}.2.1.{suffix}"
                      if extractor_mode == "layer_norm" else
                      f"feature_extractor.conv_layers.{i}.2.{suffix}")
        elif k.startswith("encoder.feature_projection.layer_norm."):
            nk = "layer_norm." + k.rsplit(".", 1)[1]
        elif k.startswith("encoder.feature_projection.projection."):
            nk = "post_extract_proj." + k.rsplit(".", 1)[1]
        elif k.startswith("encoder.transformer.pos_conv_embed.conv."):
            rest = k[len("encoder.transformer.pos_conv_embed.conv."):]
            rest = {"parametrizations.weight.original0": "weight_g",
                    "parametrizations.weight.original1": "weight_v"}.get(rest, rest)
            nk = f"encoder.pos_conv.0.{rest}"
        elif k.startswith("encoder.transformer.layer_norm."):
            nk = "encoder.layer_norm." + k.rsplit(".", 1)[1]
        elif k.startswith("encoder.transformer.layers."):
            parts = k.split(".")
            rest = ".".join(parts[4:-1])
            if rest in _TORCHAUDIO_LAYER_KEYS:
                nk = f"encoder.layers.{parts[3]}.{_TORCHAUDIO_LAYER_KEYS[rest]}.{parts[-1]}"
        elif k == "mask_generator.mask_embedding":
            nk = "mask_emb"
        if nk is not None:
            out[nk] = v
    return out


def espnet_hubert_config_from_sd(sd: Dict[str, Any], conf: Dict[str, Any] | None = None
                                 ) -> Wav2Vec2Config:
    """The trunk config of a fairseq-renamed ESPnet HuBERT state_dict, with
    the espnet ``encoder_conf`` overrides (a copy of convert.py:1854-1903):
    the widths and depth from the weights, the extractor mode from its
    per-layer LNs, heads 12 up to C 768 else 16, pre-LN from C 1,024, the
    conv strides 5 then 2 (or the config's table), the pos-conv geometry
    from its weight; the block length rule, no wave normalisation."""
    conf = conf or {}
    C = int(sd["encoder.layer_norm.weight"].shape[0])
    n = 0
    while f"encoder.layers.{n}.fc1.weight" in sd:
        n += 1
    if "extractor_conv_layer_config" in conf:
        conv_layers = tuple(tuple(t) for t in conf["extractor_conv_layer_config"])
    else:
        conv_layers, i = [], 0
        while f"feature_extractor.conv_layers.{i}.0.weight" in sd:
            w = sd[f"feature_extractor.conv_layers.{i}.0.weight"]
            conv_layers.append((int(w.shape[0]), int(w.shape[2]), 5 if i == 0 else 2))
            i += 1
        conv_layers = tuple(conv_layers)
    pos_w = sd.get("encoder.pos_conv.0.weight_v", sd.get("encoder.pos_conv.0.weight"))
    conv_pos, conv_pos_groups = ((int(pos_w.shape[2]), C // int(pos_w.shape[1]))
                                 if pos_w is not None else (128, 16))
    return Wav2Vec2Config(
        encoder_embed_dim=C, encoder_layers=max(n, 1),
        encoder_ffn_embed_dim=int(sd["encoder.layers.0.fc1.weight"].shape[0]),
        encoder_attention_heads=int(conf.get("encoder_num_heads", 12 if C <= 768 else 16)),
        layer_norm_first=bool(conf.get("encoder_layer_norm_first", C >= 1024)),
        extractor_mode=("layer_norm" if "feature_extractor.conv_layers.1.2.1.weight" in sd
                        else "default"),
        conv_bias="feature_extractor.conv_layers.0.0.bias" in sd,
        conv_feature_layers=conv_layers, conv_pos=conv_pos, conv_pos_groups=conv_pos_groups,
        normalize=bool(conf.get("normalize", False)))


def load_espnet_hubert_checkpoint(path, config=None
                                  ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """An espnet2 torchaudio-HuBERT checkpoint -> (config, the port's trunk
    state_dict) (convert.py:1906-1945): an espnet ``.pth`` (keys under
    ``encoder.hubert_pretrain_model.``), a bare HuBERTPretrainModel state
    dict (``hubert_pretrain_model.`` / ``wav2vec2.``) or a bare torchaudio
    Wav2Vec2Model one; `config` the espnet config.yaml, whose
    ``encoder_conf`` overrides what the weights imply. The extractor mode
    is sniffed from the torchaudio names before the renaming."""
    ckpt = _torch_load(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    for prefix in ("encoder.hubert_pretrain_model.", "hubert_pretrain_model."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    if any(k.startswith("wav2vec2.") for k in sd):
        inner = {k[len("wav2vec2."):]: v for k, v in sd.items() if k.startswith("wav2vec2.")}
        inner.update({k: v for k, v in sd.items() if k.startswith("mask_generator.")})
        sd = inner
    conf = {}
    if config is not None:
        import yaml

        with open(config) as f:
            conf = dict((yaml.safe_load(f) or {}).get("encoder_conf", {}))
    mode = ("layer_norm" if any(k.startswith("feature_extractor.conv_layers.1.layer_norm.")
                                for k in sd) else "default")
    fsd = torchaudio_to_fairseq_keys(sd, mode)
    cfg = espnet_hubert_config_from_sd(fsd, conf)
    return cfg, trunk_state_dict_from_torch(fsd, cfg)


# -- the mel-domain SSL models (Mockingjay / TERA / AudioALBERT, APC, NPC) -----------

# the reference TransformerModel's names of a block's layers (convert.py:449-458)
_BERT_DENSE = (("query", "attention.self.query"), ("key", "attention.self.key"),
               ("value", "attention.self.value"), ("attn_output", "attention.output.dense"),
               ("intermediate", "intermediate.dense"), ("output", "output.dense"))
_BERT_NORMS = (("attn_layer_norm", "attention.output.LayerNorm"),
               ("out_layer_norm", "output.LayerNorm"))


def mockingjay_state_dict_from_jax(params: Dict[str, Any], prefix: str = ""
                                   ) -> Dict[str, torch.Tensor]:
    """JAX MockingjayEncoder params -> the port's `MockingjayEncoder`
    state_dict (the reference's keys, after `prefix`), the inverse of
    s3prl_tpu/upstream/convert.py `mockingjay_params_from_torch`: the
    scanned ``layers`` subtree (a leading L axis) un-stacked into
    ``encoder.layer.{i}``; AudioALBERT's single set (no L axis) as
    ``encoder.layer.0``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, f"{prefix}input_representations.spec_transform", p["spec_transform"])
    _norm(sd, f"{prefix}input_representations.LayerNorm", p["input_layer_norm"])
    layers = p["layers"]
    stacked = np.ndim(layers["query"]["kernel"]) == 3
    for i in range(np.shape(layers["query"]["kernel"])[0] if stacked else 1):
        index = i if stacked else None
        pre = f"{prefix}encoder.layer.{i}"
        for name, key in _BERT_DENSE:
            _linear(sd, f"{pre}.{key}", layers[name], index)
        for name, key in _BERT_NORMS:
            _norm(sd, f"{pre}.{key}", layers[name], index)
    return sd


def apc_state_dict_from_jax(params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX APCModel params -> the port's `APCModel` state_dict (the
    reference's keys), the inverse of convert.py `_gru_params_from_torch`
    (:576-597): each flax ``GRUCell`` ``cell_{i}`` -> ``rnn_layers.{i}``
    with the gates [r; z; n] stacked, its folded r / z input biases in
    ``bias_ih`` and zeros for them in ``bias_hh`` (flax's ``hr`` / ``hz``
    have none), ``hn``'s bias in ``bias_hh``; ``vq_{g}`` -> ``vq_layers.{g}``
    (``codebook`` [C, E] -> ``codebook_CxE.weight`` [E, C]); ``postnet``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"cell_{i}" in p:
        cell = p[f"cell_{i}"]
        pre = f"{prefix}rnn_layers.{i}"
        kernels = lambda kind: np.concatenate(  # noqa: E731
            [np.asarray(cell[f"{kind}{g}"]["kernel"]) for g in "rzn"], axis=1).T
        sd[f"{pre}.weight_ih_l0"] = _tensor(kernels("i"))
        sd[f"{pre}.weight_hh_l0"] = _tensor(kernels("h"))
        sd[f"{pre}.bias_ih_l0"] = _tensor(np.concatenate(
            [np.asarray(cell[f"i{g}"]["bias"]) for g in "rzn"]))
        hn = np.asarray(cell["hn"]["bias"])
        sd[f"{pre}.bias_hh_l0"] = _tensor(np.concatenate([np.zeros(2 * hn.size), hn]))
        i += 1
    g = 0
    while f"vq_{g}" in p:
        _linear(sd, f"{prefix}vq_layers.{g}.vq_logits", p[f"vq_{g}"]["vq_logits"])
        sd[f"{prefix}vq_layers.{g}.codebook_CxE.weight"] = _tensor(
            np.asarray(p[f"vq_{g}"]["codebook"]).T)
        g += 1
    _linear(sd, f"{prefix}postnet", p["postnet"])
    return sd


def npc_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX NPCModel variables ({"params", "batch_stats"}) -> the port's
    `NPCModel` state_dict (the reference's keys), the inverse of convert.py
    `npc_variables_from_torch` (:921-955): conv kernels -> weights, each
    BatchNorm's ``scale`` / ``bias`` and ``batch_stats`` ``mean`` / ``var``
    -> ``weight`` / ``bias`` / ``running_mean`` / ``running_var`` (with
    ``num_batches_tracked`` 0)."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix, tree):
        sd[f"{prefix}.weight"] = _conv(tree["kernel"])
        sd[f"{prefix}.bias"] = _tensor(tree["bias"])

    i = 0
    while f"block_{i}" in p:
        block, pre = p[f"block_{i}"], f"blocks.{i}"
        conv(f"{pre}.conv", block["conv"])
        conv(f"{pre}.linear", block["linear"])
        for bn in ("bn1", "bn2"):
            if bn in block:
                _norm(sd, f"{pre}.{bn}", block[bn])
                sd[f"{pre}.{bn}.running_mean"] = _tensor(stats[f"block_{i}"][bn]["mean"])
                sd[f"{pre}.{bn}.running_var"] = _tensor(stats[f"block_{i}"][bn]["var"])
                sd[f"{pre}.{bn}.num_batches_tracked"] = torch.tensor(0)
        if f"masked_conv_{i}" in p:
            conv(f"masked_convs.{i}.conv", p[f"masked_conv_{i}"])
        i += 1
    _linear(sd, "postnet", p["postnet"])
    return sd


def _mockingjay_keys(sd: Dict[str, Any], num_layers: int) -> Dict[str, torch.Tensor]:
    """The keys the JAX `mockingjay_params_from_torch` reads (convert.py:
    434-468), of `num_layers` blocks, f32."""
    names = [f"input_representations.{n}" for n in ("spec_transform", "LayerNorm")] + [
        f"encoder.layer.{i}.{key}" for i in range(num_layers)
        for _, key in _BERT_DENSE + _BERT_NORMS]
    return {f"{n}.{kind}": _t(sd[f"{n}.{kind}"]) for n in names for kind in ("weight", "bias")}


def _layer_count(sd: Dict[str, Any], prefix: str) -> int:
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in sd):
        n += 1
    return n


def _apc_keys(sd: Dict[str, Any], vq: bool = True) -> Dict[str, torch.Tensor]:
    """The keys the JAX `apc_params_from_torch` reads (convert.py:600-614):
    every GRU layer (``rnn_layers.{i}`` while ``weight_ih_l0`` exists, at
    least one), ``postnet``, and with `vq` each ``vq_layers.{g}``."""
    n = 0
    while f"rnn_layers.{n}.weight_ih_l0" in sd:
        n += 1
    keys = [f"rnn_layers.{i}.{kind}_{part}_l0" for i in range(max(n, 1))
            for kind in ("weight", "bias") for part in ("ih", "hh")]
    keys += ["postnet.weight", "postnet.bias"]
    g = 0
    while vq and f"vq_layers.{g}.vq_logits.weight" in sd:
        keys += [f"vq_layers.{g}.vq_logits.weight", f"vq_layers.{g}.vq_logits.bias",
                 f"vq_layers.{g}.codebook_CxE.weight"]
        g += 1
    return {k: _t(sd[k]) for k in keys}


def load_mel_ssl_checkpoint(name: str, path) -> Dict[str, torch.Tensor]:
    """A mel-domain SSL checkpoint of the reference -> the port's state_dict
    of entry `name`'s model (the torch branch of the JAX
    `load_mel_ssl_checkpoint`, convert.py:876-914, key for key):

    - ``apc`` / ``vq_apc``, ``npc``: ``{"config", "model"}`` or a bare
      state_dict; NPC's BatchNorms only with ``config.model.paras``'
      ``batch_norm`` (default True), ``num_batches_tracked`` kept or 0;
    - ``mockingjay`` / ``tera`` / ``audio_albert``: the state_dict under
      ``SelfSupervisedLearning``, ``Transformer``, ``model`` or
      ``state_dict``, or a bare one, with or without the ``transformer.``
      prefix; its blocks counted from ``encoder.layer.{i}``; ``audio_albert``
      shares one block when the checkpoint holds one.

    A checkpoint of pretraining (`native_checkpoint`: the JAX package's
    msgpack or the port's ``model.pt``) gives its task's model
    (convert.py:846-874): the ``encoder`` subtree for ``mockingjay`` /
    ``tera`` / ``audio_albert``, ``apc`` for ``apc`` / ``vq_apc``, and NPC's
    ``{params: {npc}, batch_stats: {npc}}`` (the port's ``npc.`` keys, with
    the running statistics); another layout raises ValueError. An
    ``audio_albert`` checkpoint
    listing more than one block raises ValueError: the reference's shared
    encoder lists its one block at every depth (``encoder.layer.0-2``),
    which the JAX loader reads as that many distinct stacked blocks and
    its shared model then cannot apply."""
    native = native_checkpoint(path)
    if native is not None:
        return _native_mel(path, name, *native)
    ckpt = _torch_load(path)
    if name.startswith(("apc", "vq_apc")):
        return _apc_keys(ckpt.get("model", ckpt))
    if name.startswith("npc"):
        sd = ckpt.get("model", ckpt)
        paras = ckpt.get("config", {}).get("model", {}).get("paras", {})
        batch_norm = bool(paras.get("batch_norm", True))
        out: Dict[str, torch.Tensor] = {}
        for i in range(int(paras.get("n_blocks", 4))):
            layers = ["conv", "linear"] + (["bn1", "bn2"] if batch_norm else [])
            for layer in layers:
                pre = f"blocks.{i}.{layer}"
                kinds = ["weight", "bias"] + (
                    ["running_mean", "running_var"] if layer.startswith("bn") else [])
                for kind in kinds:
                    if f"{pre}.{kind}" in sd:
                        out[f"{pre}.{kind}"] = _t(sd[f"{pre}.{kind}"])
                if layer.startswith("bn"):
                    out[f"{pre}.num_batches_tracked"] = torch.as_tensor(
                        sd.get(f"{pre}.num_batches_tracked", 0)).long()
            if f"masked_convs.{i}.conv.weight" in sd:
                for kind in ("weight", "bias"):
                    out[f"masked_convs.{i}.conv.{kind}"] = _t(sd[f"masked_convs.{i}.conv.{kind}"])
        for kind in ("weight", "bias"):
            out[f"postnet.{kind}"] = _t(sd[f"postnet.{kind}"])
        return out
    sd = next((ckpt[key] for key in ("SelfSupervisedLearning", "Transformer", "model",
                                     "state_dict") if isinstance(ckpt.get(key), dict)), ckpt)
    if any(k.startswith("transformer.") for k in sd):
        sd = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    num_layers = _layer_count(sd, "encoder.layer.")
    if name == "audio_albert" and num_layers > 1:
        raise ValueError(
            f"{path}: an audio_albert checkpoint listing {num_layers} blocks "
            f"(encoder.layer.0-{num_layers - 1}) reads two ways: the reference's shared "
            f"block repeated at every depth, or {num_layers} distinct blocks; the JAX "
            "package loads it as distinct stacked blocks, which its shared model cannot "
            "apply. Pass a checkpoint holding the one shared block (encoder.layer.0)")
    return _mockingjay_keys(sd, max(num_layers, 1))


def _native_mel(path, name: str, kind: str, tree) -> Dict[str, torch.Tensor]:
    """Entry `name`'s model from a pretraining checkpoint's task tree."""
    if name.startswith("npc"):
        if kind == "jax":
            if "npc" not in tree.get("params", {}):
                raise _native_layout_error(path, tree, "the NPC task layout ({'params': "
                                           "{'npc': ...}, 'batch_stats': ...})")
            return _subtree(npc_pretrain_state_dict_from_jax(tree), "npc")
        key = "npc"
    else:
        key = ("encoder" if name.startswith(("mockingjay", "tera", "audio_albert"))
               else "apc" if name.startswith(("apc", "vq_apc")) else None)
    keys = set(tree) if kind == "jax" else {k.split(".")[0] for k in tree}
    if key is None or key not in keys:
        raise _native_layout_error(
            path, keys, f"a '{key}' subtree for upstream '{name}' (supported native round "
            "trips: mockingjay/tera/audio_albert, apc/vq_apc, npc)")
    if kind == "torch":
        return _subtree(tree, key)
    if key == "apc":
        return apc_state_dict_from_jax(tree["apc"])
    return mockingjay_state_dict_from_jax(tree["encoder"])


# -- the MOS predictor (s3prl_tpu/upstream/convert.py:1202-1300) --------------------


def _find_config_value(tree, key):
    """Depth-first search of a nested config dict for an int `key` -> int or
    None (a copy of convert.py:1202-1211)."""
    if isinstance(tree, dict):
        if key in tree and isinstance(tree[key], int):
            return tree[key]
        for v in tree.values():
            found = _find_config_value(v, key)
            if found is not None:
                return found
    return None


def mos_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX MosModel params -> the port's `MosModel` state_dict: the
    featurizer's weights, ``connector``, ``mean_net_linear`` and
    ``mean_net_pooling`` as Dense layers, the upstream under ``apc.``
    (`apc_state_dict_from_jax`), ``tera.`` (`mockingjay_state_dict_from_jax`)
    or ``trunk.`` (`trunk_state_dict_from_jax`)."""
    p = params.get("params", params)
    sd = {"featurizer_weights": _tensor(p["featurizer_weights"])}
    for name in ("connector", "mean_net_linear", "mean_net_pooling"):
        if name in p:
            _linear(sd, name, p[name])
    if cfg.upstream == "apc":
        sd.update(apc_state_dict_from_jax(p["apc"], "apc."))
    elif cfg.upstream == "tera":
        sd.update(mockingjay_state_dict_from_jax(p["tera"], "tera."))
    else:
        sd.update({f"trunk.{k}": v for k, v in trunk_state_dict_from_jax(p["trunk"],
                                                                        cfg.trunk).items()})
    return sd


def load_mos_checkpoint(path):
    """A mos_{wav2vec2,apc,tera} checkpoint ``{"Upstream", "Featurizer",
    "Downstream", "Config"}`` -> (MosConfig, the port's `MosModel`
    state_dict), reading what the JAX `load_mos_checkpoint` reads
    (convert.py:1214-1300): the upstream's variant from its keys (``model.``
    stripped: ``rnn_layers`` APC, ``spec_transform`` a ``transformer.``
    TransformerModel, else wav2vec2-Base), its widths from the weights' shapes,
    TERA's heads from the Config (12 when the width divides by 12, else 4),
    the head's options from ``Config.downstream_expert.modelrc``."""
    from ..models.apc import APCConfig
    from ..models.mockingjay import MockingjayConfig
    from ..models.mos import MosConfig

    ckpt = _torch_load(path)
    up_sd = {(k[len("model."):] if k.startswith("model.") else k): v
             for k, v in ckpt["Upstream"].items()}
    modelrc = ckpt.get("Config", {}).get("downstream_expert", {}).get("modelrc", {})
    down_sd = ckpt["Downstream"]
    common = dict(
        projector_dim=int(modelrc.get("projector_dim", down_sd["connector.weight"].shape[0])),
        clipping=bool(modelrc.get("clipping", False)),
        attention_pooling=bool(modelrc.get("attention_pooling", False)))
    sd = {"featurizer_weights": _t(ckpt["Featurizer"]["weights"])}
    for name, key in (("connector", "connector"), ("mean_net_linear", "model.mean_net_linear")):
        for kind in ("weight", "bias"):
            sd[f"{name}.{kind}"] = _t(down_sd[f"{key}.{kind}"])
    if any("rnn_layers" in k for k in up_sd):  # mos_apc
        apc = _apc_keys(up_sd, vq=False)
        n = _layer_count(apc, "rnn_layers.")
        cfg = MosConfig(upstream="apc", apc=APCConfig(
            input_size=int(up_sd["postnet.weight"].shape[0]),
            hidden_size=int(up_sd["rnn_layers.0.weight_hh_l0"].shape[1]), num_layers=n),
            feat_kind="mel", **common)
        sd.update({f"apc.{k}": v for k, v in apc.items()})
    elif any("spec_transform" in k for k in up_sd):  # mos_tera
        tera = up_sd
        if any(k.startswith("transformer.") for k in tera):
            tera = {k[len("transformer."):]: v for k, v in tera.items()
                    if k.startswith("transformer.")}
        n = max(_layer_count(tera, "encoder.layer."), 1)
        hidden, in_dim = tera["input_representations.spec_transform.weight"].shape
        heads = _find_config_value(ckpt.get("Config", {}), "num_attention_heads")
        if heads is None:
            heads = 12 if hidden % 12 == 0 else 4
        cfg = MosConfig(upstream="tera", tera=MockingjayConfig(
            input_dim=int(in_dim), hidden_size=int(hidden), num_hidden_layers=n,
            num_attention_heads=heads,
            intermediate_size=int(tera["encoder.layer.0.intermediate.dense.weight"].shape[0])),
            feat_kind="fbank_delta" if in_dim == 240 else "mel", **common)
        sd.update({f"tera.{k}": v for k, v in _mockingjay_keys(tera, n).items()})
    else:  # mos_wav2vec2: the released MOS rides wav2vec2-Base
        cfg = MosConfig(trunk=config_from_model_cfg({}), **common)
        sd.update({f"trunk.{k}": v for k, v in
                   trunk_state_dict_from_torch(up_sd, cfg.trunk).items()})
    if cfg.attention_pooling:
        for kind in ("weight", "bias"):
            sd[f"mean_net_pooling.{kind}"] = _t(down_sd[f"model.mean_net_pooling.W.{kind}"])
    return cfg, sd


_LSTM_CELL = "OptimizedLSTMCell_"
_GATES = ("i", "f", "g", "o")  # flax's and torch's gate order


def _lstm_cell(sd, base: str, suffix: str, cell: Dict[str, Any], layer: int = 0) -> None:
    """flax OptimizedLSTMCell params -> the weights ``{base}*_l{layer}{suffix}``
    of a torch LSTM: input kernels ``i{gate}`` [in, H] (no bias)
    -> ``weight_ih`` [4H, in]; hidden kernels ``h{gate}`` [H, H] with their
    biases -> ``weight_hh`` [4H, H] and ``bias_hh``; ``bias_ih`` zero."""
    cat = lambda key: np.concatenate([np.asarray(cell[f"{key}{g}"]["kernel"]) for g in _GATES], 1)
    sd[f"{base}weight_ih_l{layer}{suffix}"] = _tensor(cat("i").T)
    sd[f"{base}weight_hh_l{layer}{suffix}"] = _tensor(cat("h").T)
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
    sd[f"{base}bias_ih_l{layer}{suffix}"] = _tensor(np.zeros_like(bias))
    sd[f"{base}bias_hh_l{layer}{suffix}"] = _tensor(bias)


def probe_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax params tree of s3prl_tpu.nn.upstream.UpstreamDownstreamModel
    (numpy or jax arrays; a variables dict with a "params" entry also works)
    -> the state_dict of s3prl_tpu_torch.nn.upstream.UpstreamDownstreamModel,
    whose layers keep flax's names: Dense ``kernel [in, out]`` -> ``weight
    [out, in]``, Conv ``kernel [k, in, out]`` -> ``weight [out, in, k]``,
    ``bias``, the featurizer's ``weights`` and the task parameters at the
    top of the tree (``am_weight`` [D, C], ``ge2e_w``, ``ge2e_b``) as they
    are, flax ``nn.Embed``'s ``embedding`` [num, features] -> ``nn.Embedding``'s
    ``weight`` (the same orientation), ``nn.LayerNorm``'s ``scale`` ->
    ``weight``. A speech-translation tree ``{"encoder": ..., "decoder":
    ...}`` maps onto `SpeechTranslationTask`'s module of the same two
    names (the decoder's ``embed``, ``self_{i}`` / ``cross_{i}`` q, k, v,
    out, ``ln_*``, ``fc1_{i}`` / ``fc2_{i}``, ``output``, ``memory_proj``
    keep their names). LSTM cells ``OptimizedLSTMCell_{k}`` (flax names them in creation
    order) -> ``lstm_{layer}`` (`_lstm_cell`): RNNEncoder has one
    ``proj_{i}`` a layer, so its cells a layer are the directions (layer 0
    forward, layer 0 backward, layer 1 forward, ...; one a layer when
    unidirectional); a tree without ``proj_`` layers (SuperbDiarizationModel,
    QbeEmbedder, the VC model's Taco2-AR decoder) has one unidirectional
    cell a layer: the decoder's ``prenet.fc0`` / ``fc1``, ``lstm_{i}``,
    ``mel_out`` and ``postnet_{i}`` convs (`models.taco2ar`) under
    ``decoder.``, its featurizer's ``weights``. A subtree holding
    ``spec_transform`` and ``layers`` (the SLU head's MockingjayEncoder)
    maps through `mockingjay_state_dict_from_jax`."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        cells = sum(n.startswith(_LSTM_CELL) for n in tree)
        layers = sum(n.startswith("proj_") for n in tree)
        directions = cells // layers if layers else 1
        for name, value in tree.items():
            key = f"{prefix}{name}"
            if name.startswith(_LSTM_CELL):
                k = int(name[len(_LSTM_CELL):])
                suffix = "_reverse" if directions == 2 and k % 2 else ""
                _lstm_cell(sd, f"{prefix}lstm_{k // directions}.", suffix, value)
            elif isinstance(value, dict) and {"spec_transform", "layers"} <= set(value):
                # a MockingjayEncoder (the SLU head's): its scanned blocks'
                # kernels [L, in, out] are no conv kernels
                sd.update(mockingjay_state_dict_from_jax(value, f"{key}."))
            elif isinstance(value, dict):
                walk(value, f"{key}.")
            elif name == "kernel":
                kernel = np.asarray(value)
                sd[f"{prefix}weight"] = _tensor(kernel.T) if kernel.ndim == 2 else _conv(kernel)
            elif name in ("embedding", "scale"):  # nn.Embed [num, features] ->
                # nn.Embedding.weight; nn.LayerNorm's scale -> weight
                sd[f"{prefix}weight"] = _tensor(value)
            else:
                sd[key] = _tensor(value)

    walk(params, "")
    return sd
