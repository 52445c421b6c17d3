"""Checkpoints and JAX trunk parameters -> the port's state_dict.

From a checkpoint on disk (port of s3prl_tpu/upstream/convert.py): s3prl's
converted checkpoints ``{"model_weight", "model_cfg", "task_cfg"}`` or a
bare fairseq state_dict through `load_trunk_checkpoint`, Microsoft's WavLM
checkpoints ``{"cfg", "model"}`` through `load_wavlm_checkpoint`; each reads
the keys the JAX loader reads and returns (config, state_dict) in the keys
the port's models load (`trunk_state_dict_from_torch`,
`wavlm_state_dict_from_torch`). Nothing is downloaded.

`probe_state_dict_from_jax(params)` maps a probe's flax params (featurizer
and head) onto the port's `UpstreamDownstreamModel`.

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
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

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
    (the inverse of s3prl_tpu/upstream/convert.py:99-119)."""
    sd: Dict[str, torch.Tensor] = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.0.weight"] = _conv(fe[f"conv_{i}"]["kernel"])
        if cfg.conv_bias:
            sd[f"{pre}.0.bias"] = _tensor(fe[f"conv_{i}"]["bias"])
        if cfg.extractor_mode == "layer_norm":
            _norm(sd, f"{pre}.2.1", fe[f"ln_{i}"])
        elif i == 0:
            _norm(sd, f"{pre}.2", fe["gn_0"])
    _norm(sd, "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _linear(sd, "post_extract_proj", p["post_extract_proj"])
    sd["mask_emb"] = _tensor(p["mask_emb"])
    return sd


def _encoder(sd, pos_conv: Dict[str, Any], layer_norm: Dict[str, Any],
             layers: Dict[str, Any], cfg) -> None:
    """The pos-conv (one conv, or the depth-N stack's ``conv_{i}``), the
    final LN and the stacked layers' common parameters."""
    convs = ({"0": pos_conv["conv"]} if "conv" in pos_conv else
             {f"{i}.0": pos_conv[f"conv_{i}"] for i in range(cfg.pos_conv_depth)})
    for key, conv in convs.items():
        sd[f"encoder.pos_conv.{key}.weight"] = _conv(conv["kernel"])
        sd[f"encoder.pos_conv.{key}.bias"] = _tensor(conv["bias"])
    _norm(sd, "encoder.layer_norm", layer_norm)
    C = cfg.encoder_embed_dim
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
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


def trunk_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX Wav2Vec2Trunk params -> the port's (fairseq-keyed) state_dict."""
    p = params.get("params", params)
    sd = _front_end(p, cfg)
    enc = p["encoder"]
    _encoder(sd, enc["pos_conv"], enc["layer_norm"], enc["layers"], cfg)
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
    _encoder(sd, p["pos_conv"], p["enc_layer_norm"], layers, cfg)
    if cfg.relative_position_embedding:
        sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _tensor(
            p["relative_attention_bias"])
    for i in range(cfg.encoder_layers if cfg.gated else 0):
        pre = f"encoder.layers.{i}.self_attn"
        _linear(sd, f"{pre}.grep_linear", layers["grep_linear"], i)
        sd[f"{pre}.grep_a"] = _tensor(layers["grep_a"][i])
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


def _trunk_keys(sd: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The extractor, the feature LN, the projection, the mask embedding
    (zeros when the checkpoint has none), the final LN and every layer's
    attention, LNs and FFN (convert.py:94-175, :359-416), in the port's
    keys; the pos-conv is the caller's."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        _copy(out, sd, f"{pre}.0.weight")
        if cfg.conv_bias:
            _copy(out, sd, f"{pre}.0.bias")
        norm = (f"{pre}.2.1" if cfg.extractor_mode == "layer_norm" else
                f"{pre}.2" if cfg.extractor_mode == "default" and i == 0 else None)
        for kind in ("weight", "bias") if norm else ():
            _copy(out, sd, f"{norm}.{kind}")
    for prefix in ["layer_norm", "encoder.layer_norm"] + (
            ["post_extract_proj"] if "post_extract_proj.weight" in sd else []):
        for kind in ("weight", "bias"):
            _copy(out, sd, f"{prefix}.{kind}")
    out["mask_emb"] = (_t(sd["mask_emb"]) if "mask_emb" in sd
                       else torch.zeros(cfg.encoder_embed_dim))
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj", "self_attn_layer_norm", "fc1", "fc2",
                     "final_layer_norm"):
            for kind in ("weight", "bias"):
                _copy(out, sd, f"{pre}.{name}.{kind}")
    return out


def trunk_state_dict_from_torch(sd: Dict[str, Any], cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """A wav2vec2 / HuBERT / data2vec fairseq or s3prl state_dict -> the
    port's `Wav2Vec2Trunk` state_dict, reading what the JAX
    `trunk_params_from_torch` reads (convert.py:94-175): the pos-conv under
    weight norm (``weight_g`` / ``weight_v``) folded, data2vec's depth-N
    stack (``encoder.pos_conv.{i}.0.*``) kept, a missing ``mask_emb`` as
    zeros, every other key (``final_proj``, ``label_embs_concat``,
    ``quantizer``, ``project_q``, ...) left out. Tensors come out f32."""
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
        if "encoder.pos_conv.0.weight_g" in sd:
            out["encoder.pos_conv.0.weight"] = _fold_weight_norm(
                _t(sd["encoder.pos_conv.0.weight_g"]), _t(sd["encoder.pos_conv.0.weight_v"]))
        else:
            _copy(out, sd, "encoder.pos_conv.0.weight")
        _copy(out, sd, "encoder.pos_conv.0.bias")
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


def _refuse_native(path) -> None:
    """A checkpoint of the JAX package's own pretraining (a ``.msgpack``
    file, a step directory holding ``params.msgpack``, or a train directory
    of ``step_*`` ones; convert.py:805-827) raises NotImplementedError."""
    p = Path(path)
    native = p.suffix == ".msgpack" or (p.is_dir() and (
        (p / "params.msgpack").exists()
        or any((d / "params.msgpack").exists() for d in p.glob("step_*"))))
    if native:
        raise NotImplementedError(
            f"{path}: a native msgpack checkpoint of the JAX package's pretraining; loading "
            "one is not ported yet (ROADMAP.md Queue 1 item 9, pretraining)")


def _torch_load(path):
    _refuse_native(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def load_trunk_checkpoint(path, fallback_cfg: Wav2Vec2Config | None = None
                          ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """A trunk checkpoint -> (config, the port's state_dict) (the JAX
    `load_trunk_variables`, convert.py:260-321): s3prl's ``{"model_weight",
    "model_cfg", "task_cfg"}`` takes its config from the checkpoint
    (`config_from_model_cfg`), a bare state_dict ``fallback_cfg`` (the
    entry's). A conformer encoder raises NotImplementedError."""
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict) and "model_weight" in ckpt:
        sd = ckpt["model_weight"]
        cfg = config_from_model_cfg(ckpt.get("model_cfg", {}), ckpt.get("task_cfg", {}))
    else:
        sd, cfg = ckpt, fallback_cfg or Wav2Vec2Config()
    if cfg.layer_type != "transformer":
        raise NotImplementedError(f"{path}: layer_type {cfg.layer_type!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 8)")
    return cfg, trunk_state_dict_from_torch(sd, cfg)


def load_wavlm_checkpoint(path) -> Tuple[WavLMConfig, Dict[str, torch.Tensor]]:
    """A Microsoft-style WavLM checkpoint ``{"cfg", "model"}`` -> (config,
    the port's state_dict) (convert.py:419-431)."""
    ckpt = _torch_load(path)
    cfg = wavlm_config_from_cfg(ckpt.get("cfg", {}))
    return cfg, wavlm_state_dict_from_torch(ckpt["model"], cfg)


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

    A checkpoint of the JAX package's own pretraining (msgpack) raises
    NotImplementedError (`_refuse_native`). An ``audio_albert`` checkpoint
    listing more than one block raises ValueError: the reference's shared
    encoder lists its one block at every depth (``encoder.layer.0-2``),
    which the JAX loader reads as that many distinct stacked blocks and
    its shared model then cannot apply."""
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


def _lstm_cell(sd, base: str, suffix: str, cell: Dict[str, Any]) -> None:
    """flax OptimizedLSTMCell params -> the weights ``{base}*_l0{suffix}``
    of a torch LSTM: input kernels ``i{gate}`` [in, H] (no bias)
    -> ``weight_ih`` [4H, in]; hidden kernels ``h{gate}`` [H, H] with their
    biases -> ``weight_hh`` [4H, H] and ``bias_hh``; ``bias_ih`` zero."""
    cat = lambda key: np.concatenate([np.asarray(cell[f"{key}{g}"]["kernel"]) for g in _GATES], 1)
    sd[f"{base}weight_ih_l0{suffix}"] = _tensor(cat("i").T)
    sd[f"{base}weight_hh_l0{suffix}"] = _tensor(cat("h").T)
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
    sd[f"{base}bias_ih_l0{suffix}"] = _tensor(np.zeros_like(bias))
    sd[f"{base}bias_hh_l0{suffix}"] = _tensor(bias)


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
