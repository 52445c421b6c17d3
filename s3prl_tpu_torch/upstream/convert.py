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
    QbeEmbedder) has one unidirectional cell a layer."""
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
