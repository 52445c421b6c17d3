"""JAX trunk parameters -> the port's state_dict.

`trunk_state_dict_from_jax(params, cfg)` takes the param tree of
s3prl_tpu.models.wav2vec2.Wav2Vec2Trunk (numpy or jax arrays; a variables
dict with a "params" entry also works) and returns the fairseq-keyed
state_dict that s3prl_tpu_torch's `Wav2Vec2Trunk.load_state_dict` reads and
that s3prl_tpu/upstream/convert.py `trunk_params_from_torch` maps back to
the same tree, bit for bit:

- conv kernels [k, in, out] -> Conv1d weights [out, in, k];
- Dense kernels [in, out] -> Linear weights [out, in];
- the fused qkv kernel [C, 3C] -> q/k/v_proj weights [C, C] each;
- the stacked encoder layers (leading L axis) -> encoder.layers.{i}.*;
- LayerNorm scale/bias -> weight/bias.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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


def trunk_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX Wav2Vec2Trunk params -> the port's (fairseq-keyed) state_dict."""
    p = params.get("params", params)
    if cfg.extractor_mode != "layer_norm" or cfg.conv_bias:
        raise NotImplementedError(
            "only the bias-free layer-norm extractor is ported "
            "(ROADMAP.md Queue 1 item 3)")
    sd: Dict[str, torch.Tensor] = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.0.weight"] = _conv(fe[f"conv_{i}"]["kernel"])
        _norm(sd, f"{pre}.2.1", fe[f"ln_{i}"])
    _norm(sd, "layer_norm", p["layer_norm"])
    if "post_extract_proj" in p:
        _linear(sd, "post_extract_proj", p["post_extract_proj"])
    sd["mask_emb"] = _tensor(p["mask_emb"])

    enc = p["encoder"]
    pos = enc["pos_conv"]["conv"]
    sd["encoder.pos_conv.0.weight"] = _conv(pos["kernel"])
    sd["encoder.pos_conv.0.bias"] = _tensor(pos["bias"])
    _norm(sd, "encoder.layer_norm", enc["layer_norm"])
    layers = enc["layers"]
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
    return sd
