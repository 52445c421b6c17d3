"""Hugging Face wav2vec2 / HuBERT directories -> the port's wav2vec2 trunk
(the ``hf_*`` entries of s3prl_tpu/upstream/registry.py:914-972).

The JAX entries run transformers' ``FlaxWav2Vec2Model``, whose only encoder
is the stable-layer-norm one with the layer-norm feature extractor. That is
fairseq's wav2vec2 with ``extractor_mode="layer_norm"`` and a pre-LN
(``layer_norm_first``) encoder, which the port's `Wav2Vec2Trunk` already
is, so `hf_config` maps a ``config.json`` onto a `Wav2Vec2Config` and
`hf_state_dict_from_torch` HF's keys onto fairseq's; nothing here imports
transformers. A directory is read with `json` and `torch.load(...,
weights_only=True)` (``pytorch_model.bin``) or by safetensors' documented
layout (``model.safetensors``: an 8-byte little-endian header length, a
JSON header, raw little-endian data), with no package.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from ..models.wav2vec2 import Wav2Vec2Config
from .convert import _fold_weight_norm, _t

# transformers' Wav2Vec2Config defaults for the fields the map reads
HF_DEFAULTS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    hidden_act="gelu", conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=False, num_conv_pos_embeddings=128,
    num_conv_pos_embedding_groups=16, feat_extract_norm="group", do_stable_layer_norm=False,
    layer_norm_eps=1e-5, feat_extract_activation="gelu")
# the JAX entries' config without a checkpoint (registry.py:928-931)
HF_DEFAULT_ENTRY = dict(HF_DEFAULTS, do_stable_layer_norm=True, feat_extract_norm="layer")
_ACTIVATIONS = {"gelu": "gelu", "relu": "relu", "swish": "swish", "silu": "swish"}


def hf_config(conf: Dict[str, Any]) -> Wav2Vec2Config:
    """A ``config.json`` dict -> the trunk's config: pre-LN, the layer-norm
    extractor, the HF attention mask's length rule (``feat_pad_rule="hf"``),
    no wave normalisation, no dropout (the JAX entries apply their model
    with ``train=False``). What transformers' Flax model refuses raises
    NotImplementedError (``do_stable_layer_norm`` False, a group-norm
    extractor); what the trunk cannot take raises ValueError (an LN eps
    other than 1e-5, an activation it lacks)."""
    c = {k: conf.get(k, v) for k, v in HF_DEFAULTS.items()}
    if not c["do_stable_layer_norm"]:
        raise NotImplementedError("do_stable_layer_norm=False: transformers' Flax wav2vec2, which "
                                  "the JAX entry runs, supports the stable-layer-norm model only")
    if c["feat_extract_norm"] != "layer":
        raise NotImplementedError(f"feat_extract_norm={c['feat_extract_norm']!r}: transformers' "
                                  "Flax wav2vec2 supports 'layer' only")
    if c["layer_norm_eps"] != 1e-5:
        raise ValueError(f"layer_norm_eps={c['layer_norm_eps']}: the trunk's norms take 1e-5")
    if c["hidden_act"] not in _ACTIVATIONS or c["feat_extract_activation"] != "gelu":
        raise ValueError(f"hidden_act={c['hidden_act']!r}, feat_extract_activation="
                         f"{c['feat_extract_activation']!r}: the trunk takes gelu, relu or swish "
                         "layers over a gelu extractor")
    layers = tuple(zip(c["conv_dim"], c["conv_kernel"], c["conv_stride"]))
    return Wav2Vec2Config(
        extractor_mode="layer_norm", conv_feature_layers=tuple(tuple(x) for x in layers),
        conv_bias=bool(c["conv_bias"]), encoder_layers=c["num_hidden_layers"],
        encoder_embed_dim=c["hidden_size"], encoder_ffn_embed_dim=c["intermediate_size"],
        encoder_attention_heads=c["num_attention_heads"],
        activation_fn=_ACTIVATIONS[c["hidden_act"]], layer_norm_first=True,
        conv_pos=c["num_conv_pos_embeddings"], conv_pos_groups=c["num_conv_pos_embedding_groups"],
        dropout=0.0, attention_dropout=0.0, dropout_input=0.0, feat_pad_rule="hf")


def hf_state_dict_from_torch(sd: Dict[str, Any], cfg: Wav2Vec2Config) -> Dict[str, torch.Tensor]:
    """A transformers Wav2Vec2Model / HubertModel state_dict (bare, or under
    ``wav2vec2.`` / ``hubert.``) -> the trunk's fairseq keys: the extractor's
    ``conv_layers.{i}.{conv,layer_norm}``, ``feature_projection.{layer_norm,
    projection}``, the pos-conv's weight norm (``weight_g`` / ``weight_v``,
    or the parametrization's ``original0`` / ``original1``) folded, the
    layers' ``attention.{q,k,v,out}_proj``, ``layer_norm``,
    ``feed_forward.{intermediate,output}_dense`` and ``final_layer_norm``,
    ``encoder.layer_norm``, ``masked_spec_embed`` (zeros when absent). Other
    keys (heads, adapters, quantizers) are left out."""
    for prefix in ("wav2vec2.", "hubert."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out: Dict[str, torch.Tensor] = {}

    def take(src: str, dst: str, kinds=("weight", "bias")) -> None:
        for kind in kinds:
            out[f"{dst}.{kind}"] = _t(sd[f"{src}.{kind}"])

    for i in range(len(cfg.conv_feature_layers)):
        pre = f"feature_extractor.conv_layers.{i}"
        take(f"{pre}.conv", f"{pre}.0", ("weight", "bias") if cfg.conv_bias else ("weight",))
        take(f"{pre}.layer_norm", f"{pre}.2.1")
    take("feature_projection.layer_norm", "layer_norm")
    take("feature_projection.projection", "post_extract_proj")
    pos = "encoder.pos_conv_embed.conv"
    g, v = ((f"{pos}.weight_g", f"{pos}.weight_v") if f"{pos}.weight_g" in sd else
            (f"{pos}.parametrizations.weight.original0",
             f"{pos}.parametrizations.weight.original1"))
    out["encoder.pos_conv.0.weight"] = _fold_weight_norm(_t(sd[g]), _t(sd[v]))
    out["encoder.pos_conv.0.bias"] = _t(sd[f"{pos}.bias"])
    for i in range(cfg.encoder_layers):
        pre = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            take(f"{pre}.attention.{name}", f"{pre}.self_attn.{name}")
        take(f"{pre}.layer_norm", f"{pre}.self_attn_layer_norm")
        take(f"{pre}.feed_forward.intermediate_dense", f"{pre}.fc1")
        take(f"{pre}.feed_forward.output_dense", f"{pre}.fc2")
        take(f"{pre}.final_layer_norm", f"{pre}.final_layer_norm")
    take("encoder.layer_norm", "encoder.layer_norm")
    out["mask_emb"] = (_t(sd["masked_spec_embed"]) if "masked_spec_embed" in sd
                       else torch.zeros(cfg.encoder_embed_dim))
    return out


# safetensors' dtype names -> torch dtypes
_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file by its documented layout: a u64 header
    length, the JSON header {name: {dtype, shape, data_offsets}}, then the
    tensors' raw little-endian bytes."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        flat = (torch.frombuffer(bytearray(body[begin:end]), dtype=dtype) if end > begin
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def load_hf_directory(path) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """A local Hugging Face model directory -> (config, the trunk's
    state_dict): ``config.json`` and ``model.safetensors`` or
    ``pytorch_model.bin``. A model id or a URL (anything that is not a
    local directory) raises NotImplementedError: the port downloads
    nothing."""
    p = Path(path)
    if not p.is_dir():
        raise NotImplementedError(
            f"{path}: not a local directory; model ids and URLs are not ported (they need "
            "upstream/urls.py and util/download.py, ROADMAP.md Queue 1 item 11): pass ckpt= "
            "a local directory holding config.json and the weights")
    cfg = hf_config(json.loads((p / "config.json").read_text()))
    if (p / "model.safetensors").exists():
        sd = read_safetensors(p / "model.safetensors")
    elif (p / "pytorch_model.bin").exists():
        sd = torch.load(p / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{path}: no model.safetensors or pytorch_model.bin (a Flax-only "
                                "directory is not read: its msgpack weights need flax)")
    return cfg, hf_state_dict_from_torch(sd, cfg)

