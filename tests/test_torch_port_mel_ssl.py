"""The mel-domain SSL upstreams of s3prl_tpu_torch vs s3prl_tpu (CPU):
mockingjay, tera, audio_albert (MockingjayEncoder), apc, vq_apc (GRUs) and
npc (masked convs) through both registries at a tiny width, their
checkpoints in the reference's layouts, and the models' options.

Both registries build their entries' configs inside the entry, so the
tests patch each package's config class with a subclass of tiny defaults
(Mockingjay hidden 64, 2 layers, 4 heads, FFN 128; APC 3 x 32; NPC 2 blocks
x 32). The port's random weights, every tensor perturbed, go through the
JAX package's converters (`mockingjay_params_from_torch`,
`apc_params_from_torch`, `npc_variables_from_torch`) into its upstream, and
back through the port's `*_state_dict_from_jax` (which the JAX converter
maps to the same tree, bit for bit). Tolerances: every layer's hidden
states at atol 5e-4 in f32, on a padded batch with a 321-sample row (2
log-mel frames; no fbank frame: attention over no valid key); bf16 layer
cosines > 0.999 over the valid frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.apc as jax_apc
import s3prl_tpu.models.mockingjay as jax_mockingjay
import s3prl_tpu.models.npc as jax_npc
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream import convert as jax_convert
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.apc import APCConfig, APCModel
from s3prl_tpu_torch.models.mockingjay import MockingjayConfig, MockingjayEncoder
from s3prl_tpu_torch.models.npc import NPCConfig, NPCModel
from s3prl_tpu_torch.nn import init_params
from s3prl_tpu_torch.upstream.convert import (apc_state_dict_from_jax,
                                              mockingjay_state_dict_from_jax,
                                              npc_state_dict_from_jax)

TINY = {"MockingjayConfig": dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=128),
        "APCConfig": dict(hidden_size=32, num_layers=3),
        "NPCConfig": dict(hidden_size=32, n_blocks=2)}
# entry -> (family, hidden states, front-end width)
ENTRIES = {"mockingjay": ("mockingjay", 3, 240), "tera": ("mockingjay", 3, 80),
           "audio_albert": ("mockingjay", 3, 80), "apc": ("apc", 3, 80),
           "vq_apc": ("apc", 3, 80), "npc": ("npc", 5, 80)}
LENS = np.asarray([16000, 4000, 321], np.int32)


def with_defaults(cls, **fields):
    """The config class `cls` with other defaults: a frozen subclass (which
    an entry that builds its config inside builds instead)."""
    fields = [(k, type(v), dataclasses.field(default=v)) for k, v in fields.items()]
    return dataclasses.make_dataclass(cls.__name__, fields, bases=(cls,), frozen=True)


def tiny(cls):
    return with_defaults(cls, **TINY[cls.__name__])


@pytest.fixture
def tiny_entries(monkeypatch):
    """Both registries' entries at the tiny width; the JAX configs."""
    jax_cfgs = {}
    for module in (jax_mockingjay, jax_apc, jax_npc):
        for name in TINY:
            if hasattr(module, name):
                jax_cfgs[name] = tiny(getattr(module, name))
                monkeypatch.setattr(module, name, jax_cfgs[name])
    for name in TINY:
        monkeypatch.setattr(port_registry, name, tiny(getattr(port_registry, name)))
    return jax_cfgs


def perturb(sd, seed=0):
    """Every float tensor + 0.05 N(0, 1); BatchNorm variances kept positive."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            v = v + torch.from_numpy(0.05 * rng.randn(*v.shape).astype(np.float32))
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        out[k] = v
    return out


def waves(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(LENS), LENS.max()).astype(np.float32) * 0.1
    return x * (np.arange(LENS.max())[None] < LENS[:, None])


def jax_variables(name, sd, jax_cfgs):
    """The JAX package's variables of the port's state_dict (its converters)."""
    family = ENTRIES[name][0]
    if family == "mockingjay":
        return {"params": jax_convert.mockingjay_params_from_torch(
            sd, 2, share_layer=name == "audio_albert")}
    if family == "apc":
        return {"params": jax_convert.apc_params_from_torch(sd, 3)}
    return jax_convert.npc_variables_from_torch(sd, jax_cfgs["NPCConfig"]())


def from_jax(name, variables):
    family = ENTRIES[name][0]
    if family == "mockingjay":
        return mockingjay_state_dict_from_jax(variables)
    if family == "apc":
        return apc_state_dict_from_jax(variables)
    return npc_state_dict_from_jax(variables)


def same_trees(a, b):
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_matches_jax(tiny_entries, name):
    """The entry's standardized states on the same weights; the converters
    there and back; the state_dict from JAX gives the same states."""
    up = hub.load(name, device="cpu")
    model = up.model.model
    sd = perturb(model.state_dict())
    model.load_state_dict(sd)
    jup = jax_hub.load(name)
    jup.params = jax_variables(name, sd, tiny_entries)
    x = waves()
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    assert tuple(got.shape) == np.shape(want) and got.shape[0] == up.num_layers
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    # back through the port's converter: the JAX converter maps it to the
    # same tree; the port's model on it gives the same states
    back = from_jax(name, jup.params)
    same_trees(jax_variables(name, back, tiny_entries), jup.params)
    model.load_state_dict(back)
    again, _ = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6, rtol=0)


def test_entry_widths_and_layers(tiny_entries):
    """hub.options() holds the six names; each entry's layers, width and
    stride; Mockingjay reads 240 fbank + delta dims, the others 80 mel."""
    assert {"mockingjay", "tera", "audio_albert", "apc", "vq_apc", "npc"} <= set(hub.options())
    for name, (family, states, width) in ENTRIES.items():
        up = hub.load(name, device="cpu")
        assert up.downsample_rate == 160
        cfg = up.model.cfg
        if family == "mockingjay":
            assert up.num_layers == states and cfg.input_dim == width and up.hidden_size == 64
            layers = up.model.model.encoder.layer
            assert len(layers) == (1 if name == "audio_albert" else 2)
        else:
            assert up.num_layers == states and up.hidden_size == 32
    assert hub.load("vq_apc", device="cpu").model.model.vq_layers is not None


def test_bf16_tera_matches_jax(tiny_entries):
    """dtype=bf16: every layer's cosine > 0.999 over the valid frames."""
    up = hub.load("tera", dtype=torch.bfloat16, device="cpu")
    model = up.model.model
    sd = perturb(model.state_dict())
    model.load_state_dict(sd)
    jup = jax_hub.load("tera", dtype=jnp.bfloat16)
    jup.params = jax_variables("tera", sd, tiny_entries)
    x = waves(1)
    want, lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, _ = up(torch.from_numpy(x), torch.from_numpy(LENS))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    valid = np.arange(got.shape[2])[None] < np.asarray(lens)[:, None]
    for layer in range(got.shape[0]):
        a, b = got[layer][valid].ravel(), want[layer][valid].ravel()
        assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) > 0.999, layer


# -- the models on the same features, with their options ------------------------------

MODEL_CASES = {
    "mockingjay pre-LN relu, frames stacked by 2": (
        "mockingjay", dict(pre_layer_norm=True, hidden_act="relu", downsample_rate=2)),
    "mockingjay shared, swish": ("mockingjay", dict(share_layer=True, hidden_act="swish")),
    "apc no residual, VQ 2 groups": (
        "apc", dict(residual=False, vq_codebook_size=(16, 8), vq_code_dim=(20, 12))),
    "npc tanh, no BatchNorm, last block masked only": (
        "npc", dict(activate="tanh", batch_norm=False, disable_cross_layer=True)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_options_match_flax(case):
    family, fields = MODEL_CASES[case]
    rng = np.random.RandomState(3)
    feats = rng.randn(3, 37, 80).astype(np.float32)
    lens = np.asarray([37, 20, 1], np.int32)
    if family == "mockingjay":
        kw = dict(TINY["MockingjayConfig"], input_dim=80)
        cfg = MockingjayConfig(**kw, **fields)
        port = MockingjayEncoder(cfg)
        jax_model = jax_mockingjay.MockingjayEncoder(jax_mockingjay.MockingjayConfig(**kw, **fields))
        convert = lambda sd: {"params": jax_convert.mockingjay_params_from_torch(  # noqa: E731
            sd, 2, fields.get("share_layer", False))}
        apply = lambda v: jax_model.apply(v, feats, lens)  # noqa: E731
    elif family == "apc":
        cfg = APCConfig(input_size=80, hidden_size=32, num_layers=2, **fields)
        port = APCModel(cfg)
        jax_model = jax_apc.APCModel(jax_apc.APCConfig(input_size=80, hidden_size=32,
                                                       num_layers=2, **fields))
        convert = lambda sd: {"params": jax_convert.apc_params_from_torch(sd, 2)}  # noqa: E731
        apply = lambda v: jax_model.apply(v, feats, lens)  # noqa: E731
    else:
        cfg = NPCConfig(input_size=80, hidden_size=32, n_blocks=3, **fields)
        port = NPCModel(cfg)
        jax_cfg = jax_npc.NPCConfig(input_size=80, hidden_size=32, n_blocks=3, **fields)
        jax_model = jax_npc.NPCModel(jax_cfg)
        convert = lambda sd: jax_convert.npc_variables_from_torch(sd, jax_cfg)  # noqa: E731
        apply = lambda v: jax_model.apply(v, feats, lens)  # noqa: E731
    init_params(port, torch.Generator().manual_seed(1))
    sd = perturb(port.state_dict(), 2)
    port.load_state_dict(sd)
    port.eval()
    variables = convert(sd)
    want = apply(variables)
    got = port(torch.from_numpy(feats), torch.from_numpy(lens))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=5e-4, rtol=0)
    back = {"mockingjay": mockingjay_state_dict_from_jax, "apc": apc_state_dict_from_jax,
            "npc": npc_state_dict_from_jax}[family](variables)
    same_trees(convert(back), variables)


# -- checkpoints in the reference's layouts ----------------------------------------

def _reference_sd(name, **fields):
    """The port's tiny model of entry `name` (perturbed), its state_dict in
    the reference's keys; `fields` change its config."""
    family = ENTRIES[name][0]
    if family == "mockingjay":
        cfg = MockingjayConfig(**dict(TINY["MockingjayConfig"], input_dim=ENTRIES[name][2],
                                      share_layer=name == "audio_albert", **fields))
        model = MockingjayEncoder(cfg)
    elif family == "apc":
        vq = dict(vq_codebook_size=(512,), vq_code_dim=(512,)) if name == "vq_apc" else {}
        model = APCModel(APCConfig(**TINY["APCConfig"], **vq))
    else:
        model = NPCModel(NPCConfig(**TINY["NPCConfig"]))
    return perturb(model.state_dict(), 4)


def _layout(name, sd):
    """(entry, checkpoint) of each layout the JAX loader reads."""
    prefixed = {f"transformer.{k}": v for k, v in sd.items()}
    paras = {"n_blocks": 2, "hidden_size": 32, "batch_norm": True}
    return {
        "mockingjay {Transformer, SpecHead}": {"Transformer": sd, "SpecHead": {}},
        "tera {SelfSupervisedLearning} with transformer.": {"SelfSupervisedLearning": prefixed},
        "mockingjay bare transformer. at 80 dims (log-mel)": prefixed,
        "audio_albert {model} one block": {"model": sd},
        "apc {config, model}": {"config": {"model": {"paras": {}}}, "model": sd},
        "vq_apc bare": sd,
        "npc {config, model}": {"config": {"model": {"paras": paras}}, "model": sd},
    }[name]


CKPTS = {"mockingjay {Transformer, SpecHead}": "mockingjay",
         "tera {SelfSupervisedLearning} with transformer.": "tera",
         "mockingjay bare transformer. at 80 dims (log-mel)": "mockingjay",
         "audio_albert {model} one block": "audio_albert",
         "apc {config, model}": "apc", "vq_apc bare": "vq_apc",
         "npc {config, model}": "npc"}


@pytest.mark.parametrize("layout", list(CKPTS))
def test_checkpoint_loads_the_same_model_in_both(tiny_entries, tmp_path, layout):
    """`ckpt=` through both registries: the same hidden states (the JAX
    variables through the port's converter hold the port's loaded
    weights); Mockingjay's front end from its spec_transform width."""
    entry = CKPTS[layout]
    source = "tera" if "80 dims" in layout else entry
    path = tmp_path / "model.ckpt"
    torch.save(_layout(layout, _reference_sd(source)), path)
    up = hub.load(entry, ckpt=str(path), device="cpu")
    jup = jax_hub.load(entry, ckpt=str(path))
    if ENTRIES[entry][0] == "mockingjay":
        assert up.model.feat_kind == ("mel" if ENTRIES[source][2] == 80 else "fbank_delta")
    x = waves(2)
    want, _ = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, _ = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    mine = up.model.model.state_dict()
    theirs = from_jax(entry, jup.params)
    assert mine.keys() == theirs.keys()
    if ENTRIES[entry][0] != "apc":  # APC: the JAX cells hold b_hr + b_ir folded
        for k in mine:
            assert torch.equal(mine[k], theirs[k]), k


def test_audio_albert_checkpoint_with_every_depth_listed(tiny_entries, tmp_path):
    """The reference's shared encoder lists its one block at each depth
    (encoder.layer.0-2, the same tensors): the JAX loader stacks them as
    distinct blocks and its shared model fails at apply; the port refuses
    at load, naming both readings."""
    sd = _reference_sd("audio_albert")
    shared = {k: v for k, v in sd.items() if not k.startswith("encoder.layer.")}
    for i in range(3):
        shared.update({k.replace("layer.0.", f"layer.{i}."): v for k, v in sd.items()
                       if k.startswith("encoder.layer.0.")})
    path = tmp_path / "albert.ckpt"
    torch.save({"Transformer": shared}, path)
    jup = jax_hub.load("audio_albert", ckpt=str(path))
    with pytest.raises(Exception, match="expected to generate shape"):
        jup(jnp.zeros((1, 1600)), jnp.asarray([1600]))
    with pytest.raises(ValueError, match="encoder.layer.0-2.*two ways.*distinct"):
        hub.load("audio_albert", ckpt=str(path), device="cpu")


@pytest.mark.parametrize("name", list(ENTRIES))
def test_native_and_refused_keywords(tiny_entries, tmp_path, name, monkeypatch):
    """A native msgpack checkpoint (the JAX pretraining task's tree around
    the entry's model) loads; APC and NPC in bf16 raise (their models run
    in f32); train mode runs with its dropouts, with states that need no
    grad, except where the JAX train mode raises (VQ-APC's "gumbel" stream,
    NPC's BatchNorm); without CUDA and without device= the entry raises."""
    from flax import serialization

    sd = perturb(hub.load(name, device="cpu").model.model.state_dict())
    variables = jax_variables(name, sd, tiny_entries)
    family = ENTRIES[name][0]
    tree = ({"params": {"npc": variables["params"]}, "batch_stats": {
        "npc": variables["batch_stats"]}} if family == "npc"
        else {"encoder" if family == "mockingjay" else "apc": variables["params"]})
    native = tmp_path / "params.msgpack"
    native.write_bytes(serialization.to_bytes(tree))
    loaded = hub.load(name, ckpt=str(native), device="cpu").model.model.state_dict()
    assert loaded.keys() == sd.keys()
    for k in sd:  # APC: the JAX cells hold b_hr + b_ir folded into bias_ih
        if family != "apc" or "bias" not in k:
            assert torch.equal(loaded[k], sd[k]), k
    if ENTRIES[name][0] != "mockingjay":
        with pytest.raises(ValueError, match="cannot take effect"):
            hub.load(name, dtype=torch.bfloat16, device="cpu")
    up = hub.load(name, device="cpu")
    if name in ("vq_apc", "npc"):
        with pytest.raises(NotImplementedError, match='"gumbel"|"batch_stats"'):
            up(torch.zeros(1, 1600), torch.tensor([1600]), train=True)
    else:
        hs, _ = up(torch.zeros(1, 1600), torch.tensor([1600]), train=True,
                   generator=torch.Generator().manual_seed(0))
        assert up.model.training and not hs.requires_grad
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hub.load(name)
