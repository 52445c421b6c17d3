"""The AST family (AST / SSAST / MAE-AST) and PaSST of s3prl_tpu_torch vs
s3prl_tpu (CPU).

Each JAX entry's random params, every leaf moved by 0.05 N(0, 1) (so the
norms' scales and biases are not 1 and 0), go to the port through
`ast_state_dict_from_jax` / `passt_state_dict_from_jax`, and both
registries run the same padded batch. The configurations are cut in both
packages to 64 wide (AST) or 32 wide (PaSST), two blocks of two heads (one
for PaSST), the front ends and the patch grids as published (128-bin
fbank, 100-frame windows; PaSST's 32-kHz mel at each variant's hop). The
batches hold a row shorter than one window: AST's last window is
zero-padded, PaSST's reflect padding repeats its reflection. Tolerances:
the hidden states at atol 5e-4 in f32 (tests/test_torch_parity.py:142),
bf16 at cosine 0.999; lengths equal, by the entries' own rules. The
checkpoint round trips write timm / hear21passt state_dicts from random
weights into tmp_path and load them through both hubs.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.ast as jax_ast
import s3prl_tpu.models.passt as jax_passt
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream.base import standardize_hidden_states
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models import passt as port_passt
from s3prl_tpu_torch.upstream.convert_zoo import ast_state_dict_from_jax, passt_state_dict_from_jax

AST_CUT = dict(embed_dim=64, depth=2, num_heads=2)
PASST_CUT = dict(embed_dim=32, depth=1, num_heads=2, n_classes=16)
AST_LENS = np.asarray([24000, 16000, 4801], np.int32)  # 2 windows, 1, a padded one
PASST_LENS = np.asarray([8000, 4801], np.int32)
PASST_NAMES = sorted(port_registry.PASST_ENTRIES)


def waves(lens, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), int(lens.max())).astype(np.float32) * 0.3
    return x * (np.arange(lens.max())[None] < lens[:, None])


def perturbed(tree, seed=0):
    """Every leaf + 0.05 N(0, 1), in f32 numpy."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + np.asarray(0.05 * rng.randn(*np.shape(x)),
                                                         np.float32), tree)


def run_both(jup, up, x, lens, train=False):
    """(port states, JAX states) of the standardized forward, their lengths
    equal, and the models' own lengths (before the upstream's rule) equal.
    The JAX model runs once, jitted, and is standardized as its
    apply_standardized does (the batches are longer than its 0.05-s pad)."""
    assert x.shape[1] >= 800
    hs, raw = jax.jit(jup.apply_fn, static_argnums=3)(jup.params, jnp.asarray(x),
                                                      jnp.asarray(lens), train, None)
    want, want_lens = standardize_hidden_states(hs, jnp.asarray(lens), x.shape[1],
                                                jup.downsample_rate)
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(lens), train=train)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape
    if not train:
        _, got_raw = up.model(torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_array_equal(got_raw.numpy(), np.asarray(raw))
    return got.float().numpy(), np.asarray(want, np.float32)


def cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture
def tiny_ast(monkeypatch):
    for name in ("SSAST_PATCH", "SSAST_FRAME"):
        for module in (jax_ast, port_registry):
            monkeypatch.setattr(module, name,
                                dataclasses.replace(getattr(module, name), **AST_CUT))


@pytest.fixture
def tiny_passt(monkeypatch):
    for name, cfg in port_registry.PASST_ENTRIES.items():
        monkeypatch.setitem(port_registry.PASST_ENTRIES, name,
                            dataclasses.replace(cfg, **PASST_CUT))
    for name in dir(jax_passt):
        if name.startswith("PASST_"):
            monkeypatch.setattr(jax_passt, name,
                                dataclasses.replace(getattr(jax_passt, name), **PASST_CUT))


def ast_pair(name, dtype=torch.float32, seed=0):
    jup = jax_hub.load(name, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jup = copy.copy(jup)
    jup.params = perturbed(jup.params, seed)
    up = hub.load(name, dtype=dtype, device="cpu")
    up.model.load_state_dict(ast_state_dict_from_jax(jup.params, up.model.cfg))
    return jup, up


@pytest.mark.parametrize("name", ["ast", "ssast_frame_base"])
def test_ast_entry_matches_jax(tiny_ast, name):
    """The patch and the frame models: every layer's states in f32 at
    5e-4, the lengths (raw and standardized, `run_both`) and the metadata; train mode
    computes the same (no dropout in either)."""
    jup, up = ast_pair(name)
    x = waves(AST_LENS)
    got, want = run_both(jup, up, x, AST_LENS)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    train, _ = up(torch.from_numpy(x), torch.from_numpy(AST_LENS), train=True)
    np.testing.assert_array_equal(train.numpy(), got)


def test_ast_bf16_matches_jax(tiny_ast):
    """bf16 weights and activations in both: per-layer cosine > 0.999."""
    jup, up = ast_pair("ast", torch.bfloat16)
    got, want = run_both(jup, up, waves(AST_LENS), AST_LENS)
    assert min(cosine(g, w) for g, w in zip(got, want)) > 0.999


@pytest.mark.parametrize("name,family", [("mae_ast", "ssast_frame_base"),
                                         ("mae_ast_frame", "ssast_frame_base"),
                                         ("mae_ast_patch", "ast"),
                                         ("ssast_patch_base", "ast")])
def test_ast_aliases(name, family):
    """Each MAE-AST / SSAST name is its family's factory, as in JAX."""
    assert port_registry._REGISTRY[name] is port_registry._REGISTRY[family]
    assert jax_registry._REGISTRY[name] is jax_registry._REGISTRY[family]


def _timm_checkpoint(cfg, rng, frame_kernel_transposed=False):
    """A timm-layout AST state_dict of random weights, under ``model`` with
    the reference's DataParallel ``module.v.`` prefix."""
    D, F = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    kh, kw = (cfg.fshape, cfg.tshape) if frame_kernel_transposed else (cfg.tshape, cfg.fshape)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)

    sd = {"patch_embed.proj.weight": t(D, 1, kh, kw), "patch_embed.proj.bias": t(D),
          "cls_token": t(1, 1, D), "pos_embed": t(1, cfg.t_patches * cfg.f_patches + 1, D),
          "norm.weight": 1 + t(D), "norm.bias": t(D)}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + t(D), f"{p}.norm1.bias": t(D),
                   f"{p}.attn.qkv.weight": t(3 * D, D), f"{p}.attn.qkv.bias": t(3 * D),
                   f"{p}.attn.proj.weight": t(D, D), f"{p}.attn.proj.bias": t(D),
                   f"{p}.norm2.weight": 1 + t(D), f"{p}.norm2.bias": t(D),
                   f"{p}.mlp.fc1.weight": t(F, D), f"{p}.mlp.fc1.bias": t(F),
                   f"{p}.mlp.fc2.weight": t(D, F), f"{p}.mlp.fc2.bias": t(D)})
    return {"model": {f"module.v.{k}": v for k, v in sd.items()}}


@pytest.mark.parametrize("name", ["ast", "mae_ast"])
def test_ast_checkpoint_round_trip(tiny_ast, tmp_path, name):
    """A timm checkpoint (nested under ``model``, ``module.v.`` keys) loads
    through both hubs (``mae_ast`` through ``mae_ast_local``) to the same
    states: a transposed patch kernel would move them."""
    cfg = port_registry.SSAST_PATCH if name == "ast" else port_registry.SSAST_FRAME
    path = str(tmp_path / "ast.pth")
    torch.save(_timm_checkpoint(cfg, np.random.RandomState(1)), path)
    entry = "mae_ast_local" if name == "mae_ast" else name
    jup = jax_hub.load(entry, ckpt=path)
    up = hub.load(entry, ckpt=path, device="cpu")
    got, want = run_both(jup, up, waves(AST_LENS[:2]), AST_LENS[:2])
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_ast_frame_checkpoint_in_the_reference_orientation_raises(tiny_ast, tmp_path):
    """A frame checkpoint whose patch kernel is [D, 1, fshape, tshape] (the
    reference's [F, T] input): the JAX loader reads it and its model fails
    at apply; the port raises at load."""
    path = str(tmp_path / "frame.pth")
    torch.save(_timm_checkpoint(port_registry.SSAST_FRAME, np.random.RandomState(2),
                                frame_kernel_transposed=True), path)
    jup = jax_hub.load("mae_ast", ckpt=path)
    with pytest.raises(Exception):
        jup(jnp.asarray(waves(AST_LENS[:1])), jnp.asarray(AST_LENS[:1]))
    with pytest.raises(ValueError, match="fails at apply"):
        hub.load("mae_ast", ckpt=path, device="cpu")


def test_resample_and_mel_match_jax():
    """The 16 -> 32 kHz polyphase resampler (its kernel equal) and the
    AugmentMelSTFT eval path against JAX's on a padded batch, at each
    variant's hop."""
    x = waves(np.asarray([8000, 3001], np.int32))
    np.testing.assert_array_equal(port_passt.resample_kernel(16000, 32000),
                                  jax_passt.resample_kernel(16000, 32000))
    want32 = np.asarray(jax_passt.resample(jnp.asarray(x)))
    got32 = port_passt.resample(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got32, want32, atol=1e-5, rtol=0)
    for hop in (320, 160, 100):
        cfg = dataclasses.replace(port_passt.PASST_BASE, mel_hop=hop)
        jcfg = dataclasses.replace(jax_passt.PASST_BASE, mel_hop=hop)
        want = np.asarray(jax_passt.passt_mel(jnp.asarray(want32[:, :5120]), jcfg))
        got = port_passt.passt_mel(torch.from_numpy(want32[:, :5120]), cfg).numpy()
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def passt_pair(name, seed=0):
    jup = copy.copy(jax_hub.load(name))
    jup.params = perturbed(jup.params, seed)
    up = hub.load(name, device="cpu")
    up.model.load_state_dict(passt_state_dict_from_jax(jup.params, up.model.cfg))
    return jup, up


@pytest.mark.parametrize("name", PASST_NAMES)
def test_passt_entry_matches_jax(tiny_passt, name):
    """Every PaSST configuration on a short clip: [logits; cls] per 50-ms
    window (two-level and raw-mel parts included) at 5e-4, the window
    counts and lengths, the metadata."""
    jup, up = passt_pair(name)
    got, want = run_both(jup, up, waves(PASST_LENS), PASST_LENS)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_passt_alias_and_configs():
    """``passt`` is ``passt_base``; every configuration field for field
    against the JAX package's."""
    assert port_registry._REGISTRY["passt"] is port_registry._REGISTRY["passt_base"]
    for name, cfg in port_registry.PASST_ENTRIES.items():
        jcfg = getattr(jax_passt, {"passt_base": "PASST_BASE", "passt_base2level": "PASST_2LVL",
                                   "passt_base20sec": "PASST_20SEC",
                                   "passt_base30sec": "PASST_30SEC",
                                   "passt_hop100base": "PASST_HOP100",
                                   "passt_hop160base": "PASST_HOP160",
                                   "passt_base2levelmel": "PASST_2LVL_MEL",
                                   "passt_hop100base2lvl": "PASST_HOP100_2LVL",
                                   "passt_hop100base2lvlmel": "PASST_HOP100_2LVL_MEL",
                                   "passt_hop160base2lvl": "PASST_HOP160_2LVL",
                                   "passt_hop160base2lvlmel": "PASST_HOP160_2LVL_MEL"}[name])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.embedding_size == jcfg.embedding_size


def _passt_checkpoint(cfg, rng):
    """A hear21passt wrapper state_dict (``net.*``, the decomposed position
    tables in their [1, E, F, 1] / [1, E, 1, T] shapes) of random weights."""
    E, F = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)

    sd = {"patch_embed.proj.weight": t(E, 1, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": t(E), "cls_token": t(1, 1, E), "new_pos_embed": t(1, 1, E),
          "freq_new_pos_embed": t(1, E, cfg.f_grid, 1),
          "time_new_pos_embed": t(1, E, 1, cfg.t_grid),
          "norm.weight": 1 + t(E), "norm.bias": t(E), "head.0.weight": 1 + t(E),
          "head.0.bias": t(E), "head.1.weight": t(cfg.n_classes, E),
          "head.1.bias": t(cfg.n_classes)}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + t(E), f"{p}.norm1.bias": t(E),
                   f"{p}.attn.qkv.weight": t(3 * E, E), f"{p}.attn.qkv.bias": t(3 * E),
                   f"{p}.attn.proj.weight": t(E, E), f"{p}.attn.proj.bias": t(E),
                   f"{p}.norm2.weight": 1 + t(E), f"{p}.norm2.bias": t(E),
                   f"{p}.mlp.fc1.weight": t(F, E), f"{p}.mlp.fc1.bias": t(F),
                   f"{p}.mlp.fc2.weight": t(E, F), f"{p}.mlp.fc2.bias": t(E)})
    return {"state_dict": {**{f"net.{k}": v for k, v in sd.items()},
                           "mel.preemphasis_coefficient": torch.tensor([[[-0.97, 1.0]]])}}


def test_passt_checkpoint_round_trip(tiny_passt, tmp_path):
    """A hear21passt checkpoint under ``state_dict`` loads through both hubs
    to the same embeddings: a transposed position table would move them."""
    name = "passt_base2levelmel"
    path = str(tmp_path / "passt.pt")
    torch.save(_passt_checkpoint(port_registry.PASST_ENTRIES[name], np.random.RandomState(3)),
               path)
    jup = jax_hub.load(name, ckpt=path)
    up = hub.load(name, ckpt=path, device="cpu")
    got, want = run_both(jup, up, waves(PASST_LENS), PASST_LENS)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_patch_transformers_refusals(monkeypatch):
    """The keywords the JAX entries take and ignore raise; a dtype neither
    f32 nor bf16 raises; without CUDA and without device= they raise."""
    with pytest.raises(ValueError, match="flash cannot take effect on ssast_patch"):
        hub.load("ast", flash=True, device="cpu")
    with pytest.raises(ValueError, match="quantize cannot take effect on passt_base"):
        hub.load("passt_base", quantize=True, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        hub.load("ssast_frame_base", dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("passt_hop100base", remat=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("ast", "mae_ast", "passt", "passt_hop160base2lvlmel"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            hub.load(name)
