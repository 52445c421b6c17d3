"""The port's hub name surface vs s3prl_tpu's (CPU): all 209 names of the
JAX hub (none left to port, pinned), `options(only_registered_ckpt)`,
the generic ``*_local`` / ``*_url`` / ``*_custom`` loaders and the named
checkpoint variants against the JAX aliases, ``baseline_local``'s yaml
loader, and the small front ends ``wav``, ``log_stft`` and ``example``
against JAX on `test_torch_port_audio`'s padded batch (the log features by
its quantile rule on the rows with frames).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.upstream.aliases import _GENERIC_LOADERS, _NAMED_VARIANTS
from test_torch_port_audio import DEGENERATE, LENS, _batch, quantile_rule

# the JAX hub's names the port has not yet: none since ROADMAP.md Queue 1
# item 8 closed
NOT_YET = []


def test_names():
    """209 names, exactly the JAX hub's (none still to port); every name an
    attribute of the hub."""
    names = hub.options()
    assert len(names) == 209 == len(set(names))
    assert names == jax_hub.options()
    assert sorted(set(jax_hub.options()) - set(names)) == NOT_YET == []
    assert all(name in dir(hub) for name in names)


def test_only_registered_ckpt_agrees_with_jax():
    """The filter drops the generic loaders in both: on the shared names the
    two lists are equal."""
    pinned = hub.options(only_registered_ckpt=True)
    assert set(pinned) == set(jax_hub.options(only_registered_ckpt=True)) & set(hub.options())
    assert not any(n.endswith(("_local", "_url", "_gdriveid", "_custom")) for n in pinned)
    assert len(pinned) < len(hub.options())


def generic_loaders():
    return [f"{family}_{kind}" for family, kinds in _GENERIC_LOADERS.items() for kind in kinds]


@pytest.mark.parametrize("name", generic_loaders())
def test_generic_loader(monkeypatch, name, tmp_path):
    """Each loader hands a local ckpt and its keywords to its family's
    factory, as the JAX one does; without ckpt both raise the same
    ValueError; a URL raises (the port downloads nothing)."""
    family = name.rsplit("_", 1)[0]
    calls = {}
    for package, registry in (("jax", jax_registry), ("port", port_registry)):
        monkeypatch.setitem(registry._REGISTRY, family,
                            lambda package=package, **kw: calls.setdefault(package, kw))
    path = str(tmp_path / "model.ckpt")
    jax_hub.load(name, ckpt=path, seed=3)
    hub.load(name, ckpt=path, seed=3)
    assert calls["jax"] == calls["port"] == {"ckpt": path, "seed": 3}
    with pytest.raises(ValueError) as jax_error:
        jax_hub.load(name)
    with pytest.raises(ValueError) as port_error:
        hub.load(name)
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        hub.load(name, ckpt="https://example.invalid/model.ckpt")


def test_generic_loaders_cover_the_ported_families():
    """Every generic loader of the JAX hub whose family the port has."""
    jax_loaders = {n for n in jax_hub.options() if n.endswith(("_local", "_url", "_custom"))}
    port_loaders = {n for n in hub.options() if n.endswith(("_local", "_url", "_custom"))}
    assert port_loaders == jax_loaders - set(NOT_YET)
    assert set(generic_loaders()) <= port_loaders


@pytest.mark.parametrize("alias", list(_NAMED_VARIANTS) + ["apc_360hr", "apc_960hr",
                                                           "vq_apc_360hr", "vq_apc_960hr",
                                                           "npc_360hr", "npc_960hr"])
def test_named_variants(alias):
    """Each named checkpoint variant is its family's factory, as in JAX."""
    family = _NAMED_VARIANTS.get(alias, alias.rsplit("_", 1)[0])
    assert port_registry._REGISTRY[alias] is port_registry._REGISTRY[family]
    assert jax_registry._REGISTRY[alias] is jax_registry._REGISTRY[family]


@pytest.mark.parametrize("conf", [None, "name: mfcc\nkwargs:\n  num_ceps: 20\n",
                                  "kwargs:\n  delta_order: 0\n", "name: not_a_front_end\n"])
def test_baseline_local_reads_its_yaml(tmp_path, conf):
    """baseline_local(model_config=yaml): the yaml's ``name`` (fbank when
    absent or unknown) with its ``kwargs``, the same features as JAX's."""
    kw = {}
    if conf is not None:
        (tmp_path / "conf.yaml").write_text(conf)
        kw["model_config"] = str(tmp_path / "conf.yaml")
    jup = jax_hub.load("baseline_local", **kw)
    up = hub.load("baseline_local", device="cpu", **kw)
    wavs = _batch()
    want, want_lens = jup(jnp.asarray(wavs), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(wavs), torch.from_numpy(LENS))
    assert got.shape == want.shape and up.downsample_rate == jup.downsample_rate
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    quantile_rule(got.numpy()[0][~DEGENERATE], np.asarray(want)[0][~DEGENERATE], conf)


@pytest.mark.parametrize("name", ["wav", "log_stft", "stft_mag", "example",
                                  "customized_upstream"])
def test_small_front_ends_match_jax(name):
    """wav (the waves themselves), log_stft / stft_mag and example /
    customized_upstream (JAX's Dense carried across) through both hubs, the
    metadata, and train mode computing the same."""
    jup = jax_hub.load(name)
    up = hub.load(name, device="cpu")
    if name in ("example", "customized_upstream"):
        dense = jup.params["linear"]
        up.model.load_state_dict({"linear.weight": torch.from_numpy(np.array(dense["kernel"]).T),
                                  "linear.bias": torch.from_numpy(np.array(dense["bias"]))})
    wavs = _batch()
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(wavs), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(wavs), torch.from_numpy(LENS))
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert torch.equal(up(torch.from_numpy(wavs), torch.from_numpy(LENS), train=True)[0], got)
    if name == "wav":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        quantile_rule(got.numpy()[0][~DEGENERATE], np.asarray(want)[0][~DEGENERATE], name)


def test_small_front_ends_refusals_and_device(monkeypatch):
    """The keywords the JAX entries swallow raise; without CUDA and without
    device= every new entry raises rather than building on the CPU."""
    with pytest.raises(ValueError, match="flash cannot take effect on wav"):
        hub.load("wav", flash=True, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("example", seed=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("wav", "log_stft", "example", "wav2vec", "vq_wav2vec_kmeans", "cpc", "decoar",
                 "decoar_layers", "decoar2", "byol_a", "byol_s_cvt"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            hub.load(name)
