"""BYOL-A and BYOL-S of s3prl_tpu_torch vs s3prl_tpu (CPU).

Each JAX entry's random variables, every leaf perturbed (BatchNorm
variances kept positive, statistics away from 0 / 1), go to the port
through `byol_state_dict_from_jax`, and both registries run the same
padded batch. The entries' configs are cut in both packages to windows of
0.1 s (BYOL-A's stride 0.1 s, BYOL-S's 50 ms) and AudioNTT2020's width to
64; the encoders keep their shapes (64 mels, ResNetish34's and CvT's
stages). The batch holds a row that is an exact multiple of both strides
(3,200 samples) and a short one: BYOL-A counts no padding window, BYOL-S
normalises with every window of the batch. Tolerances: the states at atol
5e-4 of their largest magnitude (f32: the embeddings of random weights
reach 1e2 with BYOL-A's fixed statistics and 1e5 with BYOL-S's, whose 1/N
quirk multiplies the log-mel by the window count), the window counts
equal.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.byol as jax_byol
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.upstream.convert_zoo import byol_state_dict_from_jax

LENS = np.asarray([4000, 3200, 1001], np.int32)  # 3200: 2 x 1,600 and 4 x 800
CUT = dict(window_secs=0.1, feature_d=64)
CONFIGS = {"BYOL_A_2048": dict(stride_secs=0.1), "BYOL_A_1024": dict(stride_secs=0.1),
           "BYOL_A_512": dict(stride_secs=0.1), "BYOL_S_DEFAULT": {},
           "BYOL_S_RESNETISH34": {}, "BYOL_S_CVT": {}}
ENTRIES = {"byol_a": "BYOL_A_2048", "byol_a_2048": "BYOL_A_2048", "byol_a_1024": "BYOL_A_1024",
           "byol_a_512": "BYOL_A_512", "byol_s": "BYOL_S_DEFAULT",
           "byol_s_default": "BYOL_S_DEFAULT", "byol_s_resnetish34": "BYOL_S_RESNETISH34",
           "byol_s_cvt": "BYOL_S_CVT"}


@pytest.fixture
def tiny_byol(monkeypatch):
    for name, fields in CONFIGS.items():
        for module in (jax_byol, port_registry):
            monkeypatch.setattr(module, name,
                                dataclasses.replace(getattr(module, name), **CUT, **fields))


def waves(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(LENS), LENS.max()).astype(np.float32) * 0.3
    return x * (np.arange(LENS.max())[None] < LENS[:, None])


def perturbed(variables, seed=0):
    """Every leaf + 0.05 N(0, 1); BatchNorm variances |v| + 0.5."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32) + 0.05 * rng.randn(*np.shape(x)).astype(np.float32)
        return np.abs(x) + 0.5 if jax.tree_util.keystr(path).endswith("['var']") else x

    return jax.tree_util.tree_map_with_path(leaf, variables)


_JAX_UPSTREAMS = {}


def pair(name, seed=0):
    """(the JAX entry with perturbed variables, the port's entry with them)."""
    if name not in _JAX_UPSTREAMS:
        _JAX_UPSTREAMS[name] = jax_hub.load(name)
    jup = copy.copy(_JAX_UPSTREAMS[name])
    jup.params = perturbed(jup.params, seed)
    up = hub.load(name, device="cpu")
    up.model.load_state_dict(byol_state_dict_from_jax(jup.params, up.model.cfg))
    return jup, up


def both(jup, up, train=False, generator=None):
    x = waves()
    rngs = {"dropout": jax.random.key(0)} if train else None
    want, want_lens = jax.jit(jup.apply_standardized, static_argnums=3)(
        jup.params, jnp.asarray(x), jnp.asarray(LENS), train, rngs)
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS), train=train,
                       generator=generator)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    return got, np.asarray(want)


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("name", ["byol_a", "byol_s", "byol_s_resnetish34", "byol_s_cvt"])
def test_entry_matches_jax(tiny_byol, name):
    """The window embeddings of the three encoders under both
    normalisations; the entry's metadata."""
    jup, up = pair(name)
    got, want = both(jup, up)
    assert got.shape == want.shape and got.shape[0] == 1
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    assert_close(got, want)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entries_metadata(tiny_byol, name):
    """Every name's width, stride and config, against JAX's."""
    up = hub.load(name, device="cpu")
    jup = jax_hub.load(name)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    assert dataclasses.asdict(up.model.cfg) == dataclasses.asdict(
        getattr(jax_byol, ENTRIES[name]))


def test_window_counts_at_the_stride_edges():
    """Without the cut: a 2-s wave (an exact multiple of both strides) has
    BYOL-A 2 windows and BYOL-S 41; 2 s + 1 sample 3 and 41; as JAX."""
    for name in ("byol_a", "byol_s"):
        up = hub.load(name, device="cpu")
        jup = jax_hub.load(name)
        for n in (32000, 32001):
            segs, count = up.model.windows(torch.zeros(1, n))
            _, jlens = jax.jit(jup.apply_fn)(jup.params, jnp.zeros((1, n)), jnp.asarray([n]))
            assert segs.shape[:2] == (1, count)
            _, lens = up.model(torch.zeros(1, n), torch.tensor([n]))
            assert lens.tolist() == np.asarray(jlens).tolist()
            assert count == {("byol_a", 32000): 2, ("byol_a", 32001): 3}.get((name, n), 41)


@pytest.mark.parametrize("name", ["byol_s_resnetish34", "byol_s_cvt", "byol_a"])
def test_batchnorm_keeps_its_statistics_in_train_mode(tiny_byol, name):
    """Train mode runs every BatchNorm on its running statistics and changes
    no buffer (JAX's use_running_average=True): ResNetish34 and CvT, with no
    dropout, give JAX's train-mode states; AudioNTT2020's dropout (0.3) runs
    from the generator, and at rate 0 its train mode gives JAX's eval states."""
    jup, up = pair(name, seed=1)
    buffers = {k: v.clone() for k, v in up.model.named_buffers()}
    if name != "byol_a":
        got, want = both(jup, up, train=True)
        assert_close(got, want)
    else:
        _, want = both(jup, up)
        dropped, _ = up(torch.from_numpy(waves()), torch.from_numpy(LENS), train=True,
                        generator=torch.Generator().manual_seed(0))
        assert not np.allclose(dropped.numpy(), want, atol=1e-3)
        up.model.net.fc[2].p = 0.0
        got, _ = up(torch.from_numpy(waves()), torch.from_numpy(LENS), train=True)
        assert_close(got, want)
    assert up.model.training
    for k, v in up.model.named_buffers():
        assert torch.equal(v, buffers[k]), k


def reference_layout(sd, encoder):
    """The checkpoint layouts: AudioNTT2020's keys under a wrapper prefix
    (``net.``) beside a key neither loader reads; ResNetish34's and CvT's
    bare, beside a classifier head."""
    if encoder == "ntt":
        return {"state_dict": {**sd, "projector.0.weight": torch.ones(3)}}
    return {**{k[len("net."):]: v for k, v in sd.items()}, "fc.weight": torch.ones(3)}


@pytest.mark.parametrize("name", ["byol_a_512", "byol_s_resnetish34", "byol_s_cvt"])
def test_checkpoint_round_trip(tmp_path, tiny_byol, name):
    """The reference layouts written from the port's state_dict, read by
    both packages' hub.load to the same states; a checkpoint of another
    encoder raises at load (the JAX model would fail at apply)."""
    jup, up = pair(name, seed=2)
    path = tmp_path / f"{name}.pth"
    torch.save(reference_layout(up.model.state_dict(), up.model.cfg.encoder), path)
    jup = jax_hub.load(name, ckpt=str(path))
    up = hub.load(name, ckpt=str(path), device="cpu")
    got, want = both(jup, up)
    assert_close(got, want)
    other = "byol_s_cvt" if name == "byol_s_resnetish34" else "byol_s_resnetish34"
    with pytest.raises(ValueError, match="checkpoint"):
        hub.load(other, ckpt=str(path), device="cpu")


def test_refusals():
    """A dtype (the JAX factories take none) and the trunk options raise."""
    with pytest.raises(ValueError, match="runs in f32"):
        hub.load("byol_s", dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="flash cannot take effect on byol_a"):
        hub.load("byol_a", flash=True, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("byol_s_cvt", window_secs=0.5, device="cpu")
