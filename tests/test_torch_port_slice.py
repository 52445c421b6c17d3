"""The HuBERT-Large-style extraction slice of s3prl_tpu_torch vs s3prl_tpu (CPU).

A tiny trunk of the same family (layer-norm extractor, pre-LN encoder,
normalize=True) is initialised in JAX, its parameters perturbed so that no
bias or norm is trivial, and carried to the port with
`trunk_state_dict_from_jax`. The same numpy batch goes through
`Upstream.apply_standardized` of both packages. Tolerances: f32 per-layer
hidden states at atol 5e-4 over valid frames (the ROADMAP bar); bf16
per-layer cosine > 0.999 over valid frames (the JAX package's quality gate
for its reduced-precision paths); lengths exactly equal.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu.upstream.convert import trunk_params_from_torch
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.kernels import wrappers
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax

TINY = dict(
    extractor_mode="layer_norm",
    conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    layer_norm_first=True, dropout=0.0, attention_dropout=0.0,
    dropout_input=0.0, normalize=True,
)
JCFG, PCFG = JaxConfig(**TINY), Wav2Vec2Config(**TINY)
STRIDE = 20


@pytest.fixture(scope="module")
def jax_params():
    """Random JAX trunk params, every leaf perturbed by numpy noise."""
    wavs = jnp.zeros((1, 3200), jnp.float32)
    params = JaxTrunk(JCFG).init(jax.random.key(0), wavs, jnp.asarray([3200]),
                                 deterministic=True)["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)


def _batch(seed, lens, T=None):
    rng = np.random.RandomState(seed)
    T = T or max(lens)
    wavs = np.zeros((len(lens), T), np.float32)
    for i, n in enumerate(lens):
        wavs[i, :n] = rng.randn(n)
    return wavs, np.asarray(lens, np.int32)


def _run_jax(params, wavs, lens, dtype=jnp.float32, flash=False):
    trunk = JaxTrunk(JCFG, dtype=dtype, use_flash=flash)
    up = JaxUpstream(
        name="tiny", params={"params": params},
        apply_fn=lambda v, w, l, train, rngs: trunk.apply(v, w, l, deterministic=True),
        num_layers=JCFG.encoder_layers + 1, hidden_size=JCFG.encoder_embed_dim,
        downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def _port(params, dtype=torch.float32, flash=False):
    model = Wav2Vec2Trunk(PCFG, dtype=dtype, use_flash=flash, device="meta")
    model.to_empty(device="cpu")
    model.load_state_dict(trunk_state_dict_from_jax(params, PCFG))
    return Upstream(name="tiny", model=model.eval(),
                    num_layers=PCFG.encoder_layers + 1,
                    hidden_size=PCFG.encoder_embed_dim, downsample_rate=STRIDE)


def _run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _valid_frames(h_lens, T):
    return [min(int(n), T) for n in h_lens]


def test_slice_f32_matches_jax(jax_params):
    wavs, lens = _batch(1, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens)
    got, got_lens = _run_port(_port(jax_params), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (3, 3, 320, 128)
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       err_msg=f"layer {layer} utterance {b}")


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_slice_bf16_flash_matches_jax_kernels(jax_params, monkeypatch, route):
    """JAX runs K3/K4/K5 (interpret mode); the port runs its kernel wrappers
    (plain versions on CPU) or, unpatched, its plain module path."""
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    if route == "kernels":
        monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    wavs, lens = _batch(2, [6400, 3001, 1])
    want, want_lens = _run_jax(jax_params, wavs, lens, jnp.bfloat16, flash=True)
    got, got_lens = _run_port(_port(jax_params, torch.bfloat16, flash=True), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            cos = _cos(got[layer, b, :n], want[layer, b, :n])
            assert cos > 0.999, (layer, b, cos)


@pytest.mark.parametrize("lens,T", [([500, 300, 1], 500), ([1, 1], 1), ([6399, 6401], 6401)],
                         ids=["sub-min-second", "one-sample", "off-by-one"])
def test_slice_lengths_match_jax(jax_params, lens, T):
    wavs, lens = _batch(3, lens, T)
    want, want_lens = _run_jax(jax_params, wavs, lens)
    got, got_lens = _run_port(_port(jax_params), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
        np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=5e-4)


def test_state_dict_round_trip_is_exact(jax_params):
    sd = trunk_state_dict_from_jax(jax_params, PCFG)
    up = _port(jax_params)
    for tree in (trunk_params_from_torch(sd, JCFG),
                 trunk_params_from_torch(up.model.state_dict(), JCFG)):
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(jax_params))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


def test_kernel_route_refuses_long_utterances(jax_params, monkeypatch):
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    layer = _port(jax_params, torch.bfloat16, flash=True).model.encoder.layers[0]
    x = torch.zeros(1, 513, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="K7"):
        layer(x, torch.tensor([513], dtype=torch.int32), torch.zeros(1, 513, dtype=torch.bool))


def test_cpu_run_counts_no_launch(jax_params):
    before = [w.launches for w in wrappers()]
    wavs, lens = _batch(4, [3200, 1600])
    _run_port(_port(jax_params, torch.bfloat16, flash=True), wavs, lens)
    assert [w.launches for w in wrappers()] == before


def test_registry_refuses_what_is_not_ported():
    with pytest.raises(KeyError):
        hub.load("no_such_upstream")
    with pytest.raises(NotImplementedError, match="int8"):
        hub.load("hubert_large_ll60k", quantize=True)
    with pytest.raises(NotImplementedError):
        Wav2Vec2Trunk(Wav2Vec2Config(), device="meta")  # HuBERT-Base: group norm, post-LN
    assert hub.options() == ["hubert_large_ll60k"]


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import s3prl_tpu_torch.hub, s3prl_tpu_torch.upstream.convert\n"
        "import s3prl_tpu_torch.kernels.conv_frontend, s3prl_tpu_torch.kernels.ffn\n"
        "import s3prl_tpu_torch.kernels.flash_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 's3prl_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
