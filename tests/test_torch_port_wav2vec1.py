"""wav2vec 1.0 and vq-wav2vec of s3prl_tpu_torch vs s3prl_tpu (CPU).

The port's `Wav2Vec1Model` keeps the reference's keys, so its random
weights, every tensor perturbed, go through the JAX package's converter
(`wav2vec1_params_from_torch`) into the JAX model, and back through the
port's `wav2vec1_state_dict_from_jax` (bit for bit). Tiny configs (three
extractor convs at stride 40, three aggregator convs at 32 channels; a
16-wide Gumbel codeword takes a residual projection) on a ragged batch: the group norm covers
each row's padding, so a short row's states depend on the padded length
in both. Tolerances: every hidden state at atol 5e-4 in f32 (the
quantizers' codes equal), per-layer cosine > 0.999 over the valid frames
in bf16, lengths equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.wav2vec1 as jax_w2v1
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.upstream import convert as jax_convert
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.wav2vec1 import Wav2Vec1Config, Wav2Vec1Model
from s3prl_tpu_torch.upstream.convert_zoo import wav2vec1_state_dict_from_jax
from s3prl_tpu_torch.upstream.registry import _init_flax
from test_torch_port_mel_ssl import perturb, same_trees, with_defaults

FEAT = ((32, 10, 5), (32, 8, 4), (32, 4, 2))
AGG = ((32, 2, 1), (32, 3, 1), (32, 4, 1))
TINY = dict(conv_feature_layers=FEAT, conv_aggregator_layers=AGG, vq_vars=16, vq_dim=32)
CONFIGS = {
    "plain": {},
    "skips, zero pad, no affine": dict(skip_connections_feat=True, agg_zero_pad=True,
                                       non_affine_group_norm=True, conv_bias=False),
    "gumbel": dict(vq_type="gumbel"),
    "gumbel depth 2, combined": dict(vq_type="gumbel", vq_depth=2, combine_groups=True),
    "gumbel 16 wide": dict(vq_type="gumbel", vq_dim=16),  # a residual projection 16 -> 32
    "kmeans": dict(vq_type="kmeans"),
    "kmeans combined": dict(vq_type="kmeans", combine_groups=True),
}
LENS = np.asarray([4000, 2960, 1001], np.int32)  # 2960 = 74 x the stride 40


def waves(lens=LENS, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), lens.max()).astype(np.float32) * 0.3
    return x * (np.arange(lens.max())[None] < lens[:, None])


def layer_cosines(a, b, lens):
    """Per-layer cosine of [L, B, T, H] states over each row's `lens` frames."""
    out = []
    for layer in range(a.shape[0]):
        x = np.concatenate([np.asarray(a[layer, i, :n], np.float64) for i, n in enumerate(lens)])
        y = np.concatenate([np.asarray(b[layer, i, :n], np.float64) for i, n in enumerate(lens)])
        out.append(float((x * y).sum() / (np.linalg.norm(x) * np.linalg.norm(y))))
    return out


def port_model(cfg, dtype=torch.float32, seed=0):
    model = Wav2Vec1Model(cfg, dtype)
    _init_flax(model, torch.Generator().manual_seed(seed))
    return model.eval()


def jax_forward(cfg_kwargs, sd, x, lens, dtype=jnp.float32):
    jcfg = jax_w2v1.Wav2Vec1Config(**cfg_kwargs)
    params = jax_convert.wav2vec1_params_from_torch(sd, jcfg)
    model = jax_w2v1.Wav2Vec1Model(jcfg, dtype=dtype)
    fn = jax.jit(lambda p, w, n: model.apply({"params": p}, w, n, deterministic=True,
                                             return_code_ids=True))
    return params, fn(params, jnp.asarray(x), jnp.asarray(lens))


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_model_matches_jax(kind):
    """Every state at atol 5e-4, the codes equal, the lengths equal; the
    JAX tree back through `wav2vec1_state_dict_from_jax` bit for bit."""
    kwargs = dict(TINY, **CONFIGS[kind])
    cfg = Wav2Vec1Config(**kwargs)
    model = port_model(cfg)
    sd = perturb(model.state_dict())
    model.load_state_dict(sd)
    x = waves()
    params, (want, want_lens, want_codes) = jax_forward(kwargs, sd, x, LENS)
    with torch.no_grad():
        got, got_lens, got_codes = model(torch.from_numpy(x), torch.from_numpy(LENS),
                                         return_code_ids=True)
    assert got.shape == (len(AGG) + 1, len(LENS), np.shape(want)[2], AGG[-1][0])
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    if cfg.vq_type == "none":
        assert got_codes is None and want_codes is None
    else:
        np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    back = wav2vec1_state_dict_from_jax(params, cfg)
    assert sorted(back) == sorted(sd)
    same_trees(jax_convert.wav2vec1_params_from_torch(back, jax_w2v1.Wav2Vec1Config(**kwargs)),
               params)


@pytest.mark.parametrize("kind", ["plain", "gumbel", "kmeans"])
def test_bf16_matches_jax(kind):
    """bf16 in both (the JAX model's dtype, the port's): per-layer cosine >
    0.999 over the valid frames. With a quantizer, z's bf16 rounding (one
    or two steps apart where the two packages sum in other orders) moves
    near-tie codes: z holds 0.999, at least 98% of the codes are equal, and
    the aggregator's states, where a moved code brings another codeword,
    hold 0.99."""
    kwargs = dict(TINY, **CONFIGS[kind])
    cfg = Wav2Vec1Config(**kwargs)
    sd = perturb(port_model(cfg).state_dict())
    model = port_model(cfg, torch.bfloat16)
    model.load_state_dict(sd)
    x = waves()
    _, (want, want_lens, want_codes) = jax_forward(kwargs, sd, x, LENS, jnp.bfloat16)
    with torch.no_grad():
        got, got_lens, got_codes = model(torch.from_numpy(x), torch.from_numpy(LENS),
                                         return_code_ids=True)
    assert got.dtype == torch.bfloat16 and np.asarray(want).dtype == jnp.bfloat16
    lens = got_lens.tolist()
    assert lens == np.asarray(want_lens).tolist()
    coss = layer_cosines(got.float().numpy(), np.asarray(want, np.float32), lens)
    if cfg.vq_type == "none":
        assert min(coss) > 0.999, coss
        return
    valid = np.arange(got_codes.shape[1])[None] < np.asarray(lens)[:, None]
    share = float((got_codes.numpy() == np.asarray(want_codes))[valid].mean())
    assert coss[0] > 0.999 and share >= 0.98 and min(coss[1:]) > 0.99, (coss, share)


ENTRIES = {"wav2vec": "plain", "wav2vec_large": "plain", "vq_wav2vec": "gumbel",
           "vq_wav2vec_gumbel": "gumbel", "vq_wav2vec_kmeans": "kmeans"}


# the entries' tiny configs: the JAX vq entries set vq_dim 512 and stack z
# with the aggregator's states, so every width is 512
ENTRY_TINY = dict(conv_feature_layers=tuple((512, k, s) for _, k, s in FEAT),
                  conv_aggregator_layers=tuple((512, k, s) for _, k, s in AGG), vq_vars=16)


@pytest.fixture
def tiny_entries(monkeypatch):
    """Both registries' wav2vec entries at the tiny depth."""
    monkeypatch.setattr(jax_w2v1, "Wav2Vec1Config",
                        with_defaults(jax_w2v1.Wav2Vec1Config, **ENTRY_TINY))
    for name in ("W2V1", "VQ_WAV2VEC", "VQ_WAV2VEC_KMEANS"):
        monkeypatch.setattr(port_registry, name,
                            dataclasses.replace(getattr(port_registry, name), **ENTRY_TINY))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_matches_jax(tiny_entries, name):
    """Each entry's standardized states through both registries on the
    port's weights; its metadata."""
    up = hub.load(name, device="cpu")
    sd = perturb(up.model.state_dict())
    up.model.load_state_dict(sd)
    jup = jax_hub.load(name)
    jup.params = jax_convert.wav2vec1_params_from_torch(sd, jup_cfg(up.model.cfg))
    x = waves()
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def jup_cfg(cfg):
    return jax_w2v1.Wav2Vec1Config(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("kind", ["plain", "gumbel", "kmeans"])
def test_checkpoint_round_trip(tmp_path, kind):
    """The reference's s3prl layout ({"task_cfg", "model_cfg", "model_weight"},
    the architecture in model_cfg) written from the port's state_dict, read by
    both packages' hub.load (a generic loader, an entry) to the same states."""
    kwargs = dict(TINY, **CONFIGS[kind])
    sd = perturb(port_model(Wav2Vec1Config(**kwargs)).state_dict(), seed=1)
    model_cfg = {"conv_feature_layers": str(list(FEAT)), "conv_aggregator_layers": str(list(AGG)),
                 "vq_vars": 16, "vq_dim": 32, "vq_type": CONFIGS[kind].get("vq_type", "none")}
    path = tmp_path / "w2v1.pt"
    torch.save({"task_cfg": {}, "model_cfg": model_cfg, "model_weight": sd}, path)
    entry = {"plain": "wav2vec_local", "gumbel": "vq_wav2vec_custom", "kmeans": "vq_wav2vec_kmeans"}
    name = entry[kind]
    jup = jax_hub.load(name, ckpt=str(path))
    up = hub.load(name, ckpt=str(path), device="cpu")
    assert up.model.cfg == Wav2Vec1Config(**kwargs)
    x = waves(seed=2)
    want, want_lens = jup(jnp.asarray(x), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_bare_state_dict_takes_the_default_config(tmp_path):
    """A bare state_dict loads with the default config (8 extractor and 12
    aggregator convs at 512) in both."""
    sd = perturb(port_model(Wav2Vec1Config()).state_dict(), seed=3)
    path = tmp_path / "bare.pt"
    torch.save(sd, path)
    jup = jax_hub.load("wav2vec", ckpt=str(path))
    up = hub.load("wav2vec_custom", ckpt=str(path), device="cpu")
    assert up.model.cfg == Wav2Vec1Config()
    x = waves(seed=4)
    want, _ = jup(jnp.asarray(x), jnp.asarray(LENS))
    got, _ = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_train_mode_matches_jax(tiny_entries):
    """JAX's trainer hands the upstream a "dropout" stream only: the Gumbel
    quantizer's train mode raises InvalidRngError there and the port's
    refuses; wav2vec and the k-means quantizer (no stream, dropout 0) give
    their eval states in both."""
    x, lens = waves(), LENS
    for name in ("wav2vec", "vq_wav2vec_kmeans"):
        up = hub.load(name, device="cpu")
        jup = jax_hub.load(name)
        jup.params = jax_convert.wav2vec1_params_from_torch(up.model.state_dict(),
                                                            jup_cfg(up.model.cfg))
        want, _ = jup(jnp.asarray(x), jnp.asarray(lens), True, {"dropout": jax.random.key(0)})
        got, _ = up(torch.from_numpy(x), torch.from_numpy(lens), train=True,
                    generator=torch.Generator().manual_seed(0))
        assert up.model.training
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    jup = jax_hub.load("vq_wav2vec")
    with pytest.raises(Exception, match="gumbel"):
        jup(jnp.asarray(x), jnp.asarray(lens), True, {"dropout": jax.random.key(0)})
    up = hub.load("vq_wav2vec", device="cpu")
    with pytest.raises(NotImplementedError, match="gumbel"):
        up(torch.from_numpy(x), torch.from_numpy(lens), train=True)
    with pytest.raises(NotImplementedError, match="gumbel"):
        up.model.train()(torch.from_numpy(x), torch.from_numpy(lens))


def test_keyword_refusals(tiny_entries):
    """The trunk options and dtypes other than f32 / bf16 raise at load (the
    JAX entries take and ignore them); an unknown keyword is a TypeError."""
    for kw in ({"flash": True}, {"quantize": True}, {"fused_posconv": True}):
        with pytest.raises(ValueError, match="cannot take effect on wav2vec"):
            hub.load("wav2vec", device="cpu", **kw)
    with pytest.raises(ValueError, match="f32 or bf16"):
        hub.load("vq_wav2vec", dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("vq_wav2vec_kmeans", model_config="x.yaml", device="cpu")
    assert hub.load("wav2vec", flash=False, dtype=torch.bfloat16,
                    device="cpu").model.dtype == torch.bfloat16
