"""The MOS predictor upstreams of s3prl_tpu_torch vs s3prl_tpu (CPU):
mos_prediction / mos_wav2vec2 (wav2vec2-Base trunk), mos_apc and mos_tera
at a tiny width, their checkpoints in the reference's layout, and the
keywords the port refuses.

The JAX MosModel's params (every leaf perturbed) reach the port through
`mos_state_dict_from_jax`; the registries' entries are patched to tiny
configs (a 2-layer trunk of 128 on the seven-layer conv stack at 64
channels, APC 3 x 32, TERA 64 / 2 layers / 4 heads). Windows come from the
padded T (one up to 16,000 samples, T // 8,000 beyond), so the cases run
at padded T 16,000, 16,001 (two windows, the second nearly all padding)
and 24,001 (three) with rows of every window count. Tolerances: scores
at atol 5e-4 (f32); a checkpoint's loaded weights equal in both packages,
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.apc as jax_apc
import s3prl_tpu.models.mockingjay as jax_mockingjay
import s3prl_tpu.models.mos as jax_mos
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxTrunkConfig
from s3prl_tpu.upstream.convert import load_mos_checkpoint as jax_load_mos
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.apc import APCConfig
from s3prl_tpu_torch.models.mockingjay import MockingjayConfig
from s3prl_tpu_torch.models.mos import MosConfig, MosModel
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from s3prl_tpu_torch.nn import init_params
from s3prl_tpu_torch.upstream.convert import load_mos_checkpoint, mos_state_dict_from_jax
from test_torch_port_mel_ssl import with_defaults
from test_torch_port_w2v2 import WIDTH, perturbed

TRUNK = dict(WIDTH, extractor_mode="default", layer_norm_first=False)
APC = dict(hidden_size=32, num_layers=3)
TERA = dict(input_dim=80, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128)
UPSTREAMS = ["wav2vec2", "apc", "tera"]
# padded T -> the rows' lengths: one window; just over one (two windows);
# odd lengths over three windows
CASES = {"T 16000": [16000, 9000, 333], "T 16001": [16001, 16000, 8001],
         "T 24001": [24001, 16001, 12345]}
OPTIONS = {"mean": (False, False), "clipping, attention": (True, True)}


def configs(upstream, clipping=False, attention=False):
    """(JAX MosConfig, port MosConfig) of a tiny MOS model."""
    head = dict(upstream=upstream, projector_dim=16, clipping=clipping,
                attention_pooling=attention)
    jax_cfg = jax_mos.MosConfig(
        trunk=JaxTrunkConfig(**TRUNK), apc=jax_apc.APCConfig(**APC),
        tera=jax_mockingjay.MockingjayConfig(**TERA), **head)
    port_cfg = MosConfig(trunk=Wav2Vec2Config(**TRUNK), apc=APCConfig(**APC),
                         tera=MockingjayConfig(**TERA), **head)
    return jax_cfg, port_cfg


def waves(lens, seed=0):
    lens = np.asarray(lens, np.int32)
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), lens.max()).astype(np.float32) * 0.1
    return x * (np.arange(lens.max())[None] < lens[:, None]), lens


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("upstream", UPSTREAMS)
def test_model_matches_flax(upstream, option):
    """MosModel on the JAX params: the scores of every case and their
    lengths."""
    jax_cfg, port_cfg = configs(upstream, *OPTIONS[option])
    jax_model = jax_mos.MosModel(jax_cfg)
    params = perturbed(jax.jit(lambda k: jax_model.init(
        k, jnp.zeros((1, 16000)), jnp.asarray([16000])))(jax.random.key(0))["params"])
    port = MosModel(port_cfg).eval()
    port.load_state_dict(mos_state_dict_from_jax(params, port_cfg))
    apply = jax.jit(lambda x, n: jax_model.apply({"params": params}, x, n))
    for case, lens in CASES.items():
        x, lens = waves(lens)
        want, want_lens = apply(jnp.asarray(x), jnp.asarray(lens))
        got, got_lens = port(torch.from_numpy(x), torch.from_numpy(lens))
        assert tuple(got.shape) == np.shape(want), case
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens), err_msg=case)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4, rtol=0,
                                   err_msg=case)


@pytest.fixture
def tiny_entries(monkeypatch):
    """Both registries' MOS entries at the tiny width."""
    monkeypatch.setattr(jax_mos, "MosConfig", with_defaults(
        jax_mos.MosConfig, trunk=JaxTrunkConfig(**TRUNK), projector_dim=16))
    monkeypatch.setattr(jax_apc, "APCConfig", with_defaults(jax_apc.APCConfig, **APC))
    monkeypatch.setattr(jax_mockingjay, "MockingjayConfig",
                        with_defaults(jax_mockingjay.MockingjayConfig, **TERA))
    monkeypatch.setattr(port_registry, "MosConfig", with_defaults(
        MosConfig, trunk=Wav2Vec2Config(**TRUNK), projector_dim=16))
    monkeypatch.setattr(port_registry, "APCConfig", with_defaults(APCConfig, **APC))
    monkeypatch.setattr(port_registry, "MockingjayConfig", with_defaults(MockingjayConfig, **TERA))


@pytest.mark.parametrize("name", ["mos_prediction", "mos_wav2vec2", "mos_apc", "mos_tera"])
def test_entry_matches_jax(tiny_entries, name):
    """The entry's standardized [1, B, T', 1] on the JAX entry's weights:
    one score an utterance over its frames, at the upstream's stride."""
    jup = jax_hub.load(name)
    params = perturbed(jup.params)
    jup.params = params
    up = hub.load(name, device="cpu")
    up.model.load_state_dict(mos_state_dict_from_jax(params, up.model.cfg))
    assert (up.num_layers, up.hidden_size) == (1, 1)
    assert up.downsample_rate == (160 if name in ("mos_apc", "mos_tera") else 320)
    x, lens = waves(CASES["T 24001"], seed=1)
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(lens))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    assert torch.equal(got, got[:, :, :1].expand_as(got))


# -- checkpoints {"Upstream", "Featurizer", "Downstream", "Config"} -----------------


def _downstream(sd, attention):
    keys = {"connector": "connector", "mean_net_linear": "model.mean_net_linear"}
    if attention:
        keys["mean_net_pooling"] = "model.mean_net_pooling.W"
    return {f"{ref}.{kind}": sd[f"{name}.{kind}"] for name, ref in keys.items()
            for kind in ("weight", "bias")}


def _write(tmp_path, upstream, sd, attention, modelrc=True, extra_config=None):
    """The reference expert's checkpoint of a port MosModel state_dict."""
    prefix = {"apc": "model.", "tera": "transformer.", "trunk": "model."}[upstream]
    config = {"downstream_expert": {"modelrc": {
        "projector_dim": 16, "clipping": attention, "attention_pooling": attention}}}
    path = tmp_path / f"mos_{upstream}.ckpt"
    torch.save({
        "Upstream": {f"{prefix}{k[len(upstream) + 1:]}": v for k, v in sd.items()
                     if k.startswith(f"{upstream}.")},
        "Featurizer": {"weights": sd["featurizer_weights"]},
        "Downstream": _downstream(sd, attention),
        "Config": {**(config if modelrc else {}), **(extra_config or {})},
    }, path)
    return path


def _same_load(path):
    """Both loaders on `path`: equal configs' fields, the JAX params through
    `mos_state_dict_from_jax` equal to the port's state_dict bit for bit."""
    jax_cfg, jax_params = jax_load_mos(str(path))
    cfg, sd = load_mos_checkpoint(str(path))
    for field in ("upstream", "feat_kind", "projector_dim", "clipping", "attention_pooling"):
        assert getattr(cfg, field) == getattr(jax_cfg, field), field
    want = mos_state_dict_from_jax(jax_params, cfg)
    assert sd.keys() == want.keys()
    for k in sd:
        if not k.startswith("apc.rnn_layers."):  # JAX folds b_hr / b_hz into its input bias
            assert torch.equal(sd[k], want[k]), k
    return cfg, sd


@pytest.mark.parametrize("upstream,attention", [("apc", False), ("tera", True)])
def test_checkpoint_loads_the_same_model(tmp_path, upstream, attention):
    """mos_apc and mos_tera checkpoints: the same config and weights, and
    through `hub.load(ckpt=)` the same scores as the JAX entry's. TERA's
    heads come from the Config (8, where the width's fallback says 4)."""
    _, port_cfg = configs(upstream, attention, attention)
    port_cfg = dataclasses.replace(port_cfg, tera=dataclasses.replace(
        port_cfg.tera, num_attention_heads=8))
    model = MosModel(port_cfg)
    init_params(model, torch.Generator().manual_seed(0))
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          for i, (k, v) in enumerate(model.state_dict().items())}
    heads = {"upstream_expert": {"transformer": {"num_attention_heads": 8}}}
    path = _write(tmp_path, upstream, sd, attention, extra_config=heads)
    cfg, loaded = _same_load(path)
    if upstream == "tera":
        assert cfg.tera.num_attention_heads == 8 and cfg.tera.num_hidden_layers == 2
    else:
        assert (cfg.apc.num_layers, cfg.apc.hidden_size, cfg.apc.input_size) == (3, 32, 80)
    name = f"mos_{upstream}"
    up = hub.load(name, ckpt=str(path), device="cpu")
    jup = jax_hub.load(name, ckpt=str(path))
    x, lens = waves(CASES["T 16001"], seed=2)
    want, _ = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(lens))
    got, _ = up(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_wav2vec2_checkpoint_loads_the_same_weights(tmp_path):
    """mos_prediction's released layout: a "model."-prefixed wav2vec2-Base
    state_dict (the published width: the loader takes Base's config), no
    modelrc (the projector's width from the connector)."""
    up = hub.load("mos_prediction", device="cpu")
    sd = up.model.state_dict()
    path = _write(tmp_path, "trunk", sd, attention=False, modelrc=False)
    del up, sd
    cfg, _ = _same_load(path)
    assert cfg.upstream == "wav2vec2" and cfg.projector_dim == 256
    assert cfg.trunk.encoder_layers == 12 and cfg.downsample_rate == 320


@pytest.mark.parametrize("name", ["mos_prediction", "mos_wav2vec2", "mos_apc", "mos_tera"])
def test_refused_keywords(tiny_entries, name, tmp_path, monkeypatch):
    """flash, quantize and the trunk options cannot take effect (the JAX
    entry swallows them); mos_apc's APC runs in f32; a native checkpoint
    raises; train mode runs with the nested upstream's dropouts, with
    states that need no grad; the card without device=."""
    for option in ({"flash": True}, {"quantize": True}, {"qkv_fuse": True}):
        with pytest.raises(ValueError, match="cannot take effect"):
            hub.load(name, device="cpu", **option)
    if name == "mos_apc":
        with pytest.raises(ValueError, match="cannot take effect"):
            hub.load(name, dtype=torch.bfloat16, device="cpu")
    native = tmp_path / "params.msgpack"
    native.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="msgpack"):
        hub.load(name, ckpt=str(native), device="cpu")
    up = hub.load(name, device="cpu")
    hs, _ = up(torch.zeros(1, 1600), torch.tensor([1600]), train=True,
               generator=torch.Generator().manual_seed(0))
    assert up.model.training and not hs.requires_grad and torch.isfinite(hs).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hub.load(name)
