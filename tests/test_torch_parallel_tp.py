"""Tensor parallelism of the port (tp = 2 over two spawned gloo ranks on the
CPU) against the JAX package's `shard_params` tp = 2 forward on its
8-device virtual mesh (tests/test_parallel.py:131-157).

Three tiny trunks, the real module graphs at C 128 (three conv layers of 64
channels, two encoder layers, H 4, FFN 256, pos-conv k 16 in 4 groups),
every JAX leaf perturbed and carried to the port by the converters:
HuBERT pre-LN (layer-norm extractor, normalize), HuBERT post-LN
(group-norm extractor) and WavLM pre-LN (32 buckets up to 80). Tolerances:
f32 at atol 2e-4 / rtol 1e-4 (JAX's own tp = 2 bar); bf16 with flash (the
port's K7 / K9 wrappers on each rank's two heads, whose plain versions run
on the CPU) at a per-layer cosine >= 0.999 over valid frames against the
JAX f32 forward. The int8 model and the fused-block options raise at load
under tp.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s3prl_tpu.parallel.mesh import shard_params as jax_shard_params
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from s3prl_tpu_torch.models.wavlm import WavLMConfig
from s3prl_tpu_torch.parallel import distributed
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax, wavlm_state_dict_from_jax
from test_torch_port_slice import _batch, _layer_cosines
from torch_parallel_workers import tp_rank

WIDTH = dict(conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)), encoder_layers=2,
             encoder_embed_dim=128, encoder_ffn_embed_dim=256, encoder_attention_heads=4,
             conv_pos=16, conv_pos_groups=4, dropout=0.0, attention_dropout=0.0,
             dropout_input=0.0)
MODELS = {
    "hubert_pre": ("w2v2", dict(WIDTH, extractor_mode="layer_norm", layer_norm_first=True,
                                normalize=True)),
    "hubert_post": ("w2v2", dict(WIDTH, extractor_mode="default", layer_norm_first=False)),
    "wavlm": ("wavlm", dict(WIDTH, extractor_mode="layer_norm", layer_norm_first=True,
                            normalize=True, num_buckets=32, max_distance=80)),
}
STRIDE = 20
LENS = [3200, 2101]


def _jax_model(kind, cfg, dtype=jnp.float32):
    if kind == "wavlm":
        return JaxWavLM(JaxWavLMConfig(**cfg), dtype=dtype)
    return JaxTrunk(JaxConfig(**cfg), dtype=dtype)


def _jax_upstream(kind, cfg, params):
    model = _jax_model(kind, cfg)
    apply = jax.jit(lambda v, w, n: model.apply(v, w, n, deterministic=True))
    return JaxUpstream(name="tiny", params={"params": params},
                       apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                       num_layers=cfg["encoder_layers"] + 1,
                       hidden_size=cfg["encoder_embed_dim"], downsample_rate=STRIDE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each model's JAX tp = 2 forward, and the port's cases on two ranks."""
    rng = np.random.RandomState(0)
    wavs, lens = _batch(3, LENS)
    mesh = jax_make_mesh(dp=4, tp=2)
    jax_out, cases, refusals = {}, [], []
    for name, (kind, cfg) in MODELS.items():
        model = _jax_model(kind, cfg)
        init = jax.jit(lambda k, w, n: model.init(k, w, n, deterministic=True))
        params = init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(
                np.float32), params)
        up = _jax_upstream(kind, cfg, params)
        params_s = jax_shard_params(mesh, up.params)
        rep = NamedSharding(mesh, P())
        hs, h_lens = jax.jit(up.apply_standardized)(
            params_s, jax.device_put(jnp.asarray(wavs), rep),
            jax.device_put(jnp.asarray(lens), rep))
        jax_out[name] = (np.asarray(hs), np.asarray(h_lens))
        sd = (wavlm_state_dict_from_jax(params, WavLMConfig(**cfg)) if kind == "wavlm"
              else trunk_state_dict_from_jax(params, Wav2Vec2Config(**cfg)))
        cases.append((name, kind, cfg, sd, STRIDE, "f32", False, wavs, lens))
        if name != "hubert_post":
            cases.append((name + "_bf16", kind, cfg, sd, STRIDE, "bf16", True, wavs, lens))
        options = [{"quantize": True, "flash": True}]
        options += ([{"quantize": True, "flash": True, "wavlm_fuse": True}] if kind == "wavlm"
                    else [{"quantize": True, "flash": True, "full_fuse": True},
                          {"quantize": True, "flash": True, "qkv_fuse": True}]
                    if name == "hubert_pre" else [])
        refusals += [(kind, cfg, sd, o) for o in options]
    ranks = distributed.spawn(tp_rank, 2, cases, refusals, threads=1,
                              tmp_dir=str(tmp_path_factory.mktemp("tp")))
    return jax_out, ranks


@pytest.mark.parametrize("name", list(MODELS))
def test_tp2_f32_matches_jax_tp2(runs, name):
    """Each rank's tp = 2 forward (two of the four heads, half the FFN
    columns, all-reduced out-projections) equals JAX's tp = 2 forward."""
    jax_out, ranks = runs
    want, want_lens = jax_out[name]
    for out in ranks:
        got, got_lens, _, heads = out[name]
        assert heads == 2
        np.testing.assert_array_equal(got_lens.numpy(), want_lens)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name,kernel", [("hubert_pre", "K7"), ("wavlm", "K9")])
def test_tp2_bf16_flash_runs_the_attention_kernel_on_local_heads(runs, name, kernel):
    """bf16 with flash: every layer's attention goes through its kernel's
    wrapper (K7, WavLM's K9) with the rank's two heads; per-layer cosine
    >= 0.999 against JAX's f32 tp = 2 forward."""
    jax_out, ranks = runs
    want, want_lens = jax_out[name]
    for out in ranks:
        got, got_lens, seen, _ = out[name + "_bf16"]
        assert seen == [(kernel, 2)] * 2
        np.testing.assert_array_equal(got_lens.numpy(), want_lens)
        assert min(_layer_cosines(got.numpy(), want, want_lens)) >= 0.999


def test_int8_and_fused_options_raise_under_tp(runs):
    """quantize=True and the fused-block options raise a ValueError naming
    the reason when the model is sharded."""
    _, ranks = runs
    for out in ranks:
        assert "row scale of a sharded row" in out[str({"quantize": True, "flash": True})]
        for option in ("full_fuse", "qkv_fuse", "wavlm_fuse"):
            message = out[str({"quantize": True, "flash": True, option: True})]
            assert message.startswith(f"{option} cannot take effect under tp > 1")
