"""Time-sharded extraction of the port (`sequence_sharded_extraction` over
spawned gloo ranks on the CPU: sp = 2 on two ranks, sp = 4 and dp = 2 x
sp = 2 on four) against the JAX package's `sequence_sharded_extraction` at
make_mesh(dp=2, tp=1, sp=4) on its 8-device virtual mesh
(tests/test_parallel.py:173-198), atol 1e-3 as there.

Tiny trunks as tests/test_torch_parallel_tp.py's (three conv layers of 64
channels at a total stride of 20, two encoder layers at C 128, pos-conv k
16): HuBERT post-LN with the group-norm extractor (its statistics
all-reduced), HuBERT pre-LN with the layer-norm extractor, WavLM, and data2vec (post-LN,
its depth-5 pos-conv stack of k 4), in f32.
3,200 samples give T' = 159 frames (divisible by neither 2 nor 4: the last
run is ragged) and 160 standardized ones; the lengths are ragged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3prl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s3prl_tpu.parallel.mesh import sequence_sharded_extraction as jax_sp_extraction
from s3prl_tpu_torch.parallel import distributed
from s3prl_tpu_torch.parallel.mesh import Mesh, sequence_sharded_extraction, time_shards
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMConfig
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import trunk_state_dict_from_jax, wavlm_state_dict_from_jax
from test_torch_parallel_tp import MODELS, STRIDE, _jax_model, _jax_upstream
from test_torch_port_slice import _batch
from torch_parallel_workers import sp_rank, trunk_upstream

LENS = [3200, 2333]
# and data2vec's depth-5 pos-conv stack (k 4, post-LN): its halo is five blocks' k // 2
SP_MODELS = dict(MODELS, data2vec=("w2v2", dict(
    MODELS["hubert_post"][1], extractor_mode="layer_norm", conv_pos=20, pos_conv_depth=5,
    normalize=True)))
MESHES = {2: [{"dp": 1, "sp": 2}], 4: [{"dp": 1, "sp": 4}, {"dp": 2, "sp": 2}]}
WORLD = {str(kw): n for n, meshes in MESHES.items() for kw in meshes}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(1)
    wavs, lens = _batch(5, LENS)
    mesh = jax_make_mesh(dp=2, tp=1, sp=4)
    jax_out, cases = {}, []
    for name, (kind, cfg) in SP_MODELS.items():
        model = _jax_model(kind, cfg)
        init = jax.jit(lambda k, w, n: model.init(k, w, n, deterministic=True))
        params = init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(
                np.float32), params)
        hs, h_lens = jax_sp_extraction(_jax_upstream(kind, cfg, params), mesh,
                                       jnp.asarray(wavs), jnp.asarray(lens))
        jax_out[name] = (np.asarray(hs), np.asarray(h_lens))
        sd = (wavlm_state_dict_from_jax(params, WavLMConfig(**cfg)) if kind == "wavlm"
              else trunk_state_dict_from_jax(params, Wav2Vec2Config(**cfg)))
        cases.append((name, kind, cfg, sd, STRIDE, "f32", wavs, lens))
    ranks = {n: distributed.spawn(sp_rank, n, MESHES[n], cases, threads=1,
                                  tmp_dir=str(tmp_path_factory.mktemp(f"sp{n}")))
             for n in MESHES}
    return jax_out, ranks, cases


@pytest.mark.parametrize("mesh", list(WORLD))
@pytest.mark.parametrize("name", list(SP_MODELS))
def test_sp_matches_jax_sequence_sharded_extraction(runs, name, mesh):
    """Each rank's frames gathered over sp (and rows over dp) equal JAX's
    sp = 4 extraction; lengths exactly; each rank held its run of
    ceil(159 / sp) frames, the last run ragged and one frame longer for
    the standardized length."""
    jax_out, ranks, _ = runs
    want, want_lens = jax_out[name]
    sp = int(mesh[-2])
    runs_ = time_shards(159, sp)
    for r, out in enumerate(ranks[WORLD[mesh]]):
        got, got_lens, frames = out[name, mesh]
        np.testing.assert_array_equal(got_lens.numpy(), want_lens)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-4)
        lo, hi = runs_[r % sp]
        assert frames == hi - lo + (r % sp == sp - 1)


def test_time_shards_and_refusals(runs):
    """The runs of ceil(n / sp) frames, the last ragged; a split that would
    leave a rank no frame, flash=True (the card's attention takes Tq = Tk
    only), int8 and a model the sp hooks do not serve raise."""
    _, _, cases = runs
    assert time_shards(159, 4) == [(0, 40), (40, 80), (80, 120), (120, 159)]
    with pytest.raises(ValueError, match="cannot be split over sp=4"):
        time_shards(5, 4)
    mesh = Mesh(np.arange(2).reshape(1, 1, 2), ("dp", "tp", "sp"), {},
                {"dp": 0, "tp": 0, "sp": 0})
    name, kind, cfg, sd, stride, _, wavs, lens = cases[0]
    for options, error, match in (({"dtype": "bf16", "flash": True}, ValueError,
                                   "flash=True cannot take effect under sp > 1"),
                                  ({"dtype": "bf16", "flash": True, "quantize": True},
                                   ValueError, "cannot take effect under sp > 1")):
        up = trunk_upstream(kind, cfg, sd, stride, **options)
        with pytest.raises(error, match=match):
            sequence_sharded_extraction(up, mesh, wavs, lens)
    model = Wav2Vec2Trunk(Wav2Vec2Config(**dict(cfg, layer_type="conformer")), device="meta")
    with pytest.raises(NotImplementedError, match="Queue 2, sp beyond these trunks"):
        sequence_sharded_extraction(Upstream("c", model, 3, 128, stride), mesh,
                                    torch.zeros(2, 3200), torch.tensor([3200, 3200]))
