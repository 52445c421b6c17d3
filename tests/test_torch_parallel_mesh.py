"""The port's rank mesh (s3prl_tpu_torch.parallel) against the JAX package's
(CPU): make_mesh's shapes and assert, the tp rules on a tiny HuBERT and
WavLM state_dict (heads split within q, k and v), the runtime helpers in
one process, and in a spawned group of two gloo ranks (torch threads 1, a
``file://`` store in a temporary directory) the layouts, the ragged gather,
dp-sharded serving and the loader's deal against the JAX
`DistributedBatchSamplerWrapper`.
"""

import numpy as np
import pytest
import torch

import jax

from s3prl_tpu.data.sampler import DistributedBatchSamplerWrapper as JaxDealer
from s3prl_tpu.data.sampler import FixedBatchSizeBatchSampler as JaxSampler
from s3prl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s3prl_tpu.parallel.mesh import param_shardings
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.parallel import distributed
from s3prl_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_state_dict, tp_rule
from torch_parallel_workers import mesh_rank

TINY = dict(conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)), encoder_layers=2,
            encoder_embed_dim=128, encoder_ffn_embed_dim=256, encoder_attention_heads=4,
            conv_pos=16, conv_pos_groups=4, extractor_mode="layer_norm", layer_norm_first=True)
N_ITEMS, BATCH = 23, 2  # 12 batches; one of a single item


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return distributed.spawn(mesh_rank, 2, N_ITEMS, BATCH, threads=1,
                             tmp_dir=str(tmp_path_factory.mktemp("mesh")))


def test_make_mesh_one_process():
    """One process: every axis of one rank, and JAX's assert on a mesh the
    ranks cannot fill."""
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.group("dp") is None
    assert make_mesh(dp=None, tp=1, sp=1).shape == {"dp": 1, "tp": 1}
    for kw in ({"dp": 2}, {"tp": 2}, {"dp": 1, "tp": 1, "sp": 2}):
        with pytest.raises(AssertionError):
            make_mesh(**kw)
    with pytest.raises(AssertionError):
        jax_make_mesh(dp=3, tp=3)


def test_make_mesh_shapes_on_two_ranks(ranks):
    """The JAX arrangement on 2 ranks: dp over all by default, tp=2 leaves
    dp=1, an sp axis only when sp > 1; each rank's coordinates."""
    for r, out in enumerate(ranks):
        assert out["world"] == 2 and out["leader"] == (r == 0)
        shapes = out["shapes"]
        assert shapes["{}"] == ({"dp": 2, "tp": 1}, {"dp": r, "tp": 0})
        assert shapes["{'tp': 2}"] == ({"dp": 1, "tp": 2}, {"dp": 0, "tp": r})
        assert shapes["{'dp': 1, 'sp': 2}"] == ({"dp": 1, "tp": 1, "sp": 2},
                                                {"dp": 0, "tp": 0, "sp": r})
        assert "dp(3) * tp(3) * sp(1) != 2 ranks" in out["refusal"]
    assert jax_make_mesh(dp=4, tp=2).shape == {"dp": 4, "tp": 2}


def test_shard_batch_replicate_and_ragged_gather(ranks):
    """shard_batch keeps this dp rank's rows (arrays and per-row lists; the
    rest as given) and raises JAX's message on an indivisible batch;
    replicate broadcasts rank 0's tensor; a ragged gather puts 2 + 3 frames
    together in rank order."""
    x = np.arange(8 * 3).reshape(8, 3)
    for r, out in enumerate(ranks):
        rows = out["rows"]
        np.testing.assert_array_equal(rows["x"], x[4 * r:4 * r + 4])
        assert rows["names"] == [f"u{i}" for i in range(4 * r, 4 * r + 4)]
        assert rows["scalar"] == 5
        assert "train batch size 3 not divisible by dp=2" in out["indivisible"]
        assert out["replicated"] == [0.0, 0.0, 0.0]
        assert out["ragged"] == [[0.0, 1.0, 0.0, 1.0, 2.0]]


def test_dp_sharded_serving(ranks):
    """`apply_standardized` / `apply_weighted` with a dp = 2 mesh: each rank
    extracts its two rows of the global batch (the padded length, and so
    the frames, the global batch's), equal to the whole batch's forward
    (tests/test_mesh_training.py:68-99's twin, its 5e-4 bound)."""
    for r, out in enumerate(ranks):
        serving = out["serving"]
        (whole, whole_lens), (rows, rows_lens) = serving["whole"], serving["rows"]
        assert rows.shape == (3, 2, whole.shape[2], 128)
        np.testing.assert_array_equal(rows_lens, whole_lens[2 * r:2 * r + 2])
        np.testing.assert_allclose(rows, whole[:, 2 * r:2 * r + 2], atol=5e-4, rtol=1e-5)
        (weighted, lens), (weighted_rows, lens_rows) = serving["weighted"], \
            serving["weighted_rows"]
        np.testing.assert_array_equal(lens_rows, lens[2 * r:2 * r + 2])
        np.testing.assert_allclose(weighted_rows, weighted[:, 2 * r:2 * r + 2], atol=5e-4,
                                   rtol=1e-5)


def test_loader_deals_as_the_jax_wrapper(ranks):
    """Under a group of two ranks the port's DataLoader deals each rank the
    index lists JAX's DistributedBatchSamplerWrapper deals at
    world_size=2 (12 batches, the last of one item)."""
    for r, out in enumerate(ranks):
        want = list(JaxDealer(JaxSampler(N_ITEMS, BATCH), 2, r))
        assert out["dealt"] == [list(b) for b in want] and len(want) == 6


def test_runtime_helpers_one_process():
    """initialize is a no-op without RANK / WORLD_SIZE and arguments, the
    process leads, the barrier returns."""
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.is_leader_process() and distributed.world_size() == 1
    distributed.barrier("unit-test")


def _fake_mesh(rank, tp=2):
    return Mesh(np.arange(tp).reshape(1, tp), ("dp", "tp"), {}, {"dp": 0, "tp": rank})


@pytest.mark.parametrize("kind", ["hubert", "wavlm"])
def test_tp_rules_split_heads_within_q_k_v(kind):
    """The rules on a tiny HuBERT / WavLM state_dict: q, k, v and fc1
    column-wise, out_proj and fc2 row-wise, the rest (WavLM's grep_linear,
    grep_a and bucket table, every bias after a row-parallel product)
    replicated, as the JAX rules place the same leaves; a split layer's
    fused qkv_weight holds [q_r; k_r; v_r], rank r's heads of each."""
    if kind == "wavlm":
        cfg = WavLMConfig(**TINY, num_buckets=32, max_distance=80)
        model = WavLMModel(cfg, device="meta")
    else:
        cfg = Wav2Vec2Config(**TINY)
        model = Wav2Vec2Trunk(cfg, device="meta")
    model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=gen)
    sd = model.state_dict()
    sharded = {k for k in sd if tp_rule(k) is not None}
    assert sharded == {f"encoder.layers.{i}.{n}" for i in range(2) for n in (
        "self_attn.q_proj.weight", "self_attn.q_proj.bias", "self_attn.k_proj.weight",
        "self_attn.k_proj.bias", "self_attn.v_proj.weight", "self_attn.v_proj.bias",
        "self_attn.out_proj.weight", "fc1.weight", "fc1.bias", "fc2.weight")}
    if kind == "wavlm":
        assert {k for k in sd if "grep" in k or "relative_attention" in k} - sharded == \
            {k for k in sd if "grep" in k or "relative_attention" in k} != set()
    C, Dh = 128, 32
    for r in range(2):
        local = shard_state_dict(_fake_mesh(r), sd)
        layer = "encoder.layers.1.self_attn"
        for n in "qkv":
            np.testing.assert_array_equal(local[f"{layer}.{n}_proj.weight"],
                                          sd[f"{layer}.{n}_proj.weight"][r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(local[f"{layer}.out_proj.weight"],
                                      sd[f"{layer}.out_proj.weight"][:, r * 64:(r + 1) * 64])
        np.testing.assert_array_equal(local["encoder.layers.0.fc2.weight"],
                                      sd["encoder.layers.0.fc2.weight"][:, r * 128:(r + 1) * 128])
        np.testing.assert_array_equal(local[f"{layer}.out_proj.bias"], sd[f"{layer}.out_proj.bias"])
        split = (WavLMModel if kind == "wavlm" else Wav2Vec2Trunk)(cfg, device="meta")
        split.to_empty(device="cpu")
        for layer_module in split.encoder.layers:
            layer_module.split_tp(None, r, 2)
        split.load_state_dict(local)
        qkv = split.encoder.layers[1].self_attn.qkv_weight.detach()
        heads = slice(r * 2 * Dh, (r + 1) * 2 * Dh)  # heads 2r, 2r + 1 of each of q, k, v
        full = sd[f"{layer}.q_proj.weight"], sd[f"{layer}.k_proj.weight"], \
            sd[f"{layer}.v_proj.weight"]
        np.testing.assert_array_equal(qkv, torch.cat([w[heads] for w in full]))
        assert split.encoder.layers[1].num_heads == 2 and qkv.shape == (3 * C // 2, C)
    # JAX shards the same kinds of leaves (its fused qkv, out_proj, fc1, fc2)
    jax_mesh = jax_make_mesh(dp=4, tp=2)
    toy = {"self_attn": {"qkv": {"kernel": np.ones((8, 24))},
                         "out_proj": {"kernel": np.ones((8, 8)), "bias": np.ones(8)}},
           "fc1": {"kernel": np.ones((8, 32))}, "fc2": {"kernel": np.ones((32, 8))}}
    specs = jax.tree_util.tree_map(lambda s: tuple(s.spec), param_shardings(jax_mesh, {
        "layers": jax.tree_util.tree_map(lambda a: a[None], toy)})["layers"])
    assert specs["self_attn"]["out_proj"]["bias"] == () and specs["fc1"]["kernel"] != ()
