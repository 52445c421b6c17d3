"""Data parallelism of the port's Trainer (spawned gloo ranks on the CPU)
against the JAX package's mesh Trainer and against one process.

- As tests/test_mesh_training.py:36-66 sets them up (fbank, UtteranceLevel
  (4, (16,)), B = 8, 3 steps, Adam 1e-4, clip 1): the port at dp = 2 and
  dp = 4 (`train_step` on the global batch) against JAX's dp = 8 mesh
  Trainer and its single-device one, the port's probe starting from JAX's
  initial params: losses at rtol 1e-4.
- Port against port (one process, dp = 1): a frame probe over ragged
  lengths (its loss normalised by the global batch's valid frames, where a
  mean of the ranks' means is off), a ConvBankHead probe with dropout 0.3
  in train mode (the ranks draw the global batch's masks), two steps each;
  the AM-softmax speaker task and GE2E, whose losses read parameters of
  their own besides the module's rows (the weight, the scale and bias),
  with SGD and no effective clip so that a gradient's scale shows, two
  steps each; `Trainer.train` on a loader built as the recipes build it
  (dealt over the world) at dp = 2 x tp = 2, whose two dp ranks' batches
  are padded to different buckets (16,000 and 32,000 samples), and at
  dp = 2 on the SE task (its loss reads the batch's waves), each against
  one step on their union: losses and gradient norms at rtol 1e-5, the
  probe's weights at max abs 5e-4.
"""

import numpy as np
import pytest
import torch

import jax

from s3prl_tpu import hub as jax_hub
from s3prl_tpu.nn.heads import UtteranceLevel as JaxUtteranceLevel
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s3prl_tpu.task.utterance_classification import UtteranceClassificationTask as JaxTask
from s3prl_tpu.train.trainer import Trainer as JaxTrainer
from s3prl_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from s3prl_tpu_torch.data.collate import Buckets
from s3prl_tpu_torch.parallel import distributed
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from torch_parallel_workers import collate, make_trainer, train_rank

CONFIG = dict(total_steps=3, log_step=10, eval_step=10, save_step=10, tensorboard=False)
SGD = dict(CONFIG, gradient_clipping=1000.0, optimizer={"name": "SGD", "lr": 0.5})
BUCKETS = Buckets.linear(16000, 32000)


def _jax_runs(tmp_path, batch):
    """JAX's single-device and dp = 8 mesh losses (test_mesh_training.py's
    loop), and the probe's initial params."""
    losses, start = {}, None
    for tag, mesh in (("single", None), ("mesh", jax_make_mesh(dp=8, tp=1))):
        upstream = jax_hub.load("fbank")
        module = JaxModel(downstream=JaxUtteranceLevel(output_size=4, hidden_sizes=(16,)),
                          num_layers=upstream.num_layers)
        trainer = JaxTrainer(upstream, JaxTask(module, num_classes=4), tmp_path / tag,
                             JaxTrainerConfig(**dict(CONFIG, tensorboard=False)), mesh=mesh)
        trainer.init(batch, resume=False)
        if start is None:
            start = probe_state_dict_from_jax(jax.device_get(trainer.params))
        run = []
        for step in range(3):
            device = trainer._place_batch(
                {k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
            key = jax.random.fold_in(trainer._root_key, step + 1)
            trainer.params, trainer.opt_state, loss, _, _ = trainer._train_step(
                trainer.params, trainer.opt_state, trainer.upstream.params, device, key)
            run.append(float(loss))
        losses[tag] = run
    return losses, start


def _ragged_batches(n=2, B=4, seed=3):
    """Frame-labelled batches over ragged lengths (labels -100 past each
    utterance's frames, as the frame probes' collate pads them)."""
    rng = np.random.RandomState(seed)
    lens = np.asarray([16000, 9000, 3999, 12000], np.int32)
    out = []
    for _ in range(n):
        x = (rng.randn(B, 16000) * (np.arange(16000) < lens[:, None])).astype(np.float32)
        frames = (lens - 1) // 160 + 1
        labels = rng.randint(0, 5, (B, 100)).astype(np.int32)
        labels[np.arange(100)[None, :] >= frames[:, None]] = -100
        out.append({"x": x, "x_len": lens, "frame_labels": labels,
                    "unique_name": [f"u{i}" for i in range(B)]})
    return out


def _loader_items(seed=4, sources=False):
    """Two dp ranks' items: rank 0's pad to 16,000 samples, rank 1's to
    32,000; class labels, or with `sources` SE's clean waves."""
    rng = np.random.RandomState(seed)
    lens = ([16000, 12000], [20000, 7000])
    out = []
    for part in lens:
        items = []
        for i, n in enumerate(part):
            item = {"x": rng.randn(n).astype(np.float32)}
            if sources:
                item["sources"] = rng.randn(n, 1).astype(np.float32)
            else:
                item["class_id"] = np.int32(i % 4)
            items.append(item)
        out.append(items)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(8, 16000).astype(np.float32), "x_len": np.full(8, 16000, np.int32),
             "class_id": (np.arange(8) % 4).astype(np.int32)}
    jax_losses, start = _jax_runs(tmp, batch)
    mesh_spec = {"head": "utterance", "config": CONFIG, "start": start}
    ragged = _ragged_batches()
    port_runs = {"mesh": (mesh_spec, [batch] * 3),
                 "frame": ({"head": "frame", "config": CONFIG}, ragged),
                 "dropout": ({"head": "convbank", "config": CONFIG}, ragged),
                 "speaker": ({"head": "speaker", "config": SGD}, [batch] * 2),
                 "ge2e": ({"head": "ge2e", "config": SGD}, [batch] * 2)}
    loaders = {"loader": ({"head": "utterance", "config": CONFIG}, _loader_items(), 2),
               "enhancement": ({"head": "enhancement", "config": CONFIG},
                               _loader_items(sources=True), 1)}
    # one group of four ranks: dp = 4 over all, dp = 2 over ranks (0, 1) and (2, 3)
    jobs = [(f"{name}{dp}", dict(spec, exp_dir=str(tmp / f"{name}{dp}")), dp, batches)
            for name, (spec, batches) in port_runs.items()
            for dp in ((2, 4) if name == "mesh" else (2,))]
    ranks = distributed.spawn(
        train_rank, 4, jobs,
        {name: (dict(spec, exp_dir=str(tmp / name)), items, BUCKETS, tp)
         for name, (spec, items, tp) in loaders.items()},
        threads=1, tmp_dir=str(tmp))
    one = {}
    for name, (spec, batches) in port_runs.items():
        trainer = make_trainer(dict(spec, exp_dir=str(tmp / f"{name}1")))
        steps = [trainer.train_step(b) for b in batches]
        one[name] = ([float(l) for l, _, _ in steps], [float(g) for _, _, g in steps],
                     trainer.task.module.state_dict())
    for name, (spec, items, _) in loaders.items():
        trainer = make_trainer(dict(spec, exp_dir=str(tmp / f"{name}-union")))
        trainer.train_step(collate([it for part in items for it in part], BUCKETS))
        one[name] = trainer.task.module.state_dict()
    return jax_losses, ranks, one


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_trainer_matches_jax_mesh_trainer(runs, dp):
    """The port at dp = 2 / 4 gives JAX's dp = 8 and single-device losses
    (and descends), identical on every rank."""
    jax_losses, ranks, one = runs
    np.testing.assert_allclose(jax_losses["mesh"], jax_losses["single"], rtol=1e-4)
    for out in ranks:
        losses = out[f"mesh{dp}"][0]
        np.testing.assert_allclose(losses, jax_losses["mesh"], rtol=1e-4)
        assert losses == ranks[0][f"mesh{dp}"][0] and losses[-1] < losses[0]
        _same_training(out[f"mesh{dp}"], *one["mesh"])


def _same_training(out, want_losses, want_norms, want_state):
    """The losses, the gradient norms (what the clip and the finite guard
    read) and the final probe of a run against one process's."""
    losses, norms, state = out
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    for k, v in want_state.items():
        assert float((state[k] - v).abs().max()) <= 5e-4, k


@pytest.mark.parametrize("name", ["frame", "dropout"])
def test_dp2_global_loss_over_ragged_frames(runs, name):
    """A frame probe whose loss is normalised by the global batch's valid
    frames (2,000 + 1,163 on the ranks: a mean of their means differs),
    with and without dropout in train mode: dp = 2 equals one process in
    loss and updated probe weights."""
    _, ranks, one = runs
    for out in ranks:
        _same_training(out[f"{name}2"], *one[name])
    local = [int(((b["frame_labels"] >= 0)[2 * r:2 * r + 2]).sum())
             for b in _ragged_batches()[:1] for r in range(2)]
    assert local[0] != local[1]


@pytest.mark.parametrize("name", ["speaker", "ge2e"])
def test_dp2_loss_side_parameters_take_the_global_gradient(runs, name):
    """AM-softmax's weight and GE2E's scale and bias, which the loss reads
    besides the module's rows, take the global loss's gradient once (not
    once a rank): dp = 2 equals one process in loss, gradient norm and
    every updated weight, these included, under SGD."""
    _, ranks, one = runs
    for out in ranks:
        _same_training(out[f"{name}2"], *one[name])
    moved = ("am_weight",) if name == "speaker" else ("ge2e_w", "ge2e_b")
    state = ranks[0][f"{name}2"][2]
    for k in moved:
        assert k in one[name][2] and float((state[k] - one[name][2][k]).abs().max()) <= 5e-4


def test_dp2_loader_pads_to_the_group_longest_bucket(runs):
    """`Trainer.train` at dp = 2 x tp = 2 on a loader dealt over the world
    as the recipes build it: the Trainer deals it over dp (both tp ranks
    of a dp index take its batch: ranks 0 / 1 the one padded to 16,000
    samples, ranks 2 / 3 the one padded to 32,000), pads the first to
    32,000 and takes the step of their union on every rank."""
    _, ranks, one = runs
    for r, out in enumerate(ranks):
        res = out["loader"]
        assert res["padded"] == [[16000], [32000]][r // 2] and res["step"] == 1
        for k, v in one["loader"].items():
            assert float((res["state"][k] - v).abs().max()) <= 5e-4, k
    for out in ranks[1:]:
        for k, v in ranks[0]["loader"]["state"].items():
            assert torch.equal(v, out["loader"]["state"][k]), k


def test_dp2_trains_enhancement_on_the_global_waves(runs):
    """The SE task, whose loss reads the batch's waves and clean sources,
    takes under `Trainer.train` at dp = 2 the step of the two ranks'
    batches' union."""
    _, ranks, one = runs
    for out in ranks:
        res = out["enhancement"]
        assert res["step"] == 1
        for k, v in one["enhancement"].items():
            assert float((res["state"][k] - v).abs().max()) <= 5e-4, k
