"""Rank bodies of the port's parallel tests (tests/test_torch_parallel_*.py).

`s3prl_tpu_torch.parallel.distributed.spawn` runs them in gloo ranks on the
CPU; they import torch, numpy and the port only (no JAX), and return what
the tests compare with the JAX package's mesh and with one process.
"""

from __future__ import annotations

import numpy as np
import torch

import s3prl_tpu_torch.models.transformer as port_transformer
from s3prl_tpu_torch.parallel import collectives as cl
from s3prl_tpu_torch.parallel import distributed
from s3prl_tpu_torch.parallel.mesh import (gather_hidden_states, make_mesh, replicate,
                                           sequence_sharded_extraction, shard_batch,
                                           shard_params)
from s3prl_tpu_torch.upstream.base import Upstream


def trunk_upstream(kind: str, cfg: dict, state_dict: dict, stride: int, dtype="f32",
                   flash=False, quantize=False, **options) -> Upstream:
    """A tiny trunk ("w2v2" or "wavlm") on the CPU from `state_dict`."""
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
    from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    config, cls = ((WavLMConfig, WavLMModel) if kind == "wavlm"
                   else (Wav2Vec2Config, Wav2Vec2Trunk))
    c = config(**cfg)
    model = cls(c, dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype],
                use_flash=flash, quantize=quantize, device="meta", **options)
    model.to_empty(device="cpu")
    model.load_state_dict(state_dict)
    return Upstream("tiny", model.eval(), c.encoder_layers + 1, c.encoder_embed_dim, stride)


# -- _mesh ----------------------------------------------------------------------


def mesh_rank(n_items: int, batch_size: int) -> dict:
    """make_mesh's shapes and refusal, shard_batch, replicate, the ragged
    gather, the leader test and the barrier, and the index lists the
    loader deals this rank."""
    from s3prl_tpu_torch.data.loader import DataLoader
    from s3prl_tpu_torch.data.sampler import FixedBatchSizeBatchSampler

    me = distributed.rank()
    out = {"leader": distributed.is_leader_process(), "world": distributed.world_size()}
    shapes = {}
    for kw in ({}, {"tp": 2}, {"dp": 1, "sp": 2}):
        mesh = make_mesh(**kw)
        shapes[str(kw)] = (mesh.shape, mesh.coords)
    out["shapes"] = shapes
    try:
        make_mesh(dp=3, tp=3)
    except AssertionError as e:
        out["refusal"] = str(e)
    mesh = make_mesh()
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "names": [f"u{i}" for i in range(8)],
             "scalar": 5}
    out["rows"] = shard_batch(mesh, batch)
    try:
        shard_batch(mesh, {"x": np.zeros((3, 2))})
    except ValueError as e:
        out["indivisible"] = str(e)
    t = torch.full((3,), float(me))
    out["replicated"] = replicate(mesh, t).tolist()
    out["ragged"] = cl.gather_time(torch.arange(2 + me).float()[None], mesh.group("dp")).tolist()
    distributed.barrier("unit-test")
    out["serving"] = serving(mesh)
    data = [{"x": np.full(1, i, np.float32)} for i in range(n_items)]
    loader = DataLoader(data, FixedBatchSizeBatchSampler(n_items, batch_size), prefetch=0)
    out["dealt"] = [b["x"][:, 0].astype(int).tolist() for b in loader]
    return out


def serving(mesh) -> dict:
    """dp-sharded serving on a tiny trunk from seed 0: `apply_standardized`
    and `apply_weighted` of the global batch, whole and with `mesh` (this
    rank's rows)."""
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    cfg = Wav2Vec2Config(
        extractor_mode="layer_norm", conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, layer_norm_first=True,
        normalize=True, dropout=0.0, attention_dropout=0.0, dropout_input=0.0)
    up = _trunk_upstream("tiny", cfg, seed=0, device="cpu")
    wavs = np.random.RandomState(0).randn(4, 3200).astype(np.float32)
    lens = np.asarray([3200, 2000, 3200, 1000])
    w = torch.softmax(torch.arange(3.0), 0)
    return {"whole": up.apply_standardized(wavs, lens),
            "rows": up.apply_standardized(wavs, lens, mesh=mesh),
            "weighted": up.apply_weighted(w, wavs, lens),
            "weighted_rows": up.apply_weighted(w, wavs, lens, mesh=mesh)}


# -- _tp -------------------------------------------------------------------------


def _spy_attention(seen: list) -> None:
    """Records the heads each K7 / K9 wrapper call gets (the names the
    encoder layers call)."""
    k7, k9 = port_transformer.fused_qkv_attention, port_transformer.gated_bias_attention

    def fused_qkv_attention(qkv, kv_lens, num_heads):
        seen.append(("K7", num_heads))
        return k7(qkv, kv_lens, num_heads)

    def gated_bias_attention(q, k, v, pos_bias, gate, kv_lens):
        seen.append(("K9", q.shape[1]))
        return k9(q, k, v, pos_bias, gate, kv_lens)

    port_transformer.fused_qkv_attention = fused_qkv_attention
    port_transformer.gated_bias_attention = gated_bias_attention


def tp_rank(cases: list, refusals: list) -> dict:
    """Each case (name, kind, cfg, state_dict, stride, dtype, flash, wavs,
    lens) extracted at tp = world; each refusal (kind, cfg, state_dict,
    options) loaded and sharded: its ValueError's message."""
    seen: list = []
    _spy_attention(seen)
    mesh = make_mesh(tp=distributed.world_size())
    out = {}
    for name, kind, cfg, sd, stride, dtype, flash, wavs, lens in cases:
        up = trunk_upstream(kind, cfg, sd, stride, dtype, flash)
        shard_params(mesh, up.model)
        del seen[:]
        hs, h_lens = up.apply_standardized(wavs, lens)
        out[name] = (hs.float(), h_lens, list(seen), up.model.encoder.layers[0].num_heads)
    for kind, cfg, sd, options in refusals:
        up = trunk_upstream(kind, cfg, sd, 20, **options)
        try:
            shard_params(mesh, up.model)
            out[str(options)] = None
        except ValueError as e:
            out[str(options)] = str(e)
    return out


# -- _sp -------------------------------------------------------------------------


def sp_rank(meshes: list, cases: list) -> dict:
    """Each case (name, kind, cfg, state_dict, stride, dtype, wavs, lens)
    through `sequence_sharded_extraction` on each mesh (kwargs of
    make_mesh): the gathered hidden states, the lengths and this rank's
    frames."""
    out = {}
    for kw in meshes:
        mesh = make_mesh(**kw)
        for name, kind, cfg, sd, stride, dtype, wavs, lens in cases:
            up = trunk_upstream(kind, cfg, sd, stride, dtype)
            hs, h_lens = sequence_sharded_extraction(up, mesh, wavs, lens)
            whole = gather_hidden_states(mesh, hs)
            out[name, str(kw)] = (whole.float(), cl.gather_rows(h_lens, mesh.group("dp")),
                                  hs.shape[2])
    return out


# -- _train ----------------------------------------------------------------------


def _head_and_task(kind: str, up):
    """The probe and task of a `make_trainer` kind."""
    from s3prl_tpu_torch.nn import heads
    from s3prl_tpu_torch.nn.speaker import SapSpeakerHead, SuperbXvector
    from s3prl_tpu_torch.nn.upstream import UpstreamDownstreamModel
    from s3prl_tpu_torch.task import FrameClassificationTask, UtteranceClassificationTask
    from s3prl_tpu_torch.task.enhancement import EnhancementTask
    from s3prl_tpu_torch.task.speaker_verification import (Ge2eVerificationTask,
                                                           SpeakerVerificationTask)

    def model(head):
        return UpstreamDownstreamModel(head, up.num_layers)

    C = up.hidden_size
    if kind == "utterance":
        return UtteranceClassificationTask(model(heads.UtteranceLevel(C, 4, (16,))), 4)
    if kind in ("frame", "convbank"):
        head = (heads.FrameLevel(C, 5, (16,)) if kind == "frame"
                else heads.ConvBankHead(C, 5, dropout=0.3))
        return FrameClassificationTask(model(head), 5)
    if kind == "speaker":
        return SpeakerVerificationTask(model(SuperbXvector(C, 8, 8, 16)), num_speakers=4)
    if kind == "ge2e":
        return Ge2eVerificationTask(model(SapSpeakerHead(C, 8)), utts_per_speaker=2)
    assert kind == "enhancement", kind
    return EnhancementTask(model(heads.RNNEncoder(
        C, output_size=257, hidden_size=16, num_layers=1, bidirectional=True, dropout=0.1,
        proj_size=16, carry_padding=True)))


def make_trainer(spec: dict, mesh=None):
    """A Trainer of the port on the fbank upstream (CPU) from `spec`:
    "head" ("utterance": UtteranceLevel(4, (16,)) and the utterance task;
    "frame": FrameLevel(5, (16,)), "convbank": ConvBankHead(5, dropout
    0.3), each with the frame task; "speaker": an 8-wide x-vector and the
    AM-softmax task over 4 speakers; "ge2e": an 8-wide SAP head and the
    GE2E task, 2 utterances a speaker; "enhancement": a 16-wide BLSTM mask
    head and the SE task), "exp_dir", "config" (TrainerConfig keywords),
    "start" (the probe's state_dict, or None: the trainer's seeded init)."""
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.train.trainer import Trainer, TrainerConfig

    up = hub.load("fbank", device="cpu")
    task = _head_and_task(spec["head"], up)
    trainer = Trainer(up, task, spec["exp_dir"], TrainerConfig(**spec["config"]), mesh=mesh)
    trainer.init(resume=False)
    if spec.get("start") is not None:
        trainer.task.module.load_state_dict(spec["start"])
    return trainer


def _state(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.task.module.state_dict().items()}


def pair_mesh(size: int):
    """This rank's mesh among consecutive runs of `size` ranks of the world
    (dp = size each)."""
    world = distributed.world_size()
    meshes = [make_mesh(ranks=range(lo, lo + size)) for lo in range(0, world, size)]
    return next(m for m in meshes if m is not None)


def train_rank(runs: list, loaders: dict) -> dict:
    """Each run (name, spec, dp, global batches): `make_trainer` on a mesh
    of dp ranks (`pair_mesh`), then `Trainer.train_step` on each batch: the
    losses, the gradient norms and the probe's final state; each of
    `loaders` (name: the arguments of `loader_rank`) under its name."""
    out = {name: loader_rank(*args) for name, args in loaders.items()}
    for name, spec, dp, batches in runs:
        trainer = make_trainer(spec, pair_mesh(dp))
        steps = [trainer.train_step(b) for b in batches]
        out[name] = ([float(l) for l, _, _ in steps], [float(g) for _, _, g in steps],
                     _state(trainer))
    return out


def collate(items: list, buckets) -> dict:
    """The recipes' collate: `pad_collate`, and an SE / SS batch's sources
    [B, T, S] turned to [B, S, T] (problem/enhancement.py)."""
    from s3prl_tpu_torch.data.collate import pad_collate

    batch = pad_collate(items, buckets)
    if "sources" in batch:
        batch["sources"] = np.transpose(batch["sources"], (0, 2, 1))
    return batch


def loader_rank(spec: dict, items_by_rank: list, buckets, tp: int = 1) -> dict:
    """`Trainer.train` for one step on a DataLoader built as the recipes
    build their train loaders (``distribute=True``: dealt over the world)
    whose batches hold items_by_rank[d] each, padded to its own bucket, on
    a mesh of dp = len(items_by_rank) (tp = 1: consecutive runs of dp ranks
    of the world, `pair_mesh`; else dp x tp over the world): the padded
    lengths of the batches the loader deals this rank after the step, the
    step and the probe's final state."""
    from s3prl_tpu_torch.data.loader import DataLoader

    dp = len(items_by_rank)
    mesh = pair_mesh(dp) if tp == 1 else make_mesh(dp=dp, tp=tp)
    trainer = make_trainer(spec, mesh)
    items = [it for part in items_by_rank for it in part]
    offsets = np.cumsum([0] + [len(part) for part in items_by_rank])
    sampler = [list(range(offsets[r], offsets[r + 1])) for r in range(dp)]
    loader = DataLoader(items, sampler, lambda xs: collate(xs, buckets), prefetch=0)
    trainer.cfg.total_steps = 1
    trainer.train(loader)
    padded = [b["x"].shape[1] for b in loader]
    return {"padded": padded, "step": trainer.step, "state": _state(trainer)}


# -- the card ----------------------------------------------------------------------


def card_dp_rank(batch: dict, steps: int = 2, groups: int = 1) -> dict:
    """On the card (ranks share card 0 over gloo): a tiny int8 HuBERT-Large-
    style trunk (conv0 at the kernel's 512 channels, head dim 64) under a
    Trainer at dp = world, `steps` train_steps on the global batch: each
    step's wrapper launch counts on this rank and loss, and the probe's
    final state. One process with ``groups`` > 1 runs its frozen upstream
    on that many row groups, as the dp ranks do (the stock bf16 ops around
    the kernels pick their algorithms by batch shape)."""
    from s3prl_tpu_torch.kernels import wrappers
    from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from s3prl_tpu_torch.nn import UpstreamDownstreamModel, UtteranceLevel
    from s3prl_tpu_torch.task import UtteranceClassificationTask
    from s3prl_tpu_torch.train import Trainer, TrainerConfig
    from s3prl_tpu_torch.upstream.registry import _trunk_upstream

    cfg = Wav2Vec2Config(
        extractor_mode="layer_norm", conv_feature_layers=((512, 10, 5), (64, 3, 2), (64, 2, 2)),
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4, layer_norm_first=True,
        normalize=True)
    up = _trunk_upstream("tiny", cfg, dtype=torch.bfloat16, flash=True, quantize=True, seed=3,
                         device="cuda")
    task = UtteranceClassificationTask(
        UpstreamDownstreamModel(UtteranceLevel(128, 4, (16,)), up.num_layers), 4)
    import tempfile

    trainer = Trainer(up, task, tempfile.mkdtemp(), TrainerConfig(
        total_steps=steps, tensorboard=False, optimizer={"name": "Adam", "lr": 1e-3}))
    trainer.init(resume=False)
    launches, losses = [], []
    for _ in range(steps):
        for w in wrappers():
            w.launches = 0
        if groups == 1:
            loss, _, _ = trainer.train_step(batch)
        else:
            rows = len(batch["x"]) // groups
            parts = [up(batch["x"][i:i + rows], batch["x_len"][i:i + rows])
                     for i in range(0, len(batch["x"]), rows)]
            loss, _, _ = trainer.probe_step(torch.cat([h for h, _ in parts], 1),
                                            torch.cat([n for _, n in parts]), batch)
            trainer.step += 1
        torch.cuda.synchronize()
        launches.append([w.launches for w in wrappers()])
        losses.append(float(loss))
    return {"launches": launches, "losses": losses, "dp": trainer.dp,
            "state": {k: v.detach().cpu() for k, v in trainer.task.module.state_dict().items()}}
