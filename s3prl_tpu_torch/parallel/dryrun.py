"""The multichip dry run (port of ``__graft_entry__.dryrun_multichip``).

`dryrun_multichip(n)` spawns n ranks on a mesh of tp = 2 when n is even
and dp = n / tp: on the cards when the host has any (a card each over
NCCL when it has n, else ranks sharing its cards over gloo, which stages
their tensors through host memory), on the CPU over gloo only on a host
without one (as the JAX one falls back to a virtual CPU mesh); it prints
which. Each rank runs one fwd + bwd + Adam step of a scaled-down HuBERT trunk (4 layers x
256, a three-layer conv stack, the real module graph) + Featurizer +
UtteranceLevel(4, (32,)) with dp batch sharding and the tp rules, on the
trunk's stock path (the kernels refuse grad). The loss is the global
batch's mean cross entropy (the logits dp-gathered), the gradients
averaged over dp (`collectives.gather_rows_for_loss`, `all_reduce_grads`);
the leader prints ``loss=... OK``.

    python -m s3prl_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import collectives as cl
from .distributed import is_leader_process, rank, spawn
from .mesh import make_mesh, shard_batch, shard_params


def dryrun_config():
    """The JAX dry run's trunk (__graft_entry__.py:107-118)."""
    from ..models.wav2vec2 import Wav2Vec2Config

    return Wav2Vec2Config(
        conv_feature_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)), encoder_layers=4,
        encoder_embed_dim=256, encoder_ffn_embed_dim=1024, encoder_attention_heads=4,
        conv_pos=32, conv_pos_groups=8, dropout=0.0, attention_dropout=0.0,
        dropout_input=0.0)


class DryrunModel(nn.Module):
    """trunk -> Featurizer -> UtteranceLevel(4, (32,)) (the JAX ``Model``)."""

    def __init__(self, cfg, device=None):
        from ..models.wav2vec2 import Wav2Vec2Trunk
        from ..nn.heads import UtteranceLevel
        from ..nn.upstream import UpstreamDownstreamModel

        super().__init__()
        self.trunk = Wav2Vec2Trunk(cfg, device=device)
        self.head = UpstreamDownstreamModel(
            UtteranceLevel(cfg.encoder_embed_dim, 4, (32,)), cfg.encoder_layers + 1).to(device)

    def forward(self, wavs, lens):
        hs, feat_lens = self.trunk(wavs, lens)
        return self.head(hs, feat_lens)


def build_model(seed: int = 0, device="cpu") -> DryrunModel:
    """The dry run's model with seeded random weights (the hub's
    initialisers for the trunk, flax's for the probe)."""
    from ..nn.upstream import init_params
    from ..upstream.registry import _init_trunk

    model = DryrunModel(dryrun_config(), device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        _init_trunk(model.trunk, gen)
    init_params(model.head, gen)
    return model.train()


def dryrun_batch(B: int):
    """The JAX dry run's batch: B x 3,200 samples, labels 0..3."""
    wavs = np.random.RandomState(0).randn(B, 3200).astype(np.float32)
    return wavs, np.full((B,), 3200, np.int64), np.arange(B) % 4


def train_step(model: DryrunModel, mesh, wavs, lens, labels, lr: float = 1e-4):
    """One fwd + bwd + Adam step on this rank's rows of the global batch:
    the loss of the dp-gathered logits (the global batch's mean), the
    gradients averaged over dp as the trainer's. Returns the loss (a
    float)."""
    dev = next(model.parameters()).device
    w, ln, y = (torch.as_tensor(a, device=dev) for a in shard_batch(mesh, (wavs, lens, labels)))
    logits = cl.gather_rows_for_loss(model(w, ln), mesh.group("dp"))
    loss = F.cross_entropy(logits.float(), torch.as_tensor(labels, device=dev))
    loss.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    cl.all_reduce_grads(params, mesh.group("dp"))
    opt = torch.optim.Adam(params, lr=lr)
    opt.step()
    return float(loss.detach())


def run(n: int, device: str = "cpu", B=None, ranks=None):
    """The dry run's step on this rank of a mesh of n `ranks` (default: the
    world; one process: n = 1) on the global batch of B rows (default 2 *
    dp, as the JAX one): (loss, the updated state_dict on the CPU). On the
    cards rank r takes card r modulo their count; the step runs in full f32
    (TF32 off for matmuls and convolutions, as the JAX package computes)."""
    if device == "cuda":
        torch.cuda.set_device(rank() % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=n // tp, tp=tp, ranks=ranks)
    model = build_model(device=device)
    shard_params(mesh, model.trunk)
    loss = train_step(model, mesh, *dryrun_batch(B or 2 * (n // tp)))
    assert np.isfinite(loss), loss
    if is_leader_process():
        print(f"dryrun_multichip(n={n}, dp={n // tp}, tp={tp}): loss={loss:.4f} OK", flush=True)
    return loss, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def dryrun_multichip(n: int, threads=None) -> list:
    """Runs the dry run on n spawned ranks (module docstring; `threads`:
    each rank's torch threads); returns each rank's (loss, updated
    state_dict) (the tp ranks' trunk shards)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= n:
        device, backend, where = "cuda", "nccl", f"{n} cards over NCCL"
    elif cards:
        device, backend, where = "cuda", "gloo", f"{n} ranks sharing {cards} card(s) over gloo"
    else:
        device, backend, where = "cpu", "gloo", f"{n} ranks on the CPU over gloo (no card)"
    print(f"dryrun_multichip({n}): {where}", flush=True)
    return spawn(run, n, n, device, backend=backend, threads=threads)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
