"""The rank mesh and its layouts (port of s3prl_tpu/parallel/mesh.py).

The JAX package lays one program over a device mesh with axes ("dp",
"tp"[, "sp"]) and lets GSPMD place the collectives. The port runs one
process a device: `make_mesh` arranges the world's ranks as JAX arranges
devices and opens one process group per axis; the layouts are explicit:
- dp: `shard_batch` hands each dp rank its rows of the global batch (the
  padded length kept); the trainer all-reduces the probe's gradients;
- tp: `shard_params` applies the Megatron rules (`TP_RULES`, on the port's
  fairseq names) to a trunk's encoder layers, which then keep H / tp heads
  and the matching FFN columns and all-reduce after their row-parallel
  projections (`models/transformer.py`);
- sp: `sequence_sharded_extraction` runs a wav2vec2-family or WavLM trunk
  with each sp rank owning a run of output frames (`TimeShard`).
The contract is JAX's: a step or a forward on N = dp * tp * sp ranks gives
what one process gives. With one process every axis has one rank and the
same code runs unsharded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as cl
from .distributed import rank as _global_rank
from .distributed import world_size as _world_size

AXES = ("dp", "tp", "sp")


class Mesh:
    """Ranks arranged [dp, tp] (or [dp, tp, sp] when sp > 1), with this
    process's group and index along each axis (a group of one rank is
    None; `whole` is the group of all its ranks, None for the world's
    default group). `shape` is a dict like JAX's ``Mesh.shape``."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple, groups: dict, coords: dict,
                 whole=None):
        self.ranks, self.axis_names = ranks, axis_names
        self.groups, self.coords, self.whole = groups, coords, whole

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {_global_rank()} at {self.coords})"


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A ("dp", "tp"[, "sp"]) mesh over `ranks` (default: the whole world;
    one rank without a process group). ``dp=None`` takes what is left;
    dp * tp * sp other than the rank count raises AssertionError, as the
    JAX one does. Every rank of the world must call it (the process groups
    are made collectively); a rank outside `ranks` gets None."""
    ranks = list(range(_world_size())) if ranks is None else list(ranks)
    n = len(ranks)
    if dp is None:
        assert n % (tp * sp) == 0, (n, tp, sp)
        dp = n // (tp * sp)
    assert dp * tp * sp == n, f"dp({dp}) * tp({tp}) * sp({sp}) != {n} ranks"
    names = AXES if sp > 1 else AXES[:2]
    arr = np.asarray(ranks).reshape((dp, tp, sp)[:len(names)])
    me = _global_rank()
    whole = dist.new_group(ranks) if 1 < n < _world_size() else None
    groups, coords = {}, {}
    for axis, name in enumerate(names):
        lines = np.moveaxis(arr, axis, -1).reshape(-1, arr.shape[axis])
        for line in lines:  # every rank makes every group, in the same order
            group = dist.new_group(line.tolist()) if len(line) > 1 else None
            if me in line:
                groups[name] = group
                coords[name] = int(np.nonzero(line == me)[0][0])
    return Mesh(arr, names, groups, coords, whole) if me in ranks else None


def _rows(value, lo: int, hi: int, n: int):
    if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim and value.shape[0] == n:
        return value[lo:hi]
    if isinstance(value, (list, tuple)) and len(value) == n:
        return type(value)(value[lo:hi])
    return value


def shard_batch(mesh: Mesh, batch: Any):
    """This dp rank's rows of the global batch (the twin of placing a batch
    with `batch_sharding`): a dict's arrays, tensors and per-row lists of
    the batch's leading size, or one array or tuple; the padded length is
    kept. A batch not divisible by dp raises the JAX trainer's ValueError."""
    dp = mesh.size("dp")
    leaves = list(batch.values()) if isinstance(batch, dict) else \
        list(batch) if isinstance(batch, tuple) else [batch]
    n = next(v.shape[0] for v in leaves if isinstance(v, (np.ndarray, torch.Tensor)))
    if n % dp:
        raise ValueError(
            f"train batch size {n} not divisible by dp={dp}; "
            "pick batch_size as a multiple of dp (bucketed static shapes)")
    if dp == 1:
        return batch
    lo = mesh.index("dp") * (n // dp)
    hi = lo + n // dp
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi, n) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_rows(v, lo, hi, n) for v in batch)
    return _rows(batch, lo, hi, n)


def replicate(mesh: Mesh, value):
    """`value` (a tensor or a module's parameters and buffers) broadcast in
    place from the mesh's first rank to every rank (the twin of
    `replicate_to_mesh`); returned as given."""
    if mesh.ranks.size == 1:
        return value
    src = int(mesh.ranks.flat[0])
    tensors = [value] if isinstance(value, torch.Tensor) else \
        list(value.parameters()) + list(value.buffers())
    for t in tensors:
        cl.broadcast_(t.data if isinstance(t, torch.nn.Parameter) else t, src, mesh.whole)
    return value


# The Megatron rules on the port's fairseq names (nn.Linear's [out, in]
# weights): column-parallel (dim 0, the outputs) for q / k / v and fc1,
# row-parallel (dim 1, the inputs) for out_proj and fc2, whose biases are
# added once after the all-reduce. Everything else is replicated, WavLM's
# ``grep_linear``, ``grep_a`` and ``relative_attention_bias`` included (the
# JAX package's explicit decision, s3prl_tpu/parallel/mesh.py:83-94); a
# tp layer reads the columns of its own heads from the last two. q, k and v
# are split each by heads, so a rank's fused ``qkv_weight`` holds
# [q_heads_r; k_heads_r; v_heads_r], the layout its attention reads (JAX
# splits its fused [C, 3C] kernel in contiguous parts, which GSPMD makes
# right under any layout; a process a rank cannot).
TP_RULES = (
    ("self_attn.q_proj.weight", 0), ("self_attn.q_proj.bias", 0),
    ("self_attn.k_proj.weight", 0), ("self_attn.k_proj.bias", 0),
    ("self_attn.v_proj.weight", 0), ("self_attn.v_proj.bias", 0),
    ("self_attn.out_proj.weight", 1),
    ("fc1.weight", 0), ("fc1.bias", 0),
    ("fc2.weight", 1),
)


def tp_rule(key: str):
    """The sharded dim of a state_dict key under `TP_RULES`, else None."""
    for suffix, dim in TP_RULES:
        if key == suffix or key.endswith("." + suffix):
            return dim
    return None


def shard_state_dict(mesh: Mesh, state_dict: dict) -> dict:
    """This tp rank's state_dict: each `TP_RULES` tensor's tp-th part along
    its dim (copied), the rest as given."""
    tp, r = mesh.size("tp"), mesh.index("tp")
    out = {}
    for key, value in state_dict.items():
        dim = tp_rule(key)
        if dim is None or tp == 1:
            out[key] = value
            continue
        if value.shape[dim] % tp:
            raise ValueError(f"{key}: {value.shape[dim]} not divisible by tp={tp}")
        out[key] = value.chunk(tp, dim)[r].clone()
    return out


def shard_params(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Applies the tp rules to `module` in place (the twin of
    `shard_params`; a no-op at tp = 1): its encoder layers keep H / tp heads
    and F / tp FFN columns and reduce over the mesh's tp group. Every rank
    must hold the same weights before (the same seed or checkpoint). A
    module with no rule's name (a feature front end) stays whole on every
    rank, as JAX replicates what no rule names. The int8 layers and the
    fused-block options raise (`EncoderLayer.split_tp`), as does a rule's
    name outside an encoder layer."""
    from ..models.transformer import EncoderLayer

    tp = mesh.size("tp")
    if tp == 1:
        return module
    layers = {name: m for name, m in module.named_modules() if isinstance(m, EncoderLayer)}
    state = module.state_dict()
    stray = [k for k in state if tp_rule(k) is not None
             and not any(k.startswith(name + ".") for name in layers)]
    if stray:
        raise NotImplementedError(
            f"tensor parallelism over {type(module).__name__}: the tp rules shard the encoder "
            f"layers of the wav2vec2-family and WavLM trunks ({stray[:2]})")
    if not layers:
        return module
    local = shard_state_dict(mesh, state)
    for layer in layers.values():
        layer.split_tp(mesh.group("tp"), mesh.index("tp"), tp)
    module.load_state_dict(local)
    return module


# ---------------------------------------------------------------------------
# sp: time-sharded extraction
# ---------------------------------------------------------------------------


def time_shards(n: int, sp: int) -> list:
    """[lo, hi) of each sp rank over n frames: runs of ceil(n / sp), the
    last ragged (as GSPMD shards a ragged axis). Raises when a rank would
    hold no frame."""
    step = -(-n // sp)
    bounds = [(min(r * step, n), min((r + 1) * step, n)) for r in range(sp)]
    if any(lo >= hi for lo, hi in bounds):
        raise ValueError(f"{n} frames cannot be split over sp={sp} runs of {step}")
    return bounds


def _receptive(conv_layers) -> tuple:
    """(receptive field, total stride) in samples of a valid conv stack."""
    field, stride = 1, 1
    for conv in conv_layers:
        k, s = conv.kernel_size[0], conv.stride[0]
        field += (k - 1) * stride
        stride *= s
    return field, stride


@dataclass
class TimeShard:
    """This sp rank's run [lo, hi) of a trunk's `total` output frames, and
    the hooks the trunk calls under sp (`Wav2Vec2Trunk.forward`): `extract`
    (the conv front end on the samples of the run), `gather` (the sp
    group's frames of a tensor), `window` (a conv over the run with its
    halo)."""

    group: Any
    index: int
    bounds: list

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]

    @property
    def total(self) -> int:
        return self.bounds[-1][1]

    @property
    def last(self) -> bool:
        return self.index == len(self.bounds) - 1

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence of `x` (this rank's frames along `dim`)."""
        return cl.gather_time(x, self.group, dim, [hi - lo for lo, hi in self.bounds])

    def window(self, fn, x: torch.Tensor, halo: int) -> torch.Tensor:
        """fn (a length-preserving conv over [B, T, C] that reads `halo`
        frames on each side) on this rank's frames: the neighbours' frames
        come from the gathered sequence, and zeros past its ends are the
        conv's own padding there."""
        whole = self.gather(x)
        a, b = max(self.lo - halo, 0), min(self.hi + halo, self.total)
        return fn(whole[:, a:b])[:, self.lo - a:self.hi - a]

    def extract(self, extractor, wavs: torch.Tensor) -> torch.Tensor:
        """The conv front end's frames [lo, hi) from the full waves [B, T]:
        the samples they read (halo included; the last rank to the end of
        the waves). A group-norm layer 0 takes its per-channel statistics
        over all layer-0 frames of each utterance: each rank sums the ones
        it owns (from its first up to the next rank's first; the last to
        the end), once each, and the sums are all-reduced."""
        convs = [layer.conv for layer in extractor.conv_layers]
        field, stride = _receptive(convs)
        a = self.lo * stride
        b = wavs.shape[1] if self.last else (self.hi - 1) * stride + field
        stats = None
        if extractor.conv_layers[0].norm_kind == "group":
            k0, s0 = convs[0].kernel_size[0], convs[0].stride[0]
            count = (wavs.shape[1] - k0) // s0 + 1
            own = count - a // s0 if self.last else (self.hi - self.lo) * stride // s0

            def stats(x: torch.Tensor):  # x [B, T0_local, C] f32 -> (mean, var) [B, 1, C]
                part = x[:, :own]
                sums = cl.all_reduce(torch.stack([part.sum(1), part.square().sum(1)]),
                                     self.group)
                mean = sums[0] / count
                return mean[:, None], (sums[1] / count - mean.square()).clamp_min(0.0)[:, None]

        x = extractor(wavs[:, a:b].contiguous(), group_stats=stats)
        return x[:, :self.hi - self.lo]


def _sp_refusal(model, sp: int) -> None:
    from ..models.transformer import EncoderLayer
    from ..models.wav2vec2 import Wav2Vec2Trunk
    from ..models.wavlm import WavLMModel

    if type(model) not in (Wav2Vec2Trunk, WavLMModel) or model.cfg.layer_type != "transformer":
        raise NotImplementedError(
            f"sequence-sharded extraction of {type(model).__name__}: the port shards the time "
            "axis of the wav2vec2-family and WavLM transformer trunks (ROADMAP.md Queue 2, "
            "sp beyond these trunks)")
    layers = [m for m in model.modules() if isinstance(m, EncoderLayer)]
    if sp == 1:  # one run of frames: the layers' own routes serve it
        return
    if any(layer.use_flash for layer in layers):
        raise ValueError("flash=True cannot take effect under sp > 1: the card's attention "
                         "kernels take Tq = Tk only, and sp runs each rank's queries against "
                         "the gathered keys on stock ops (load the model with flash=False)")
    on = [name for name in ("quantize", "qkv_fuse", "full_fuse", "wavlm_fuse")
          if any(getattr(layer, name, False) for layer in layers)]
    if on:
        raise ValueError(f"{on[0]} cannot take effect under sp > 1: sp runs the f32 / bf16 "
                         "module path, as the JAX sp reference does")
    if any(getattr(layer, "tp", None) is not None for layer in layers):
        raise NotImplementedError("sequence-sharded extraction of a tp-sharded trunk: sp "
                                  "replicates the weights, as the JAX one does")


def sequence_sharded_extraction(upstream, mesh: Mesh, wavs, lens):
    """Hidden-state extraction with the time axis sharded over the mesh's
    "sp" axis (the twin of the JAX function, which takes the global
    arrays): every rank takes the full `wavs` [B, T] / `lens` [B], the dp
    ranks their rows, and each sp rank a run of the trunk's output frames
    (`time_shards`), reading the samples those frames need from the full
    waves, so no conv halo is exchanged. The group-norm extractor's
    statistics are all-reduced, the pos-conv reads its neighbours' frames
    from the gathered sequence, and each layer's attention runs the rank's
    queries against the gathered keys and values on stock ops. Returns
    (hs [L, B_dp, T_r, C], h_lens [B_dp]) after the reference's length
    rules (`Upstream.apply_standardized`): the standardized frames stay
    time-sharded, the last rank's run cut or extended (its last frame
    repeated) to the standardized length. `gather_hidden_states` puts them
    together. Numerics follow one process's up to f32 reduction order."""
    from ..ops.masking import expected_max_feat_len, upstream_feat_lengths
    from ..models.convfe import conv_output_lengths
    from ..upstream.base import MIN_SECOND, SAMPLE_RATE, match_length_stacked

    model = upstream.model
    _sp_refusal(model, mesh.size("sp"))
    wavs, lens = shard_batch(mesh, (wavs, lens))
    wavs, lens = upstream._inputs(wavs, lens)
    T = wavs.shape[1]
    run_lens = lens
    min_samples = int(MIN_SECOND * SAMPLE_RATE)
    if T < min_samples:  # the reference's minimum length (Upstream.standardized)
        wavs = torch.nn.functional.pad(wavs, (0, min_samples - T))
        run_lens = lens + (min_samples - T)
    frames = int(conv_output_lengths(torch.tensor([wavs.shape[1]]),
                                     model.cfg.conv_feature_layers)[0])
    shard = TimeShard(mesh.group("sp"), mesh.index("sp"), time_shards(frames, mesh.size("sp")))
    if model.training:
        model.eval()
    with torch.inference_mode():
        hs, _ = model(wavs, run_lens, sp=shard)
        target = expected_max_feat_len(wavs.shape[1], upstream.downsample_rate)
        if shard.last:
            hs = match_length_stacked(hs, max(target - shard.lo, 0))
        else:
            hs = hs[:, :, :max(min(shard.hi, target) - shard.lo, 0)]
    return hs, upstream_feat_lengths(lens, upstream.downsample_rate)


def gather_hidden_states(mesh: Mesh, hs: torch.Tensor) -> torch.Tensor:
    """The whole [L, B, T, C] of time- (sp) and row- (dp) sharded hidden
    states [L, B_dp, T_r, C], on every rank."""
    hs = cl.gather_time(hs, mesh.group("sp"), dim=2)
    return cl.gather(hs, mesh.group("dp"), dim=1)
