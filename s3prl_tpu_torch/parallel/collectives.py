"""Collectives of the port's mesh (no JAX twin: GSPMD inserts these there).

- The Megatron pair as autograd functions: `copy_to_tp` (identity forward,
  all-reduce backward) in front of a column-parallel projection and on a
  replicated parameter that a rank reads only in part, `reduce_from_tp`
  (all-reduce forward, identity backward) after a row-parallel one.
- `gather_rows` (dp) and `gather_time` (sp): the shards of one axis put
  together, each rank's shard written at its offset into a zero-filled
  tensor of the whole and the group's tensors summed by one all-reduce.
  That serves gloo (which all-gathers CPU tensors only) and NCCL alike, and
  takes ragged shards (the last time shard, the halves a distributed
  sampler makes). The backward of a gather hands each rank its own slice of
  the gradient: it serves a computation that every rank of the group then
  runs alike on the whole.
- A loss that every dp rank forms alike on the gathered rows
  (`gather_rows_for_loss`) and `all_reduce_grads`, the mean of the ranks'
  gradients: the global loss's gradient, also for a parameter the loss reads
  besides the rows (the trainer's step and the dry run's).

Host staging: a gloo group reduces a CUDA tensor through host memory. The
tensor is copied to the CPU, reduced there and copied back (`all_reduce`),
whatever gloo's CUDA support in this torch build; ranks that share one card
(``chip_smoke.py``'s phase 18: NCCL refuses two ranks on one device) take
this route. NCCL groups reduce on the card; a CPU tensor given to an NCCL
group goes through the current CUDA device likewise. Half-precision
tensors are summed in f32 and cast back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

_EXACT = (torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8, torch.bool)


def group_size(group) -> int:
    """The ranks in `group`; 1 for None (an axis of one rank)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's index in `group`; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM, inplace: bool = False):
    """`t` reduced over `group` (`t` itself for None). bf16 / f16 are
    reduced in f32; a CUDA tensor in a gloo group is staged through host
    memory, a CPU tensor in an NCCL group through the current card. Out of
    place, unless `inplace` and `t` needs no staging (on the backend's
    device, of an exact dtype): then `t` is reduced and returned."""
    if group is None:
        return t
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    if inplace and t.device.type == device and t.dtype in _EXACT and t.is_contiguous():
        dist.all_reduce(t, op=op, group=group)
        return t
    work = t if t.dtype in _EXACT else t.float()
    buf = work.to(device, copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device, t.dtype)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Broadcasts `t` in place from global rank `src` (staged as
    `all_reduce` stages), over `group` (default: the world)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return t
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    buf = t.detach().to(device, copy=True)
    dist.broadcast(buf, src, group=group)
    with torch.no_grad():
        t.copy_(buf.to(t.device))
    return t


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = all_reduce(x, group, inplace=True)  # x: a projection's fresh partial sum
        if out is x:
            ctx.mark_dirty(x)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (SUM) backward over the tp `group`."""
    return x if group is None else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (SUM) forward over the tp `group`, identity backward."""
    return x if group is None else _ReduceFromTp.apply(x, group)


def shard_sizes(n: int, group, sizes: Optional[Sequence[int]] = None) -> list:
    """Every rank's shard length along the gathered axis: `sizes` as given,
    or exchanged by one all-reduce of the group's slots."""
    if sizes is not None:
        return list(sizes)
    slots = torch.zeros(group_size(group), dtype=torch.int64)
    slots[group_rank(group)] = n
    return all_reduce(slots, group, inplace=True).tolist()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes, grad_scale):
        r = group_rank(group)
        lo = sum(sizes[:r])
        ctx.index = (dim, lo, x.shape[dim], grad_scale)
        shape = list(x.shape)
        shape[dim] = sum(sizes)
        whole = x.new_zeros(shape)
        whole.narrow(dim, lo, x.shape[dim]).copy_(x)
        return all_reduce(whole, group, inplace=True)

    @staticmethod
    def backward(ctx, grad):
        dim, lo, n, scale = ctx.index
        part = grad.narrow(dim, lo, n)
        return (part if scale == 1 else part * scale), None, None, None, None


def gather(x: torch.Tensor, group, dim: int, sizes: Optional[Sequence[int]] = None):
    """The group's shards of `x` along `dim`, in rank order: one all-reduce
    of zero-filled slots (module docstring); `sizes` are the ranks' shard
    lengths when the caller knows them (else exchanged first). Backward:
    this rank's slice of the gradient."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim, shard_sizes(x.shape[dim], group, sizes), 1)


def gather_rows(x: torch.Tensor, group, sizes: Optional[Sequence[int]] = None):
    """The dp group's rows of `x` (axis 0), in rank order."""
    return gather(x, group, 0, sizes)


def gather_rows_for_loss(x: torch.Tensor, group, sizes: Optional[Sequence[int]] = None):
    """The dp group's rows of `x` (axis 0) for a loss that every rank forms
    alike on them. Backward hands the rank its rows' gradient times the
    group's size. On rank r a parameter's gradient is then D + dp R_r: D
    from where the loss reads it directly (the same on every rank: an
    AM-softmax weight, GE2E's scale), R_r through its rows. The ranks'
    mean (`all_reduce_grads`) is D + sum R_r, the global loss's gradient."""
    if group is None:
        return x
    return _Gather.apply(x, group, 0, shard_sizes(x.shape[0], group, sizes), group_size(group))


def all_reduce_grads(params, group) -> None:
    """The gradients of `params` averaged over `group` in one flat
    all-reduce (a parameter without one takes part with zeros, so every
    rank reduces the same layout), each written back to ``.grad`` in its
    parameter's dtype."""
    params = list(params)
    if group is None or not params:
        return
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1).float()
                      for p in params])
    flat = all_reduce(flat, group, inplace=True).div_(group_size(group))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p).to(p.dtype)


def gather_time(x: torch.Tensor, group, dim: int = 1, sizes: Optional[Sequence[int]] = None):
    """The sp group's frames of `x` along `dim` (ragged shards), in rank
    order."""
    return gather(x, group, dim, sizes)
