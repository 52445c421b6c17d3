"""Downstream probe heads (port of s3prl_tpu/nn/heads.py).

The SUPERB protocol's NN blocks on padded ``[B, T, H]`` features with
``[B]`` valid lengths, masking padded frames out of every reduction:
poolings (reference: s3prl/nn/pooling.py), FrameLevel / UtteranceLevel
(nn/common.py), FrameLevelLinear / MeanPoolingLinear (nn/linear.py),
FrameConcatLinear and ConvBankHead (the legacy phone probes), and the CTC
recipes' RNNEncoder (nn/rnn.py): cuDNN's bidirectional LSTM on packed
sequences.

Flax infers a layer's input width at ``init``; here each head takes its
input width (``input_size``, the upstream's hidden size) up front. The
layers keep flax's names (``hidden_0``, ``pool``, ``final``, ...), so
`upstream/convert.py` `probe_state_dict_from_jax` maps a flax params tree
onto them key for key, and flax's numerics:

- `Dense` casts its input to its weight's dtype, as flax's ``Dense(dtype=
  None)`` promotes a bf16 input against f32 params: the heads compute in
  f32 on the featurizer's bf16 output, while a pooling applied directly
  to that output reduces in its dtype, as in JAX;
- weights start from flax's ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan_in), biases from zeros;
- dropout keeps an element where a uniform draw from the caller's
  ``generator`` is below 1 - p and scales it by 1 / (1 - p) (flax's
  ``Dropout``), only in ``train()`` mode.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..ops.masking import length_mask

# flax's truncated_normal variance_scaling divides by the standard deviation
# of a unit normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal()``: truncated normal, variance 1 / fan_in,
    drawn on the CPU (from a CPU `generator`) and copied into w, so a seed
    gives the same weights on every device."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    draw = nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2 * std, 2 * std,
                                 generator=generator)
    with torch.no_grad():
        return w.copy_(draw)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal weight, zero bias, the input cast to
    the weight's dtype."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


@contextlib.contextmanager
def ieee_cudnn():
    """cuDNN in full f32 (TF32 off) inside the block, whatever the global
    ``torch.backends.cudnn.allow_tf32`` says (True by default)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _IeeeCudnn(torch.autograd.Function):
    """``run(x)`` with cuDNN's TF32 off in its forward and its backward.
    cuDNN reads the TF32 switch when each pass is called (an RNN's
    descriptor, a convolution's algorithm), so the forward builds its own graph (on the module's parameters, handed
    in as `params`) and the backward differentiates it under the switch."""

    @staticmethod
    def forward(ctx, run, x, *params):
        with torch.enable_grad(), ieee_cudnn():
            leaf = x.detach().requires_grad_(x.requires_grad)
            out = run(leaf)
        ctx.graph = (leaf, params, out)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        leaf, params, out = ctx.graph
        del ctx.graph
        wanted = ([leaf] if leaf.requires_grad else []) + list(params)
        with ieee_cudnn():
            grads = list(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, grads.pop(0) if leaf.requires_grad else None, *grads)


def ieee_call(run, x: torch.Tensor, params) -> torch.Tensor:
    """``run(x)`` with cuDNN's TF32 off, through `_IeeeCudnn` when a
    backward may follow (`params`: the parameters `run` reads)."""
    params = [p for p in params if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        return _IeeeCudnn.apply(run, x, *params)
    with ieee_cudnn():
        return run(x)


class Conv(nn.Conv1d):
    """flax ``nn.Conv(features, (k,), kernel_dilation=(d,), padding=...)`` on
    [B, T, C]: "SAME" pads (span - 1) // 2 frames of zeros before and the
    rest after (span = (k - 1) d + 1), "VALID" none, and an input shorter
    than the span gives an empty time axis, as in flax; lecun-normal weight
    (fan_in = k * in), zero bias. cuDNN runs it in full f32 (TF32 off) in
    the forward and the backward, as `LSTM`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, padding: str = "SAME", device=None):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         device=device)
        self.same = padding == "SAME"

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        span = self.dilation[0] * (self.kernel_size[0] - 1) + 1
        if self.same:
            x = F.pad(x, (0, 0, (span - 1) // 2, span // 2))
        if x.shape[1] < span:  # flax's empty time axis (F.conv1d raises)
            return F.linear(x[:, :0], self.weight[..., 0], self.bias)

        def run(y):
            return F.conv1d(y.transpose(1, 2), self.weight, self.bias,
                            dilation=self.dilation).transpose(1, 2)

        return ieee_call(run, x, [self.weight, self.bias])


# (offset, rows, total): this rank's rows of the global batch under data
# parallelism, set by the trainer around a step (`global_rows`)
_GLOBAL_ROWS: contextvars.ContextVar = contextvars.ContextVar("global_rows", default=None)


@contextlib.contextmanager
def global_rows(offset: int, rows: int, total: int):
    """Inside, `dropout` draws the mask of the global batch's `total` rows
    and keeps this rank's `rows` from `offset`: dp = N draws what dp = 1
    draws from the same generator."""
    token = _GLOBAL_ROWS.set((offset, rows, total))
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator], cols: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout(p)`` drawing from `generator` (on x's device).
    Under `global_rows` the mask is drawn for the global batch (axis 0) and
    this rank's rows kept; `cols` = (offset, total) does the same on the
    last axis (a tp rank's FFN columns)."""
    if not training or p == 0.0:
        return x
    keep_prob = 1.0 - p
    shape, index = list(x.shape), [slice(None)] * x.ndim
    rows = _GLOBAL_ROWS.get()
    if rows is not None:
        offset, n, total = rows
        if x.shape[0] != n:
            raise RuntimeError(f"dropout on {tuple(x.shape)} under data parallelism: its leading "
                               f"axis is not this rank's {n} rows of the batch")
        shape[0], index[0] = total, slice(offset, offset + n)
    if cols is not None:
        shape[-1], index[-1] = cols[1], slice(cols[0], cols[0] + x.shape[-1])
    keep = torch.rand(shape, generator=generator, device=x.device)[tuple(index)] < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def _valid(xs: torch.Tensor, xs_len: torch.Tensor, dtype=torch.bool) -> torch.Tensor:
    return length_mask(xs_len.to(xs.device), xs.shape[1], dtype)


# ---------------------------------------------------------------------------
# poolings (reference: s3prl/nn/pooling.py)
# ---------------------------------------------------------------------------


class MeanPooling(nn.Module):
    """Masked mean over time: [B, T, H] -> [B, H], in xs's dtype."""

    def __init__(self, input_size: int):
        super().__init__()
        self.output_size = input_size

    def forward(self, xs: torch.Tensor, xs_len: torch.Tensor) -> torch.Tensor:
        mask = _valid(xs, xs_len, xs.dtype)[..., None]
        denom = torch.clamp(xs_len.to(xs.device, xs.dtype), min=1.0)[:, None]
        return torch.sum(xs * mask, dim=1) / denom


TemporalAveragePooling = MeanPooling


class TemporalStatisticsPooling(nn.Module):
    """Masked mean ++ std over time (x-vector stats pooling): [B,T,H]->[B,2H]."""

    def __init__(self, input_size: int):
        super().__init__()
        self.output_size = 2 * input_size

    def forward(self, xs: torch.Tensor, xs_len: torch.Tensor) -> torch.Tensor:
        mask = _valid(xs, xs_len, xs.dtype)[..., None]
        denom = torch.clamp(xs_len.to(xs.device, xs.dtype), min=1.0)[:, None]
        mean = torch.sum(xs * mask, dim=1) / denom
        sq = torch.where(mask > 0, (xs - mean[:, None]) ** 2, 0.0)
        var = torch.sum(sq, dim=1) / denom
        return torch.cat([mean, torch.sqrt(var + 1e-10)], dim=-1)


class SelfAttentivePooling(nn.Module):
    """Learned softmax attention over time: [B, T, H] -> [B, H]."""

    def __init__(self, input_size: int):
        super().__init__()
        self.output_size = input_size
        self.proj = Dense(input_size, input_size)
        self.attn = Dense(input_size, 1)

    def _weights(self, xs: torch.Tensor, xs_len: torch.Tensor) -> torch.Tensor:
        scores = self.attn(torch.tanh(self.proj(xs)))[..., 0]  # [B, T]
        scores = torch.where(_valid(xs, xs_len), scores, -1e9)
        return torch.softmax(scores, dim=-1)

    def forward(self, xs: torch.Tensor, xs_len: torch.Tensor) -> torch.Tensor:
        w = self._weights(xs, xs_len)
        return torch.einsum("bt,bth->bh", w, xs.to(w.dtype))


class AttentiveStatisticsPooling(SelfAttentivePooling):
    """Attention-weighted mean ++ std: [B, T, H] -> [B, 2H]."""

    def __init__(self, input_size: int):
        super().__init__(input_size)
        self.output_size = 2 * input_size

    def forward(self, xs: torch.Tensor, xs_len: torch.Tensor) -> torch.Tensor:
        w = self._weights(xs, xs_len)
        xs = xs.to(w.dtype)
        mean = torch.einsum("bt,bth->bh", w, xs)
        var = torch.einsum("bt,bth->bh", w, (xs - mean[:, None]) ** 2)
        return torch.cat([mean, torch.sqrt(var + 1e-10)], dim=-1)


POOLINGS = {
    "MeanPooling": MeanPooling,
    "TemporalAveragePooling": TemporalAveragePooling,
    "TemporalStatisticsPooling": TemporalStatisticsPooling,
    "SelfAttentivePooling": SelfAttentivePooling,
    "AttentiveStatisticsPooling": AttentiveStatisticsPooling,
}


# ---------------------------------------------------------------------------
# frame / utterance heads (reference: s3prl/nn/common.py, linear.py)
# ---------------------------------------------------------------------------


class _HiddenStack(nn.Module):
    """``hidden_{i}``: Dense + ReLU layers, flax's names."""

    def _add_hidden(self, input_size: int, hidden_sizes: Sequence[int]) -> int:
        self.n_hidden = len(hidden_sizes)
        for i, h in enumerate(hidden_sizes):
            self.add_module(f"hidden_{i}", Dense(input_size, h))
            input_size = h
        return input_size

    def _hidden(self, xs: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            xs = F.relu(getattr(self, f"hidden_{i}")(xs))
        return xs


class FrameLevel(_HiddenStack):
    """Per-frame MLP probe: hidden ReLU stack + final linear."""

    def __init__(self, input_size: int, output_size: int, hidden_sizes: Sequence[int] = ()):
        super().__init__()
        self.final = Dense(self._add_hidden(input_size, hidden_sizes), output_size)

    def forward(self, xs, xs_len, generator=None):
        return self.final(self._hidden(xs)), xs_len


class UtteranceLevel(_HiddenStack):
    """MLP -> masked pooling -> linear (reference: nn/common.py UtteranceLevel)."""

    def __init__(self, input_size: int, output_size: int, hidden_sizes: Sequence[int] = (256,),
                 pooling: str = "MeanPooling"):
        super().__init__()
        self.pool = POOLINGS[pooling](self._add_hidden(input_size, hidden_sizes))
        self.final = Dense(self.pool.output_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        return self.final(self.pool(self._hidden(xs), xs_len))


class FrameLevelLinear(nn.Module):
    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.linear = Dense(input_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        return self.linear(xs), xs_len


class MeanPoolingLinear(nn.Module):
    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.pool = MeanPooling(input_size)
        self.linear = Dense(input_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        return self.linear(self.pool(xs, xs_len))


class FrameConcatLinear(nn.Module):
    """Concat +-(n//2) neighbouring frames then linear (reference:
    downstream/phone_linear_concat - modelrc concat_n_frames 9). The shifts
    wrap around the utterance axis, as ``jnp.roll`` does."""

    def __init__(self, input_size: int, output_size: int, concat_n_frames: int = 9):
        super().__init__()
        self.concat_n_frames = concat_n_frames
        self.linear = Dense(input_size * concat_n_frames, output_size)

    def forward(self, xs, xs_len, generator=None):
        half = self.concat_n_frames // 2
        shifted = [torch.roll(xs, shift, dims=1) for shift in range(half, -half - 1, -1)]
        return self.linear(torch.cat(shifted, dim=-1)), xs_len


class ConvBankHead(nn.Module):
    """Parallel same-padding conv bank probe (reference: downstream/
    timit_phone/model.py:14-42): linear -> relu -> dropout -> convs of each
    kernel size -> concat -> relu -> dropout -> linear."""

    def __init__(self, input_size: int, output_size: int, kernels: Sequence[int] = (3, 5, 7),
                 cnn_size: int = 32, hidden_size: int = 64, dropout: float = 0.5):
        super().__init__()
        self.p = dropout
        self.in_linear = Dense(input_size, hidden_size)
        self.n_cnn = len(kernels)
        for i, k in enumerate(kernels):
            self.add_module(f"cnn_{i}", Conv(hidden_size, cnn_size, k))
        self.out_linear = Dense(cnn_size * len(kernels), output_size)

    def forward(self, xs, xs_len, generator=None):
        h = dropout(F.relu(self.in_linear(xs)), self.p, self.training, generator)
        feats = [getattr(self, f"cnn_{i}")(h) for i in range(self.n_cnn)]
        h = dropout(F.relu(torch.cat(feats, dim=-1)), self.p, self.training, generator)
        return self.out_linear(h), xs_len


# ---------------------------------------------------------------------------
# RNN encoder for CTC ASR (reference: s3prl/nn/rnn.py RNNEncoder; SUPERB ASR
# uses a bidirectional LSTM stack + linear over the CTC vocab)
# ---------------------------------------------------------------------------


def flip_valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """flax's ``flip_sequences`` of x [B, T, ...] (an ``nn.RNN`` with
    ``reverse=True`` and ``seq_lengths``): each row's valid frames reversed,
    then its padding reversed, frame t taken from (T - 1 - t + len) mod T;
    its own inverse."""
    T = x.shape[1]
    t = torch.arange(T)[None, :]
    index = ((T - 1 - t + lens[:, None].cpu()) % T).to(x.device)
    return x.gather(1, index.view(*index.shape, *[1] * (x.ndim - 2)).expand_as(x))


class LSTM(nn.LSTM):
    """One layer of flax's ``nn.RNN(nn.OptimizedLSTMCell(H), seq_lengths=...)``
    (both directions when `bidirectional`, the backward one over each
    utterance's valid frames) as cuDNN's LSTM over a packed sequence, in f32
    with TF32 off.

    flax's cell has one bias a gate (on its hidden kernels); torch's has
    two, so ``bias_ih`` is held at zero: it requires no grad and so takes
    no gradient and no optimizer update (`train.Optimizer` takes the
    parameters that require grad). Valid frames depend on valid inputs only,
    as in flax; padded frames are zeros (flax's carry on over them). A row
    of 0 frames, which ``pack_padded_sequence`` refuses and flax runs, is
    packed with one frame whose output is zeroed.

    With `carry_padding`, padded frames are flax's too, for a consumer that
    reads them (the SE / SS mask heads, whose reconstruction takes every
    frame): two one-way cuDNN passes over the whole padded length
    (`_carried`)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True,
                 carry_padding: bool = False):
        super().__init__(input_size, hidden_size, batch_first=True, bidirectional=bidirectional)
        self.carry_padding = carry_padding
        for name in self._flat_weights_names:
            if name.startswith("bias_ih"):
                getattr(self, name).requires_grad_(False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's cell init: lecun-normal input kernels, an orthogonal
        recurrent kernel for each gate's [H, H] (drawn on the CPU from a CPU
        `generator`), zero biases."""
        H = self.hidden_size
        with torch.no_grad():
            for name in self._flat_weights_names:
                w = getattr(self, name)
                if name.startswith("weight_ih"):
                    lecun_normal_(w, self.input_size, generator)
                elif name.startswith("weight_hh"):
                    for g in range(4):
                        w[g * H:(g + 1) * H].copy_(
                            nn.init.orthogonal_(torch.empty(H, H), generator=generator))
                else:
                    w.zero_()

    def _carried(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """flax's outputs on every frame, padded ones included: each
        direction one unidirectional pass over the whole padded length, the
        backward one over flax's flip of each row (`flip_valid`)."""
        zeros = x.new_zeros(1, x.shape[0], self.hidden_size)

        def one_way(inputs, weights):
            # cuDNN copies one direction's weights out of the module's flat
            # buffer at each call (5 MB at hidden 256 and input 1,024) and
            # warns that it does
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "RNN module weights are not part")
                return torch._VF.lstm(inputs, (zeros, zeros), weights, True, 1, 0.0,
                                      self.training, False, True)[0]

        w = self._flat_weights
        out = one_way(x, w[:4])
        if not self.bidirectional:
            return out
        back = one_way(flip_valid(x, lens), w[4:])
        return torch.cat([out, flip_valid(back, lens)], dim=-1)

    def forward(self, xs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """xs [B, T, C], lens [B] on the host -> [B, T, H x directions] f32."""
        xs = xs.to(self.weight_ih_l0.dtype)
        if self.carry_padding:
            return ieee_call(lambda x: self._carried(x, lens), xs, self._flat_weights)
        T = xs.shape[1]
        packed_lens = lens.clamp(min=1).to(torch.int64)

        def run(x):
            packed = pack_padded_sequence(x, packed_lens, batch_first=True, enforce_sorted=False)
            out, _ = super(LSTM, self).forward(packed)
            return pad_packed_sequence(out, batch_first=True, total_length=T)[0]

        out = ieee_call(run, xs, self._flat_weights)
        if bool((lens == 0).any()):
            out = out * (lens > 0).to(out.device, out.dtype)[:, None, None]
        return out


class GRU(nn.GRU):
    """One layer of flax's ``nn.RNN(nn.GRUCell(H), seq_lengths=...)`` as
    cuDNN's one-way GRU over the whole padded length, in f32 with TF32 off.

    flax's cell has no bias on its hidden kernels ``hr`` / ``hz``; torch's
    ``b_hr`` / ``b_hz`` add to the same sums as ``b_ir`` / ``b_iz``, so a
    flax cell is this layer with those two held in ``bias_ih`` and zeros in
    ``bias_hh`` (`upstream/convert.py` `apc_state_dict_from_jax`). Their
    gradient is zeroed by a hook (`_hold_hidden_gate_biases`), so training
    moves the same biases as flax's (a reference checkpoint's nonzero ones
    stay as loaded). flax's ``seq_lengths`` only picks the last carry: the
    outputs run on over the padded frames, as here (no packing)."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__(input_size, hidden_size, batch_first=True, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's cell init: lecun-normal input kernels, an orthogonal
        recurrent kernel for each gate's [H, H] (drawn on the CPU from a CPU
        `generator`), zero biases."""
        H = self.hidden_size
        with torch.no_grad():
            lecun_normal_(self.weight_ih_l0, self.input_size, generator)
            for g in range(3):
                self.weight_hh_l0[g * H:(g + 1) * H].copy_(
                    nn.init.orthogonal_(torch.empty(H, H), generator=generator))
            self.bias_ih_l0.zero_()
            self.bias_hh_l0.zero_()

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """xs [B, T, C] -> [B, T, H] f32, every frame."""
        if torch.is_grad_enabled():
            self._hold_hidden_gate_biases()
        return ieee_call(lambda x: super(GRU, self).forward(x)[0],
                         xs.to(self.weight_ih_l0.dtype), self._flat_weights)

    def _hold_hidden_gate_biases(self) -> None:
        """Registers, once per parameter tensor (a copy of the module gets a
        new one), the hook that zeroes the gradient of ``b_hr`` / ``b_hz``."""
        bias = self.bias_hh_l0
        if not bias.requires_grad or getattr(bias, "_holds_hidden_gate_biases", False):
            return
        rows = 2 * self.hidden_size

        def hold(grad):
            grad = grad.clone()
            grad[:rows] = 0.0
            return grad

        bias.register_hook(hold)
        bias._holds_hidden_gate_biases = True


class RNNEncoder(nn.Module):
    """flax's RNNEncoder (s3prl_tpu/nn/heads.py:142-168): per layer an LSTM
    (`LSTM`, both directions concatenated), ``proj_{i}`` and dropout, then
    ``final`` over the vocab; returns (logits f32 [B, T, V], xs_len). The
    layers keep flax's order, which `probe_state_dict_from_jax` maps
    (``OptimizedLSTMCell_{k}``: layer k // 2, direction k % 2).

    `xs_len` should be a host tensor: ``pack_padded_sequence`` takes its
    lengths on the host, so a device tensor costs a sync here (the CTC
    task hands the module host lengths). `carry_padding`: flax's outputs
    on the padded frames too (`LSTM`)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int = 1024,
                 num_layers: int = 2, bidirectional: bool = True, dropout: float = 0.2,
                 proj_size: int = 1024, carry_padding: bool = False):
        super().__init__()
        self.num_layers, self.p = num_layers, dropout
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", LSTM(input_size if i == 0 else proj_size, hidden_size,
                                              bidirectional, carry_padding))
            self.add_module(f"proj_{i}", Dense(hidden_size * (2 if bidirectional else 1),
                                               proj_size))
        self.final = Dense(proj_size, output_size)

    def forward(self, xs, xs_len, generator=None):
        lens = xs_len.cpu()
        for i in range(self.num_layers):
            xs = getattr(self, f"proj_{i}")(getattr(self, f"lstm_{i}")(xs, lens))
            xs = dropout(xs, self.p, self.training, generator)
        return self.final(xs), xs_len
