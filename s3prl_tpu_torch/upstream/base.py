"""The upstream contract (port of s3prl_tpu/upstream/base.py).

An `Upstream` bundles a model returning (hidden_states [L, B, T', H],
feat_lens [B]) with its metadata; `apply_standardized` applies the
reference's length rules (s3prl/nn/upstream.py:166-231): a 0.05 s minimum
length, trim or repeat-last-frame to len(range(0, max_wav_len, stride)), and
h_len = floor((wav_len - 1) / stride) + 1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masking import expected_max_feat_len, upstream_feat_lengths

MIN_SECOND = 0.05  # minimum supported audio length (nn/upstream.py:197-203)
SAMPLE_RATE = 16000


def match_length_stacked(hs: torch.Tensor, target_len: int) -> torch.Tensor:
    """Trim or repeat the last frame along the time axis (axis -2)."""
    cur = hs.shape[-2]
    if cur == target_len:
        return hs
    if cur > target_len:
        return hs[..., :target_len, :]
    pad = hs[..., -1:, :].expand(*hs.shape[:-2], target_len - cur, hs.shape[-1])
    return torch.cat([hs, pad], dim=-2)


def standardize_hidden_states(hidden_states: torch.Tensor, wav_lens: torch.Tensor,
                              max_wav_len: int, stride: int):
    """Returns (hs [L, B, T_expected, H], h_lens [B]) under the reference rules."""
    target = expected_max_feat_len(max_wav_len, stride)
    return match_length_stacked(hidden_states, target), upstream_feat_lengths(wav_lens, stride)


def _active_configs(cfg):
    """`cfg` and the nested config its model runs (the MOS predictor's
    upstream: ``trunk``, ``apc`` or ``tera`` by its ``upstream`` field)."""
    yield cfg
    nested = getattr(cfg, "upstream", None)
    if isinstance(nested, str):
        inner = getattr(cfg, {"wav2vec2": "trunk"}.get(nested, nested), None)
        if inner is not None:
            yield from _active_configs(inner)


def train_refusal(cfg) -> None:
    """Raises where the JAX upstream's train mode raises: its trainer hands
    the upstream a ``"dropout"`` stream only, and no mutable collection
    (s3prl_tpu/train/trainer.py:134-141, upstream/registry.py:357-359). So
    - a wav2vec2-family trunk with ``encoder_layerdrop`` > 0 draws
      ``make_rng("layerdrop")`` (transformer.py:750-753): InvalidRngError
      (WavLM's encoder never reads the field, wavlm.py:312-321);
    - VQ-APC draws ``make_rng("gumbel")`` (apc.py:53-54): InvalidRngError;
    - so does vq-wav2vec's Gumbel quantizer (wav2vec1.py:96-105);
    - NPC with BatchNorm updates ``batch_stats`` (npc.py:51, :55):
      ModifyScopeVariableError;
    - so does a Conformer trunk's BatchNorm (transformer.py:924-930).
    Dropout itself runs (`Upstream.__call__`)."""
    for c in _active_configs(cfg):
        name = type(c).__name__
        if getattr(c, "encoder_layerdrop", 0.0) > 0.0 and not hasattr(c, "gru_rel_pos"):
            raise NotImplementedError(
                f"train mode with encoder_layerdrop={c.encoder_layerdrop}: the JAX package's "
                'trainer supplies no "layerdrop" PRNG stream, so its train mode raises '
                "InvalidRngError here (s3prl_tpu/models/transformer.py:750-753); train with "
                "encoder_layerdrop=0 or with the upstream frozen")
        if getattr(c, "vq_codebook_size", None):
            raise NotImplementedError(
                f"train mode of {name} with VQ: the JAX package's trainer supplies no "
                '"gumbel" PRNG stream, so its train mode raises InvalidRngError here '
                "(s3prl_tpu/models/apc.py:53-54); train with the upstream frozen")
        if getattr(c, "vq_type", None) == "gumbel":
            raise NotImplementedError(
                "train mode of vq-wav2vec's Gumbel quantizer: the JAX package's trainer supplies "
                'no "gumbel" PRNG stream, so its train mode raises InvalidRngError here '
                "(s3prl_tpu/models/wav2vec1.py:96-105); train with the upstream frozen")
        if getattr(c, "layer_type", None) == "conformer":
            raise NotImplementedError(
                "train mode of a Conformer trunk: its BatchNorm would update its running "
                'statistics, and the JAX upstream applies it with the "batch_stats" collection '
                "immutable, so its train mode raises ModifyScopeVariableError "
                "(s3prl_tpu/models/transformer.py:924-930); train with the upstream frozen")
        if getattr(c, "batch_norm", False) and hasattr(c, "mask_size"):
            raise NotImplementedError(
                f"train mode of {name} with batch_norm=True: the JAX upstream applies it "
                'with the "batch_stats" collection immutable, so its train mode raises '
                "ModifyScopeVariableError (s3prl_tpu/models/npc.py:51, :55); train with "
                "batch_norm=False or with the upstream frozen")


@dataclass
class Upstream:
    """A ready-to-run upstream: model + metadata. `apply_standardized`
    serves under ``torch.inference_mode``; `__call__` (a probe's upstream,
    frozen or in train mode) under ``torch.no_grad``, whose states a
    probe's backward can save (an inference tensor cannot be);
    `standardized` runs in the caller's autograd mode."""

    name: str
    model: nn.Module  # (wavs [B, T], wav_lens [B]) -> (hs [L, B, T', H], feat_lens [B])
    num_layers: int
    hidden_size: int
    downsample_rate: int

    @property
    def device(self) -> torch.device:
        """The model's device: its first parameter's, or for a
        parameter-free model (the baseline front ends) its first buffer's."""
        return next(itertools.chain(self.model.parameters(), self.model.buffers())).device

    def _inputs(self, wavs, wav_lens):
        """wavs [B, T] (or [B, T, 1]) and wav_lens [B] as tensors on the
        model's device (floating wavs, int64 lengths)."""
        dev = self.device
        wavs = torch.as_tensor(wavs, device=dev)
        if not wavs.is_floating_point():
            wavs = wavs.float()
        if wavs.ndim == 3:
            wavs = wavs[..., 0]
        return wavs, torch.as_tensor(wav_lens, device=dev).long()

    @property
    def hidden_sizes(self):
        return [self.hidden_size] * self.num_layers

    @property
    def downsample_rates(self):
        return [self.downsample_rate] * self.num_layers

    @torch.inference_mode()
    def apply_standardized(self, wavs, wav_lens):
        """wavs [B, T] (or [B, T, 1]) padded 16 kHz, wav_lens [B] -> (hs
        [L, B, T_expected, H], h_lens [B]) on the model's device."""
        return self.standardized(wavs, wav_lens)

    def __call__(self, wavs, wav_lens, train: bool = False,
                 generator: torch.Generator | None = None):
        """The standardized forward under a probe (the JAX Upstream's
        ``__call__(wavs, wav_lens, train, rngs)``), under ``torch.no_grad()``:
        the JAX trainer differentiates the probe's parameters only, so the
        states are plain tensors that a probe's backward reads. Frozen
        (``train=False``): the model in ``eval()``, where the kernels serve
        it. ``train=True``: the model in ``train()``, its dropouts drawn from
        `generator` (the trainer's upstream stream); the attention kernels
        K7 / K9 (K8 / K10 beyond MAX_KERNEL_T) run where the JAX train mode
        runs them, the whole-block kernels and the front end's stay off. It
        raises where the JAX train mode raises (`train_refusal`)."""
        if train:
            train_refusal(self.model.cfg)
        if self.model.training != train:
            self.model.train(train)
        with torch.no_grad():
            return self.standardized(wavs, wav_lens, generator if train else None)

    def standardized(self, wavs, wav_lens, generator: torch.Generator | None = None):
        """`apply_standardized` in the caller's autograd mode; `generator`
        (train mode) goes to the model's dropouts."""
        wavs, wav_lens = self._inputs(wavs, wav_lens)
        original_max = wavs.shape[1]
        min_samples = int(MIN_SECOND * SAMPLE_RATE)
        if original_max < min_samples:
            # the reference pads every wav_len by the same amount (upstream.py:199-207)
            wavs = F.pad(wavs, (0, min_samples - original_max))
            run_lens = wav_lens + (min_samples - original_max)
        else:
            run_lens = wav_lens
        extra = {} if generator is None else {"generator": generator}
        hs, _ = self.model(wavs, run_lens, **extra)
        return standardize_hidden_states(hs, wav_lens, wavs.shape[1], self.downsample_rate)


@dataclass
class TrunkUpstream(Upstream):
    """A wav2vec2-family trunk's upstream, which also serves SUPERB's
    weighted sum of its layers (`apply_weighted`; the JAX package gives it
    to the trunk entries only, registry.py:199-207)."""

    @torch.inference_mode()
    def apply_weighted(self, layer_weights, wavs, wav_lens):
        """layer_weights [L+1] (as given: softmax them first for SUPERB's
        featurizer), wavs [B, T] padded 16 kHz, wav_lens [B] -> the model's
        raw (sum_i w_i h_i [1, B, T', H], feat_lens [B]): T' the model's
        frames, no length rule applied, as the JAX `apply_weighted`. The
        per-layer states are never stacked (`TransformerEncoder.forward`);
        the weights go to the model's device once and stay there."""
        wavs, wav_lens = self._inputs(wavs, wav_lens)
        weights = torch.as_tensor(layer_weights, device=wavs.device)
        return self.model(wavs, wav_lens, layer_weights=weights)
