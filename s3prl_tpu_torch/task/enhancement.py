"""Speech enhancement and separation tasks, SUPERB-SG SE / SS (port of
s3prl_tpu/task/enhancement.py).

Behavioral spec from the reference (s3prl/downstream/enhancement_stft,
separation_stft(2)): a BLSTM mask head over the upstream's features
predicts one (SE) or `num_sources` (SS) sigmoid masks on the mixture's STFT
magnitude; training minimizes the magnitude MSE, SS under the best source
permutation (PIT); evaluation reconstructs the waveforms with the
mixture's phase (iSTFT) and reports SI-SDR(i), and SE also STOI and PESQ
(host numpy, `metric/quality.py`).

The masks come at the upstream's frame rate and the STFT at its 160-sample
hop: as in the JAX package, the loss and the reconstruction take the first
``Tm = min(T', STFT frames)`` frames of both, so with an upstream of stride
320 the loss covers about half of the STFT's frames and the reconstruction
is 256 + 160 (Tm - 1) samples long, shorter than a longer utterance, whose
scoring then raises numpy's broadcast ValueError in both packages
(ROADMAP.md Queue 3, "Not port faults").
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from .base import Task
from ..ops.audio import istft, stft_complex
from ..ops.masking import length_mask

N_FFT = 512
HOP = 160
WIN = 400


def si_sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB (the reference's SS / SE metric)."""
    est = est - est.mean()
    ref = ref - ref.mean()
    alpha = (est * ref).sum() / max((ref ** 2).sum(), eps)
    target = alpha * ref
    noise = est - target
    return float(10 * np.log10(max((target ** 2).sum(), eps) / max((noise ** 2).sum(), eps)))


def _stft(wavs: torch.Tensor) -> torch.Tensor:
    return stft_complex(wavs, n_fft=N_FFT, hop_length=HOP, win_length=WIN)


class SeparationTask(Task):
    """module: (hs, h_lens) -> (mask logits [B, T', S * n_freq], lens)."""

    def __init__(self, module, num_sources: int = 2, n_fft: int = N_FFT):
        self.module = module
        self.num_sources = num_sources
        self.n_freq = n_fft // 2 + 1
        self.perms = list(itertools.permutations(range(num_sources)))
        self.host_keys = ("unique_name",)

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        # the packed LSTMs take their lengths on the host: the step's one sync
        out, out_lens = self._apply(hs, h_lens.cpu(), generator, train)
        dev = out.device
        B, T, _ = out.shape
        masks = torch.sigmoid(out.view(B, T, self.num_sources, self.n_freq))
        x = torch.as_tensor(batch["x"], device=dev)
        mix_mag = torch.abs(_stft(x))  # [B, F, n_freq]
        # clean targets [B, S, T_wav] -> magnitudes, cut to the frames common
        # to the masks, the mixture and the sources
        refs = torch.as_tensor(batch["sources"], device=dev)
        ref_mag = torch.abs(_stft(refs.reshape(-1, refs.shape[-1]))).reshape(
            B, self.num_sources, -1, self.n_freq)
        Tm = min(T, mix_mag.shape[1], ref_mag.shape[2])
        masks = masks[:, :Tm]
        mix_mag_t = mix_mag[:, :Tm]
        ref_mag = ref_mag[:, :, :Tm]
        out_lens = torch.clamp(out_lens.to(dev), max=Tm)
        valid = length_mask(out_lens, Tm, torch.float32)  # [B, Tm]
        denom = torch.clamp(valid.sum(-1), min=1.0)

        def perm_loss(perm):
            est = (masks[:, :, list(perm)] * mix_mag_t[:, :, None, :]).transpose(1, 2)
            err = ((est - ref_mag) ** 2).mean(dim=(1, 3))  # [B, Tm]
            return (err * valid).sum(-1) / denom

        losses = torch.stack([perm_loss(p) for p in self.perms])  # [P, B]
        best = torch.argmin(losses, dim=0)  # the first minimum, as jnp.argmin
        loss = torch.min(losses, dim=0).values.mean()
        cache = {"loss": loss.detach(), "masks": masks.detach(), "best_perm": best,
                 "out_lens": out_lens}
        if not train:
            # the eval cache carries the reconstructions and the references,
            # which the reduction scores per utterance on the host
            # (separation_stft2/expert.py:255-300, enhancement_stft:299)
            cache["est_wav"] = self.reconstruct(masks.detach(), x, x.shape[1])
            cache["x"] = x
            cache["x_len"] = torch.as_tensor(batch["x_len"], device=dev)
            cache["sources"] = refs
        return loss, cache

    #: metrics scored on the reconstructions in valid / test: SS si_sdr, SE
    #: also stoi and pesq (separation_stft2/expert.py:38 vs enhancement_stft/expert.py:38)
    compute_metrics: tuple = ("si_sdr",)

    # separation_stft2/expert.py:356: dev-best by mean si_sdr
    valid_metric = "si_sdr"
    valid_higher_better = True

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        logs = {"loss": float(np.mean([float(r["loss"]) for r in records]))}
        if mode == "train" or not records or "est_wav" not in records[0]:
            return logs
        from ..metric.quality import pesq as pesq_fn
        from ..metric.quality import stoi as stoi_fn

        vals: Dict[str, list] = {m: [] for m in self.compute_metrics}
        vals["si_sdri"] = []
        for r in records:
            est, mix, refs = r["est_wav"], r["x"], r["sources"]
            for b in range(len(est)):
                n = int(r["x_len"][b])
                perm = self.perms[int(r["best_perm"][b])]
                e = est[b][list(perm)]  # the loss's PIT order, as the reference's
                # evaluation (compute_permutation=False on PIT-ordered hypotheses)
                sdrs = [si_sdr(e[s, :n], refs[b, s, :n]) for s in range(self.num_sources)]
                base = [si_sdr(mix[b, :n], refs[b, s, :n]) for s in range(self.num_sources)]
                vals["si_sdr"].append(float(np.mean(sdrs)))
                vals["si_sdri"].append(float(np.mean(sdrs) - np.mean(base)))
                if "stoi" in vals:
                    vals["stoi"].append(stoi_fn(refs[b, 0, :n], e[0, :n], 16000))
                if "pesq" in vals:
                    vals["pesq"].append(pesq_fn(refs[b, 0, :n], e[0, :n], 16000))
        for k, v in vals.items():
            if v:
                logs[k] = float(np.nanmean(v))
        return logs

    def reconstruct(self, masks: torch.Tensor, mixture: torch.Tensor, length: int):
        """masks [B, T, S, F] + the mixture's waves -> the separated waves
        [B, S, <= length]: the masked mixture spectrum over its first
        min(T, STFT frames) frames, inverted (`istft` never pads)."""
        spec = _stft(mixture)
        T = min(masks.shape[1], spec.shape[1])
        est = masks[:, :T].transpose(1, 2) * spec[:, None, :T]
        B, S = est.shape[:2]
        wav = istft(est.reshape(B * S, T, -1), n_fft=N_FFT, hop_length=HOP, win_length=WIN,
                    length=length)
        return wav.reshape(B, S, -1)


class EnhancementTask(SeparationTask):
    """Single-source masking (SE): the same machinery with one source, as
    the reference's enhancement_stft."""

    def __init__(self, module, n_fft: int = N_FFT):
        super().__init__(module, num_sources=1, n_fft=n_fft)

    # enhancement_stft/expert.py:38,383-385: SE scores all three metrics and
    # keeps the dev-best checkpoint by mean PESQ (metric/quality.pesq: the
    # P.862 perceptual model with the reference implementation's tables)
    compute_metrics = ("si_sdr", "stoi", "pesq")
    valid_metric = "pesq"
    valid_higher_better = True
