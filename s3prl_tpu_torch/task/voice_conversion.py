"""Voice conversion task (port of s3prl_tpu/task/voice_conversion.py; the
reference's a2o-vc-vcc2020).

Training: the teacher-forced L1 between the predicted and the target
log-mel, the decoder fed the target shifted right by one frame, over the
frames both have and the shorter of each row's two lengths. Evaluation:
mel-cepstral distortion (MCD) on the host, a DTW over DCT cepstra 1-12 of
the log-mels (`mcd`), and, when ``wav_dir`` is set in test mode,
waveforms from the predicted mels by Griffin-Lim (`ops.vocoder`) on the
module's device. The prenet's dropout draws from the generator the trainer
hands the task, in eval too (step 0's there, as JAX's ``fold_in(key, 0)``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from .base import Task
from ..ops.masking import length_mask


def mcd(hyp_mel: np.ndarray, ref_mel: np.ndarray, n_cep: int = 13) -> float:
    """MCD (dB) over the DCT cepstra 1..n_cep-1 of two log-mels [T, M]:
    the DP over Euclidean distances with steps (1, 0), (0, 1), (1, 1), its
    cost divided by the path length T1 + T2."""
    from scipy.fftpack import dct

    c_hyp = dct(hyp_mel, type=2, axis=-1, norm="ortho")[:, 1:n_cep]
    c_ref = dct(ref_mel, type=2, axis=-1, norm="ortho")[:, 1:n_cep]
    D = np.linalg.norm(c_hyp[:, None, :] - c_ref[None, :, :], axis=-1)
    T1, T2 = D.shape
    acc = np.full((T1, T2), np.inf)
    acc[0, 0] = D[0, 0]
    for i in range(T1):
        for j in range(T2):
            if i == j == 0:
                continue
            best = np.inf
            if i > 0:
                best = min(best, acc[i - 1, j])
            if j > 0:
                best = min(best, acc[i, j - 1])
            if i > 0 and j > 0:
                best = min(best, acc[i - 1, j - 1])
            acc[i, j] = D[i, j] + best
    return float(10.0 * np.sqrt(2.0) / np.log(10.0) * acc[-1, -1] / (T1 + T2))


class VoiceConversionTask(Task):
    """module: (hs, h_lens, prev_mels, generator) -> (pred_mel [B, T, M], lens)."""

    def __init__(self, module, mel_dim: int = 80, wav_dir=None, gl_iters: int = 32):
        self.module = module
        self.mel_dim = mel_dim
        self.wav_dir = wav_dir  # test mode writes Griffin-Lim waves here when set
        self.gl_iters = gl_iters
        self.host_keys = ("unique_name",)

    valid_metric = "l1"
    valid_higher_better = False

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        if self.module.training != train:
            self.module.train(train)
        dev = hs.device
        target = torch.as_tensor(np.asarray(batch["target_mel"]), device=dev).float()
        target_lens = torch.as_tensor(np.asarray(batch["target_mel_len"]), device=dev)
        prev = torch.cat([torch.zeros_like(target[:, :1]), target[:, :-1]], dim=1)
        pred, out_lens = self.module(hs, h_lens, prev, generator=generator)
        T = min(pred.shape[1], target.shape[1])
        lens = torch.minimum(out_lens.to(dev), target_lens)
        valid = length_mask(lens, T, torch.float32)
        l1 = (pred[:, :T] - target[:, :T]).abs().mean(-1)
        loss = (l1 * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        return loss, {"loss": loss.detach(), "l1": loss.detach(),
                      "pred_mel": pred[:, :T].detach(), "target_mel": target[:, :T],
                      "lens": lens}

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        losses = [float(r["loss"]) for r in records]
        mcds = []
        for r in records[:4]:  # MCD on a few batches (an O(T^2) DP on the host)
            pred, tgt, lens = r["pred_mel"], r["target_mel"], r["lens"]
            for b in range(min(len(pred), 2)):
                n = int(lens[b])
                if n > 4:
                    mcds.append(mcd(pred[b, :n], tgt[b, :n]))
        out = {"loss": float(np.mean(losses)), "l1": float(np.mean(losses))}
        if mcds:
            out["mcd"] = float(np.mean(mcds))
        if mode == "test" and self.wav_dir is not None:
            self._synthesize(records)
        return out

    def _synthesize(self, records) -> None:
        """Each predicted mel's Griffin-Lim wave, cut to its (lens - 1) hops,
        as ``<wav_dir>/<unique_name>.wav``."""
        from ..ops.vocoder import log_mel_to_wav
        from ..util.pseudo_data import _write_wav

        out_dir = Path(self.wav_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        device = next(self.module.parameters()).device
        for r in records:
            pred, lens = r["pred_mel"], r["lens"]
            names = r.get("unique_name", [f"utt{i}" for i in range(len(pred))])
            with torch.no_grad():
                wavs = log_mel_to_wav(torch.as_tensor(pred, device=device), n_mels=self.mel_dim,
                                      n_iter=self.gl_iters).cpu().numpy()
            for b in range(len(pred)):
                n_samp = max(int(lens[b]) - 1, 1) * 160
                _write_wav(out_dir / f"{names[b]}.wav", wavs[b, :n_samp])
