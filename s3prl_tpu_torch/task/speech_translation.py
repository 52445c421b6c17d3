"""Speech translation task, SUPERB-SG ST (port of
s3prl_tpu/task/speech_translation.py).

Behavioral spec from the reference (s3prl/downstream/speech_translation: a
fairseq S2T encoder-decoder trained with label-smoothed CE, scored with
sacrebleu): the encoder is a probe over the featurized upstream states, the
decoder `models.decoder.TransformerDecoder`; training is teacher-forced,
label-smoothed CE (0.1) with ``<eos>`` appended at each target's length,
and evaluation decodes greedily and reports corpus BLEU (metric/bleu.py).

The task's module holds both halves (``encoder``, ``decoder``), so the
Trainer's optimizer, clip and checkpoints cover them, and a JAX params tree
``{"encoder": ..., "decoder": ...}`` maps onto its state_dict
(`probe_state_dict_from_jax`). `greedy_decode` is the JAX package's: each
of `max_decode_len` steps reruns the causal decoder on the whole [B, L + 1]
token buffer (no cache), rows that emitted ``<eos>`` get ``<pad>``, and
nothing leaves the device until the end.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn as nn

from .base import Task
from ..metric.bleu import corpus_bleu
from ..ops.masking import length_mask


class SpeechTranslationTask(Task):
    def __init__(self, encoder_module, decoder_module, tokenizer, max_decode_len: int = 128,
                 label_smoothing: float = 0.1):
        # encoder: (hs, h_lens) -> (memory, lens); decoder: TransformerDecoder
        self.module = nn.ModuleDict({"encoder": encoder_module, "decoder": decoder_module})
        self.tokenizer = tokenizer
        self.max_decode_len = max_decode_len
        self.label_smoothing = label_smoothing
        self.host_keys = ("labels", "unique_name")

    valid_metric = "bleu"
    valid_higher_better = True

    def _forward(self, hs, h_lens, tokens, generator, train: bool):
        if self.module.training != train:
            self.module.train(train)
        generator = generator if train else None
        memory, lens = self.module["encoder"](hs, h_lens, generator=generator)
        return self.module["decoder"](tokens, memory, lens, generator=generator)

    def loss_and_cache(self, hs, h_lens, batch, generator, train):
        dev = hs.device
        raw = torch.as_tensor(batch["class_ids"], device=dev).long()  # [B, N], pad 0
        raw_lens = torch.as_tensor(batch["class_ids_len"], device=dev).long()
        eos = self.tokenizer.eos_idx
        B, N = raw.shape
        # <eos> appended at each target's end: the decoder must learn to stop
        # (without it greedy decoding rambles to max_decode_len)
        targets = torch.cat([raw, raw.new_zeros(B, 1)], 1)
        pos = torch.arange(N + 1, device=dev)[None, :]
        targets = torch.where(pos == raw_lens[:, None], eos, targets)
        target_lens = raw_lens + 1
        # teacher forcing: input [eos, y_0 .. y_{n-1}], predict [y, eos]
        dec_in = torch.cat([torch.full((B, 1), eos, dtype=targets.dtype, device=dev),
                            targets[:, :-1]], 1)
        logits = self._forward(hs, h_lens, dec_in, generator, train)
        valid = length_mask(target_lens, N + 1, torch.float32)
        # optax.softmax_cross_entropy on optax.smooth_labels(one_hot, a):
        # labels (1 - a) one_hot + a / V
        logp = torch.log_softmax(logits.float(), dim=-1)
        a = self.label_smoothing
        ce = -((1.0 - a) * logp.gather(-1, targets[..., None])[..., 0]
               + (a / logits.shape[-1]) * logp.sum(-1))
        loss = (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        pred = torch.argmax(logits, -1)
        return loss, {"loss": loss.detach(), "prediction": pred, "prediction_len": target_lens}

    @torch.no_grad()
    def greedy_decode(self, hs, h_lens) -> np.ndarray:
        """Greedy tokens [B, max_decode_len] (numpy), ``<pad>`` after each
        row's ``<eos>``."""
        self.module.eval()
        memory, lens = self.module["encoder"](hs, h_lens)
        decoder = self.module["decoder"]
        B = memory.shape[0]
        eos, pad = self.tokenizer.eos_idx, self.tokenizer.pad_idx
        L = self.max_decode_len
        tokens = torch.full((B, L + 1), pad, dtype=torch.long, device=memory.device)
        tokens[:, 0] = eos
        done = torch.zeros(B, dtype=torch.bool, device=memory.device)
        for t in range(L):
            nxt = torch.argmax(decoder(tokens, memory, lens)[:, t], -1)
            nxt = torch.where(done, pad, nxt)
            tokens[:, t + 1] = nxt
            done = done | (nxt == eos)
        return tokens[:, 1:].cpu().numpy()

    def reduction(self, mode: str, records: List[Dict[str, Any]]) -> Dict[str, float]:
        hyps, refs, losses = [], [], []
        for r in records:
            losses.append(float(r["loss"]))
            preds = np.asarray(r["prediction"])
            lens = np.asarray(r["prediction_len"])
            for b in range(len(preds)):
                hyps.append(self.tokenizer.decode(preds[b, : int(lens[b])].tolist()))
            refs.extend(r["labels"])
        return {"loss": float(np.mean(losses)), "bleu": corpus_bleu(hyps, refs)}
