"""CTC beam decoder binding (native C++ + ARPA n-gram LM) (a copy of
s3prl_tpu/nn/beam_decoder.py).

The analog of the reference's BeamDecoder (s3prl/nn/beam_decoder.py, a
flashlight-text + KenLM wrapper): the decoder is first-party C++
(native/ctc_beam.cc) built with g++ at first use into build/
(native/__init__.py; a failed build raises) and bound through ctypes. It
runs on the host over log-probs the card produced, moved to the host as
numpy; greedy CTC decoding stays in the task (argmax on the card).
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional

import numpy as np

from .. import native

logger = logging.getLogger(__name__)


class BeamDecoder:
    """Prefix beam search over CTC log-probs, optional word n-gram LM.

    Args mirror the reference's decoder_args (downstream/asr/config.yaml):
    beam size, LM weight, word insertion score.
    """

    def __init__(
        self,
        tokenizer,
        beam_size: int = 20,
        lm_path: Optional[str] = None,
        lm_weight: float = 2.0,
        word_score: float = -1.0,
    ):
        self.tokenizer = tokenizer
        self.beam_size = beam_size
        self.lm_weight = lm_weight if lm_path else 0.0
        self.word_score = word_score
        self._lib = native.library("ctc_beam")
        self._lib.ctc_beam_decode.restype = ctypes.c_int
        if lm_path:
            order = self._lib.ctc_load_lm(str(lm_path).encode())
            if order < 0:
                raise ValueError(f"failed to load ARPA LM from {lm_path}")
            logger.info(f"loaded {order}-gram LM from {lm_path}")

        # vocab buffer: tokens by id, newline separated; <space> -> boundary
        space = getattr(tokenizer, "SPACE", "<space>")
        toks = ["" if t == space else t for t in tokenizer.tokens]
        self._vocab_buf = ("\n".join(toks)).encode()
        self._space_id = tokenizer.tokens.index(space) if space in tokenizer.tokens else -1

    def decode_ids(self, log_probs: np.ndarray, length: Optional[int] = None) -> List[int]:
        """log_probs[T, V] (natural log) -> best token id sequence."""
        lp = np.ascontiguousarray(log_probs[: length or len(log_probs)], np.float32)
        T, V = lp.shape
        out = np.zeros(T + 8, np.int32)
        n = self._lib.ctc_beam_decode(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(T), ctypes.c_int(V),
            ctypes.c_int(self.tokenizer.pad_idx), ctypes.c_int(self._space_id),
            ctypes.c_char_p(self._vocab_buf), ctypes.c_int(self.beam_size),
            ctypes.c_float(self.lm_weight), ctypes.c_float(self.word_score),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), ctypes.c_int(len(out)),
        )
        return out[:n].tolist()

    def decode(self, log_probs: np.ndarray, length: Optional[int] = None) -> str:
        return self.tokenizer.decode(self.decode_ids(log_probs, length))
