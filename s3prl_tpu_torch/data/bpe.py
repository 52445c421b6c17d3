"""First-party BPE subword trainer + tokenizer (replaces sentencepiece; a copy
of s3prl_tpu/data/bpe.py).

The reference trains subword vocabs with the sentencepiece C++ library
(s3prl/dataio/encoder/vocabulary.py:75-150). Here: a standard byte-pair
-merge trainer over word frequencies (one-time, host-side) and a greedy
longest-match-free encoder that applies the learned merges in order —
sufficient for the SUPERB ASR subword option.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .encoder import Tokenizer, TOKENIZER_TYPES

WORD_BOUNDARY = "▁"  # same marker convention as sentencepiece


def train_bpe(
    lines: Iterable[str], vocab_size: int = 1000, lowercase: bool = False
) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Learn BPE merges. Returns (vocab tokens, ordered merge pairs)."""
    word_freq: Counter = Counter()
    for line in lines:
        text = line.strip()
        if lowercase:
            text = text.lower()
        for word in text.split():
            word_freq[WORD_BOUNDARY + word] += 1

    # words as symbol tuples
    words: Dict[Tuple[str, ...], int] = {tuple(w): f for w, f in word_freq.items()}
    vocab = set()
    for w in words:
        vocab.update(w)
    merges: List[Tuple[str, str]] = []

    while len(vocab) + len(Tokenizer.SPECIALS) < vocab_size:
        pairs: Counter = Counter()
        for w, f in words.items():
            for i in range(len(w) - 1):
                pairs[(w[i], w[i + 1])] += f
        if not pairs:
            break
        best, freq = pairs.most_common(1)[0]
        if freq < 2:
            break
        merges.append(best)
        merged = best[0] + best[1]
        vocab.add(merged)
        new_words = {}
        for w, f in words.items():
            out = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words

    return sorted(vocab), merges


class SubwordTokenizer(Tokenizer):
    """BPE tokenizer (reference analog: dataio/encoder/tokenizer.py
    SubwordTokenizer over sentencepiece models)."""

    def __init__(self, vocab: List[str], merges: List[Tuple[str, str]]):
        super().__init__(vocab)
        self.merges = [tuple(m) for m in merges]
        self._rank = {tuple(m): i for i, m in enumerate(self.merges)}

    def _bpe_word(self, word: str) -> List[str]:
        symbols = list(WORD_BOUNDARY + word)
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i in range(len(symbols) - 1):
                r = self._rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def text_to_tokens(self, text: str) -> List[str]:
        out: List[str] = []
        for word in text.strip().split():
            out.extend(self._bpe_word(word))
        return out

    def tokens_to_text(self, tokens: List[str]) -> str:
        return "".join(tokens).replace(WORD_BOUNDARY, " ").strip()

    @classmethod
    def from_text(cls, lines: Iterable[str], vocab_size: int = 1000) -> "SubwordTokenizer":
        vocab, merges = train_bpe(list(lines), vocab_size)
        return cls(vocab, merges)

    def save(self, path) -> None:
        Path(path).write_text(
            json.dumps(
                {"type": "SubwordTokenizer", "tokens": self.tokens, "merges": self.merges}
            )
        )


def _load_subword(data: dict) -> "SubwordTokenizer":
    tok = SubwordTokenizer.__new__(SubwordTokenizer)
    Tokenizer.__init__(tok, [])
    tok.tokens = data["tokens"]
    tok._index = {t: i for i, t in enumerate(tok.tokens)}
    tok.merges = [tuple(m) for m in data["merges"]]
    tok._rank = {tuple(m): i for i, m in enumerate(tok.merges)}
    return tok


TOKENIZER_TYPES["SubwordTokenizer"] = SubwordTokenizer
