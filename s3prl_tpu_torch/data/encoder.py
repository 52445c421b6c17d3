"""Label encoders and text tokenizers (a copy of s3prl_tpu/data/encoder.py:
1-284; `BertTokenizer` goes with the SLU / translation slice).

Behavioral spec from the reference's s3prl/dataio/encoder/: CategoryEncoder
(category.py:11-25), the Tokenizer hierarchy (tokenizer.py:40-554 —
character / word / phoneme / character+slot tokenizers with special tokens;
the BPE subword tokenizer is data/bpe.py), and vocab building
(vocabulary.py:19-192). A tokenizer saved by either package loads in the
other (`load_tokenizer`: the same JSON).
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional


class CategoryEncoder:
    """Bijective label <-> id mapping over a sorted category set."""

    def __init__(self, category: Iterable[str]):
        self.category = sorted(set(category))
        self._index = {c: i for i, c in enumerate(self.category)}

    def __len__(self) -> int:
        return len(self.category)

    def encode(self, label: str) -> int:
        return self._index[label]

    def decode(self, index: int) -> str:
        return self.category[index]

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.category))

    @classmethod
    def load(cls, path) -> "CategoryEncoder":
        return cls(json.loads(Path(path).read_text()))


class CategoryEncoders:
    """Multiple independent category encoders (multi-label heads, e.g. IC)."""

    def __init__(self, categories: List[Iterable[str]]):
        self.encoders = [CategoryEncoder(c) for c in categories]

    def __len__(self) -> int:
        return sum(len(e) for e in self.encoders)

    def __iter__(self):
        return iter(self.encoders)

    def encode(self, labels: List[str]) -> List[int]:
        return [e.encode(l) for e, l in zip(self.encoders, labels)]

    def decode(self, indices: List[int]) -> List[str]:
        return [e.decode(i) for e, i in zip(self.encoders, indices)]


class Tokenizer:
    """Base text tokenizer with CTC-friendly special tokens.

    Vocab layout follows the reference (tokenizer.py): pad/blank at 0, <unk>,
    <eos> reserved; `encode` -> ids, `decode` -> text with specials dropped.
    """

    PAD = "<pad>"  # doubles as the CTC blank (reference uses blank=pad)
    UNK = "<unk>"
    EOS = "<eos>"
    SPECIALS = [PAD, UNK, EOS]

    def __init__(self, vocab: List[str]):
        non_special = [v for v in vocab if v not in self.SPECIALS]
        self.tokens = self.SPECIALS + non_special
        self._index: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}

    # -- subclass hooks -----------------------------------------------------
    def text_to_tokens(self, text: str) -> List[str]:
        raise NotImplementedError

    def tokens_to_text(self, tokens: List[str]) -> str:
        raise NotImplementedError

    # -- public API ---------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    @property
    def pad_idx(self) -> int:
        return 0

    @property
    def unk_idx(self) -> int:
        return 1

    @property
    def eos_idx(self) -> int:
        return 2

    def encode(self, text: str) -> List[int]:
        return [self._index.get(t, self.unk_idx) for t in self.text_to_tokens(text)]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        tokens = []
        prev = None
        for i in ids:
            if ignore_repeat and i == prev:
                continue
            prev = i
            if i < len(self.SPECIALS):
                continue
            tokens.append(self.tokens[i])
        return self.tokens_to_text(tokens)

    def save(self, path) -> None:
        Path(path).write_text(
            json.dumps({"type": type(self).__name__, "tokens": self.tokens})
        )


class CharacterTokenizer(Tokenizer):
    """Char-level; space encoded as the word delimiter token <space>."""

    SPACE = "<space>"

    def text_to_tokens(self, text: str) -> List[str]:
        return [self.SPACE if c == " " else c for c in text.upper()]

    def tokens_to_text(self, tokens: List[str]) -> str:
        return "".join(" " if t == self.SPACE else t for t in tokens).strip()

    @classmethod
    def from_text(cls, lines: Iterable[str]) -> "CharacterTokenizer":
        counter = Counter()
        for line in lines:
            counter.update(cls.SPACE if c == " " else c for c in line.strip().upper())
        vocab = [c for c, _ in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))]
        if cls.SPACE not in vocab:
            vocab.insert(0, cls.SPACE)
        return cls(vocab)


class WordTokenizer(Tokenizer):
    def __init__(self, vocab: List[str], vocab_size: Optional[int] = None):
        super().__init__(vocab[:vocab_size] if vocab_size else vocab)

    def text_to_tokens(self, text: str) -> List[str]:
        return text.strip().split()

    def tokens_to_text(self, tokens: List[str]) -> str:
        return " ".join(tokens)

    @classmethod
    def from_text(cls, lines: Iterable[str], vocab_size: int = 10000) -> "WordTokenizer":
        counter = Counter()
        for line in lines:
            counter.update(line.strip().split())
        vocab = [w for w, _ in counter.most_common(vocab_size)]
        return cls(vocab)


class PhonemeTokenizer(WordTokenizer):
    """Space-separated phoneme sequences (SUPERB PR)."""


TOKENIZER_TYPES = {
    "CharacterTokenizer": CharacterTokenizer,
    "WordTokenizer": WordTokenizer,
    "PhonemeTokenizer": PhonemeTokenizer,
}


def load_tokenizer(path) -> Tokenizer:
    data = json.loads(Path(path).read_text())
    if data["type"] == "SubwordTokenizer":
        from .bpe import _load_subword  # registers + reconstructs merges

        return _load_subword(data)
    cls = TOKENIZER_TYPES[data["type"]]
    tok = cls.__new__(cls)
    Tokenizer.__init__(tok, [])
    tok.tokens = data["tokens"]
    tok._index = {t: i for i, t in enumerate(tok.tokens)}
    if data["type"] == "CharacterSlotTokenizer":
        tok.slots = [t for t in tok.tokens if t.startswith(("B-", "E-"))]
    return tok


class CharacterSlotTokenizer(Tokenizer):
    """Character tokenizer with interleaved slot boundary tokens (SUPERB SF).

    Behavioral spec from the reference (dataio/encoder/tokenizer.py:149-253):
    characters plus B-<slot>/E-<slot> tokens wrapping slot word spans; decode
    renders "B-type value E-type" markup (consumed by metric.slot_filling).
    """

    SPACE = "<space>"

    def __init__(self, vocab: List[str], slots: List[str]):
        super().__init__(vocab)
        self.slots = []
        for slot in slots:
            if slot == "O":
                continue
            self.slots.extend([f"B-{slot}", f"E-{slot}"])
        self._slot_base = len(self.tokens)
        for i, s in enumerate(self.slots):
            self._index[s] = self._slot_base + i
        self.tokens = self.tokens + self.slots

    @staticmethod
    def _norm_tag(tag: str) -> str:
        # accept both bare slot names (the reference's layout) and
        # IOB-prefixed tags; adjacent same-slot words merge into one span
        return tag[2:] if tag[:2] in ("B-", "I-") else tag

    def encode_iob(self, sent: str, iobs: str) -> List[int]:
        words = sent.strip().upper().split()
        tags = [self._norm_tag(t) for t in iobs.strip().split()]
        if words and words[0] == "BOS":
            words, tags = words[1:], tags[1:]
        if words and words[-1] == "EOS":
            words, tags = words[:-1], tags[:-1]
        assert len(words) == len(tags), (sent, iobs)
        ids: List[int] = []
        for i, (word, tag) in enumerate(zip(words, tags)):
            if tag != "O" and (i == 0 or tags[i - 1] != tag):
                ids.append(self._index[f"B-{tag}"])
            ids.extend(self._index.get(c, self.unk_idx) for c in word)
            if tag != "O" and (i == len(words) - 1 or tags[i + 1] != tag):
                ids.append(self._index[f"E-{tag}"])
            if i < len(words) - 1:
                ids.append(self._index[self.SPACE])
        return ids

    def encode(self, text: str) -> List[int]:  # plain text fallback
        return [self._index.get(self.SPACE if c == " " else c, self.unk_idx)
                for c in text.strip().upper()]

    def decode(self, ids: List[int], ignore_repeat: bool = False) -> str:
        parts = []
        prev = None
        for i in ids:
            if ignore_repeat and i == prev:
                continue
            prev = i
            if i < len(self.SPECIALS):
                continue
            tok = self.tokens[i]
            if tok == self.SPACE:
                parts.append(" ")
            elif tok.startswith("B-"):
                parts.append(tok + " ")
            elif tok.startswith("E-") and tok in self.slots:
                parts.append(" " + tok)
            else:
                parts.append(tok)
        return "".join(parts).strip()

    @classmethod
    def from_text(cls, sents: Iterable[str], iob_tags: Iterable[str]) -> "CharacterSlotTokenizer":
        counter = Counter()
        slot_set = set()
        for sent, iobs in zip(sents, iob_tags):
            words = sent.strip().upper().split()
            counter.update(c for w in words for c in w)
            slot_set.update(
                cls._norm_tag(t) for t in iobs.strip().split() if t not in ("O",)
            )
        vocab = [cls.SPACE] + [c for c, _ in sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))]
        return cls(vocab, sorted(slot_set))


TOKENIZER_TYPES["CharacterSlotTokenizer"] = CharacterSlotTokenizer
