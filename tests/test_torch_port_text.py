"""The CTC recipes' text pipeline of s3prl_tpu_torch vs s3prl_tpu (CPU): the
tokenizers (character, word, phoneme, character + slot, BPE subword), their
JSON files loaded across the packages, the edit-distance and slot metrics,
and the LibriSpeech and Audio SNIPS preparers. All of it is host code
copied from the JAX package, so everything is compared for equality: ids,
text, metric values and the CSVs' bytes."""

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import s3prl_tpu.data.bpe as jax_bpe
import s3prl_tpu.data.encoder as jax_encoder
import s3prl_tpu.metric as jax_metric
import s3prl_tpu_torch.data.bpe as port_bpe
import s3prl_tpu_torch.data.encoder as port_encoder
import s3prl_tpu_torch.metric as port_metric
from s3prl_tpu.data.corpus.librispeech import prepare_librispeech_asr as jax_librispeech
from s3prl_tpu.data.corpus.snips import prepare_snips as jax_snips
from s3prl_tpu_torch.data.corpus.librispeech import prepare_librispeech_asr
from s3prl_tpu_torch.data.corpus.snips import prepare_snips

LINES = ["hello world", "good day to you", "speech  test ", "THE cat's hat", "aaa bb a",
         "hello there world"]
PROBES = ["hello", "world day", "unseen QZ!", "", "a  b", "bb aaa cat's"]
SLOT_SENTS = ["BOS play some jazz music EOS", "set the alarm for seven am",
              "book a table in new york"]
SLOT_IOBS = ["O O O B-genre O O", "O O O O B-time I-time",
             "O O O O B-city I-city"]


def _build(pkg, kind):
    """A tokenizer of `kind` from the same text in package `pkg`'s modules."""
    enc, bpe = pkg
    if kind == "character":
        return enc.CharacterTokenizer.from_text(LINES)
    if kind == "word":
        return enc.WordTokenizer.from_text(LINES, vocab_size=6)
    if kind == "phoneme":
        return enc.PhonemeTokenizer.from_text(LINES, vocab_size=100000)
    if kind == "slot":
        return enc.CharacterSlotTokenizer.from_text(SLOT_SENTS, SLOT_IOBS)
    return bpe.SubwordTokenizer.from_text(LINES * 3, vocab_size=40)


JAX, PORT = (jax_encoder, jax_bpe), (port_encoder, port_bpe)
KINDS = ["character", "word", "phoneme", "slot", "subword"]


@pytest.mark.parametrize("kind", KINDS)
def test_tokenizer_matches_jax(kind):
    """from_text's vocabulary, encode and decode (with and without
    collapsing repeats) equal in both packages."""
    want, got = _build(JAX, kind), _build(PORT, kind)
    assert got.tokens == want.tokens and got.vocab_size == want.vocab_size
    assert (got.pad_idx, got.unk_idx, got.eos_idx) == (want.pad_idx, want.unk_idx, want.eos_idx)
    for text in PROBES + LINES:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        noisy = [0] + ids + ids[-1:] + [0, 1] + ids[:2]
        for repeat in (False, True):
            assert got.decode(noisy, ignore_repeat=repeat) == \
                want.decode(noisy, ignore_repeat=repeat)


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("kind", KINDS)
def test_tokenizer_files_load_across_packages(tmp_path, kind, direction):
    """A tokenizer saved by one package loads through the other's
    load_tokenizer with the same tokens, ids and text."""
    src, dst = (PORT, jax_encoder) if direction == "port->jax" else (JAX, port_encoder)
    tok = _build(src, kind)
    tok.save(tmp_path / "tokenizer.json")
    loaded = dst.load_tokenizer(tmp_path / "tokenizer.json")
    assert type(loaded).__name__ == type(tok).__name__ and loaded.tokens == tok.tokens
    for text in PROBES:
        assert loaded.encode(text) == tok.encode(text)
        assert loaded.decode(tok.encode(text)) == tok.decode(tok.encode(text))


def test_train_bpe_matches_jax():
    for size in (12, 30, 60):
        for lower in (False, True):
            assert port_bpe.train_bpe(LINES * 2, size, lower) == \
                jax_bpe.train_bpe(LINES * 2, size, lower)


@pytest.mark.parametrize("sent,iob", list(zip(SLOT_SENTS, SLOT_IOBS)) + [
    ("wake me at six", "O O O time"), ("BOS a b c EOS", "O B-x I-x B-y O")])
def test_encode_iob_matches_jax(sent, iob):
    """CharacterSlotTokenizer.encode_iob (BOS / EOS dropped, B- / I- tags
    and bare slot names, adjacent same-slot words merged) and the slot
    markup its decode renders."""
    want = jax_encoder.CharacterSlotTokenizer.from_text(SLOT_SENTS + [sent], SLOT_IOBS + [iob])
    got = port_encoder.CharacterSlotTokenizer.from_text(SLOT_SENTS + [sent], SLOT_IOBS + [iob])
    ids = got.encode_iob(sent, iob)
    assert ids == want.encode_iob(sent, iob)
    assert got.decode(ids) == want.decode(ids)


WORDS = st.lists(st.sampled_from(["a", "b", "ab", "ba", "c", "the", "B-x", "E-x", "B-y",
                                  "E-y"]), max_size=8).map(" ".join)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(WORDS, WORDS), min_size=1, max_size=4))
def test_metrics_match_jax(pairs):
    """edit distance, TER / WER / PER / CER and the slot metrics equal the
    JAX package's on the same hypotheses and references."""
    hyps, refs = [h for h, _ in pairs], [r for _, r in pairs]
    for h, r in pairs:
        assert port_metric.edit_distance(h, r) == jax_metric.edit_distance(h, r)
    for name in ("wer", "per", "cer", "slot_type_f1", "slot_value_cer", "slot_value_wer",
                 "slot_edit_f1_full", "slot_edit_f1_part"):
        assert getattr(port_metric, name)(hyps, refs) == getattr(jax_metric, name)(hyps, refs), name
    split = [h.split() for h in hyps], [r.split() for r in refs]
    assert port_metric.ter(*split) == jax_metric.ter(*split)


def _librispeech(root):
    """Three splits, two speakers, a .trans.txt each chapter; one utterance
    in the transcript has no audio (skipped), audio as .wav and .flac."""
    for split in ("train-clean-100", "dev-clean", "test-clean"):
        for spk, chap in (("19", "198"), ("26", "495")):
            d = root / split / spk / chap
            d.mkdir(parents=True)
            ids = [f"{spk}-{chap}-{i:04d}" for i in range(3)]
            (d / f"{spk}-{chap}.trans.txt").write_text(
                "".join(f"{u} SOME WORDS {i}\n" for i, u in enumerate(ids)))
            (d / f"{ids[0]}.flac").write_bytes(b"")
            (d / f"{ids[1]}.wav").write_bytes(b"")
    return root


def _snips(root):
    """all.iob.snips.txt in both layouts and wavs of train, valid and test
    speakers (one of another split's speaker, one without a transcript)."""
    lines, tab = [], True
    for split, spks in (("train", ["Ivy", "Joey", "Amy"]), ("valid", ["Aditi"]),
                        ("test", ["Brian", "Emma"])):
        for spk in spks:
            d = root / split / spk
            d.mkdir(parents=True)
            for i in range(2):
                uid = f"{spk}-snips-{split}-{i}"
                (d / f"{uid}.wav").write_bytes(b"")
                if i == 1 and spk == "Joey":
                    continue
                if tab:
                    lines.append(f"{uid} BOS play jazz now EOS\tO O B-genre O O")
                else:
                    lines.append(f"{uid} set:O alarm:O seven:B-time am:I-time")
                tab = not tab
    (root / "all.iob.snips.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("corpus", ["librispeech", "snips"])
def test_corpus_preparers_write_the_jax_csvs(tmp_path, corpus):
    if corpus == "librispeech":
        root = _librispeech(tmp_path / "LibriSpeech")
        prepare, want_prepare, kw = prepare_librispeech_asr, jax_librispeech, {"librispeech": root}
    else:
        root = _snips(tmp_path / "snips")
        prepare, want_prepare, kw = prepare_snips, jax_snips, {"snips": root}
    for name, fn in (("port", prepare), ("jax", want_prepare)):
        (tmp_path / name).mkdir()
        fn(tmp_path / name, **kw)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.csv")) == \
        ["test.csv", "train.csv", "valid.csv"]
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert len(pd.read_csv(tmp_path / "port" / name)) > 0
    assert np.all(pd.read_csv(tmp_path / "port" / "train.csv")["id"].notna())
