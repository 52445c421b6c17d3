"""SUPERB-SG's speech translation in s3prl_tpu_torch vs s3prl_tpu (CPU):
`scaled_dot_attention` (a row with every key masked), the decoder against
flax through `probe_state_dict_from_jax` (a memory row of length 0, the
memory projection), the task's label-smoothed loss, cache and gradients,
`greedy_decode`, `corpus_bleu`, the CoVoST2 preparer and the recipes'
configs (StExample through `Problem.run`:
test_torch_port_translation_recipe). Dropout is 0 (the packages'
generators differ).

Tolerances: attention and logits at atol 1e-5 (f32 sums in other orders);
the loss at rtol 1e-5, predictions equal, gradients at atol 1e-5; the
greedy tokens equal, the test asserting that every step's top-2 logit
margin exceeds 1e-4 (so rounding cannot flip an argmax); BLEU equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.nn.heads as jax_heads
import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.nn.heads as port_heads
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.data.encoder import CharacterTokenizer as JaxTokenizer
from s3prl_tpu.metric.bleu import corpus_bleu as jax_bleu
from s3prl_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from s3prl_tpu.models.decoder import TransformerDecoder as JaxDecoder
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.ops.attention import scaled_dot_attention as jax_attention
from s3prl_tpu.task.speech_translation import SpeechTranslationTask as JaxTask
from s3prl_tpu_torch.data.encoder import CharacterTokenizer
from s3prl_tpu_torch.metric import corpus_bleu
from s3prl_tpu_torch.models.decoder import DecoderConfig, TransformerDecoder
from s3prl_tpu_torch.nn.upstream import UpstreamDownstreamModel
from s3prl_tpu_torch.ops.attention import scaled_dot_attention
from s3prl_tpu_torch.task import SpeechTranslationTask
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_w2v2 import perturbed

KEY = jax.random.key(0)
B, TK, C, L = 4, 9, 32, 3
MEM_LENS = np.asarray([9, 5, 0, 1], np.int32)  # row 2: no key at all
CFG = dict(vocab_size=23, hidden_size=C, num_layers=2, num_heads=4, ffn_size=48, dropout=0.0)
TEXTS = ["ab ba", "abc", "", "ca b"]


def test_attention_matches_jax():
    """q pre-scaled, a causal bias, then key padding replacing scores with
    -1e9: row 2 has every key masked and averages the values uniformly."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, 2, n, 8).astype(np.float32) for n in (6, TK, TK))
    pad = np.arange(TK)[None, :] >= MEM_LENS[:, None]
    bias = np.where(np.tril(np.ones((6, TK), bool)), 0.0, -1e9).astype(np.float32)[None, None]
    for b_ in (None, bias):
        want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
                             None if b_ is None else jnp.asarray(b_))
        got = scaled_dot_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(pad),
                                   None if b_ is None else torch.from_numpy(b_))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2].mean(1, keepdims=True),
                                                                   got[2].shape), atol=1e-6)


def _decoder_pair(memory_size):
    jax_dec = JaxDecoder(JaxDecoderConfig(**CFG))
    tokens = jnp.zeros((B, 7), jnp.int32)
    params = perturbed(jax.jit(jax_dec.init)(KEY, tokens, jnp.zeros((B, TK, memory_size)),
                                             jnp.asarray(MEM_LENS))["params"])
    port = TransformerDecoder(DecoderConfig(**CFG), memory_size=memory_size)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return jax_dec, params, port.eval()


@pytest.mark.parametrize("memory_size", [C, 20])
def test_decoder_matches_flax(memory_size):
    """Logits [B, 7, V] of random tokens over a memory whose row 2 has
    length 0 (and row 3 one frame); at width 20 through memory_proj. The
    converter's keys: embed, self / cross q, k, v, out, ln_*, fc1 / fc2,
    output (and memory_proj), the LayerNorms' scale as weight."""
    jax_dec, params, port = _decoder_pair(memory_size)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, CFG["vocab_size"], (B, 7)).astype(np.int32)
    memory = rng.randn(B, TK, memory_size).astype(np.float32)
    want = jax.jit(lambda p: jax_dec.apply({"params": p}, jnp.asarray(tokens),
                                           jnp.asarray(memory), jnp.asarray(MEM_LENS)))(params)
    got = port(torch.from_numpy(tokens).long(), torch.from_numpy(memory),
               torch.from_numpy(MEM_LENS))
    assert got.shape == (B, 7, CFG["vocab_size"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert (port.memory_proj is None) == (memory_size == C)
    assert "ln_ffn_1.weight" in port.state_dict() and "embed.weight" in port.state_dict()


def _tokenizers():
    vocab = sorted(set("".join(TEXTS).upper()) - {" "}) + ["<space>"]
    return JaxTokenizer(vocab), CharacterTokenizer(vocab)


def _task_pair(max_decode_len=128):
    jax_tok, tok = _tokenizers()
    cfg = dict(CFG, vocab_size=tok.vocab_size)
    jax_task = JaxTask(JaxModel(jax_heads.FrameLevelLinear(C), L),
                       JaxDecoder(JaxDecoderConfig(**cfg)), jax_tok, max_decode_len)
    task = SpeechTranslationTask(
        UpstreamDownstreamModel(port_heads.FrameLevelLinear(24, C), L),
        TransformerDecoder(DecoderConfig(**cfg)), tok, max_decode_len)
    return jax_task, task, tok


def _task_inputs(seed=2):
    rng = np.random.RandomState(seed)
    hs = rng.randn(L, B, TK, 24).astype(np.float32)
    _, tok = _tokenizers()
    ids = [tok.encode(t) for t in TEXTS]
    N = max(len(i) for i in ids)
    class_ids = np.zeros((B, N), np.int32)
    for b, i in enumerate(ids):
        class_ids[b, :len(i)] = i
    batch = {"class_ids": class_ids, "class_ids_len": np.asarray([len(i) for i in ids], np.int32),
             "labels": TEXTS}
    return hs, batch


def _init(jax_task, task, hs, batch):
    params = perturbed(jax.jit(lambda k, x: jax_task.init_params(
        k, x, jnp.asarray(MEM_LENS), batch))(KEY, jnp.asarray(hs)))
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    assert set(task.module.state_dict()) == set(probe_state_dict_from_jax(params))
    return params


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_task_loss_matches_jax(train):
    """Teacher forcing with <eos> at each target's length (an empty
    target: <eos> alone), the label-smoothed CE (0.1) masked by the target
    lengths, the cache, every gradient, and the reduction's loss and BLEU
    on the same records."""
    jax_task, task, _ = _task_pair()
    hs, batch = _task_inputs()
    params = _init(jax_task, task, hs, batch)
    (want, want_cache), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(MEM_LENS), batch, KEY,
                                          train), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(MEM_LENS), batch,
                                      None, train)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert cache.keys() == want_cache.keys()
    for k in ("prediction", "prediction_len"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(want_cache[k]), err_msg=k)
    loss.backward()
    grads = probe_state_dict_from_jax(grads)
    for k, p in task.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    records = [{**{k: np.asarray(v) for k, v in want_cache.items()}, "labels": TEXTS}]
    assert task.reduction("valid", records) == jax_task.reduction("valid", records)


def test_greedy_decode_matches_jax():
    """16 greedy steps over the whole token buffer: the tokens equal,
    <pad> after each row's <eos> (the output bias leans toward <eos> so
    rows stop at different steps), every step's top-2 margin above 1e-4."""
    jax_task, task, tok = _task_pair(max_decode_len=16)
    hs, batch = _task_inputs(3)
    params = _init(jax_task, task, hs, batch)
    bias = np.array(params["decoder"]["output"]["bias"])
    bias[tok.eos_idx] += 1.5
    params["decoder"]["output"]["bias"] = bias
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    want = jax_task.greedy_decode(params, jnp.asarray(hs), jnp.asarray(MEM_LENS))
    got = task.greedy_decode(torch.from_numpy(hs), torch.from_numpy(MEM_LENS))
    assert got.shape == want.shape == (B, 16)
    np.testing.assert_array_equal(got, want)
    stops = [int(np.argmax(row == tok.eos_idx)) if (row == tok.eos_idx).any() else 16
             for row in got]
    assert len(set(stops)) > 1 and min(stops) < 16, stops
    for b, stop in enumerate(stops):
        assert (got[b, stop + 1:] == tok.pad_idx).all()
    # the margins: each step's logits are the final buffer's at that step
    # (the decoder is causal)
    buffer = torch.cat([torch.full((B, 1), tok.eos_idx), torch.from_numpy(got).long()], 1)
    with torch.no_grad():
        memory, lens = task.module["encoder"](torch.from_numpy(hs), torch.from_numpy(MEM_LENS))
        logits = task.module["decoder"](buffer, memory, lens)
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    for b, stop in enumerate(stops):
        assert margin[b, :min(stop + 1, 16)].min() > 1e-4, (b, margin[b])


def test_corpus_bleu_matches_jax():
    """Identical, partial, empty and length-mismatched hypotheses."""
    refs = ["the cat sat on the mat", "a b c d e", "hello world again", "x y"]
    for hyps in (refs, ["the cat sat on a mat", "a b c d", "", "x y z"],
                 ["", "", "", ""], ["the the the the", "a b c d e f g", "hello world", "y x"]):
        assert corpus_bleu(hyps, refs) == jax_bleu(hyps, refs)
    assert corpus_bleu(refs, refs) == 100.0 and corpus_bleu([""] * 4, refs) == 0.0


@pytest.mark.parametrize("name", ["SuperbST", "StExample"])
def test_default_config_matches_jax(name):
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()


def test_covost_preparer_equals_jax(tmp_path):
    """Stage 0 of SuperbST on CoVoST2's en-de tsv files (the dev split
    written as valid), byte for byte."""
    tsv = tmp_path / "covost"
    tsv.mkdir()
    for split in ("train", "dev", "test"):
        (tsv / f"covost_v2.en_de.{split}.tsv").write_text(
            "path\tsentence\ttranslation\tclient_id\n"
            + "".join(f"clips/{split}_{i}.mp3\thello {i}\thallo {i}\tc{i}\n" for i in range(3)))
    cfg = {"prepare_data": {"covost_tsv": str(tsv), "audio_root": "/corpus/cv"}}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        (jax_problem if pkg == "jax" else port_problem).SuperbST().prepare_data(tmp_path / pkg,
                                                                                cfg)
    for name in ("train.csv", "valid.csv", "test.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
