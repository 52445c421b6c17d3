"""SUPERB's SLU recipes in s3prl_tpu_torch vs s3prl_tpu (CPU): the
SluTransformerHead (projector, a 2-layer Mockingjay encoder, SAP, final)
against flax through `probe_state_dict_from_jax` (logits, every gradient
and one AdamW update), its dropout from the caller's generator, the ATIS,
SNIPS and CMU-MOSEI preparers on fake trees, `_bin_sentiment`, the four
recipes' default configs and SluExample through `Problem.run`.

The packages' random streams differ, so the encoder's dropout is 0 on both
sides in the parity tests: the JAX side's `MockingjayConfig` (which
slu.py builds inside the head) is patched with monkeypatch, the port's
likewise; nothing in s3prl_tpu is edited. Tolerances: logits at atol 5e-4
(they agree to ~1e-6), gradients at atol 1e-5, the parameters after one
AdamW 2e-4 update at atol 5e-4 (Adam's first move is lr x sign(g), and a
gradient within rounding of zero has the rounding's sign); the recipe run
by `test_torch_port_frame_probe`'s rules, with SAP's score bias and the
attention keys' biases as shifts (each adds one value to every score of a
softmax row, so its gradient is zero but for rounding).
"""

import numpy as np
import optax
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

import jax

import s3prl_tpu.models.mockingjay as jax_mockingjay
import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
import s3prl_tpu_torch.problem.slu as port_slu
from s3prl_tpu.problem.slu import SluTransformerHead as JaxHead
from s3prl_tpu.train.optimizers import build_optimizer
from s3prl_tpu_torch.models.mockingjay import MockingjayConfig
from s3prl_tpu_torch.nn import UpstreamDownstreamModel, init_params
from s3prl_tpu_torch.problem import Problem
from s3prl_tpu_torch.problem.slu import SluTransformerHead
from s3prl_tpu_torch.train import Optimizer
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_frame_probe import (results, run_both, same_csvs, same_metrics,  # noqa: F401
                                         same_states, same_training, tiny_pair)
from test_torch_port_mel_ssl import with_defaults
from test_torch_port_w2v2 import perturbed

B, T, C, CLASSES = 4, 30, 24, 5
LENS = np.asarray([30, 17, 5, 1], np.int32)
HEAD = dict(input_dim=64, num_layers=2, num_heads=4, ffn_size=128)
RECIPES = ["SluATIS", "SluAudioSnips", "MoseiSentiment", "SluExample"]


@pytest.fixture
def no_dropout(monkeypatch):
    """The heads' encoders without dropout in both packages."""
    monkeypatch.setattr(jax_mockingjay, "MockingjayConfig", with_defaults(
        jax_mockingjay.MockingjayConfig, hidden_dropout_prob=0.0))
    monkeypatch.setattr(port_slu, "MockingjayConfig", with_defaults(
        MockingjayConfig, hidden_dropout_prob=0.0))


def _pair():
    rng = np.random.RandomState(0)
    xs = rng.randn(B, T, C).astype(np.float32)
    jax_head = JaxHead(CLASSES, **HEAD)
    params = perturbed(jax_head.init(jax.random.key(0), xs, LENS)["params"])
    port = SluTransformerHead(C, CLASSES, **HEAD)
    port.load_state_dict(probe_state_dict_from_jax(params))
    return jax_head, params, port, xs


def test_head_matches_flax(no_dropout):
    """In train mode (dropout 0): logits on rows of 30, 17, 5 and 1 frames;
    the CE loss's gradient of every parameter against jax.grad; one AdamW
    update (the recipe's 2e-4, clip 1.0) through both packages' optimizers."""
    jax_head, params, port, xs = _pair()
    labels = np.asarray([0, 3, 4, 1])

    def loss_fn(p):
        logits = jax_head.apply({"params": p}, xs, LENS, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

    (loss, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port.train()
    got = port(torch.from_numpy(xs), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4, rtol=0)
    port_loss = F.cross_entropy(got, torch.from_numpy(labels))
    np.testing.assert_allclose(port_loss.item(), float(loss), rtol=1e-5)
    port_loss.backward()
    want_grads = probe_state_dict_from_jax(grads)
    named = dict(port.named_parameters())
    assert named.keys() == want_grads.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    tx = build_optimizer("AdamW", lr=2e-4, total_steps=1000)
    updates, _ = tx.update(grads, tx.init(params), params)
    stepped = probe_state_dict_from_jax(optax.apply_updates(params, updates))
    Optimizer(port.parameters(), name="AdamW", lr=2e-4, total_steps=1000).step()
    for k, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), stepped[k].numpy(), atol=5e-4, rtol=0, err_msg=k)


def test_converter_maps_the_encoder():
    """A probe tree holding the head: the encoder's scanned blocks [L, in,
    out] map onto encoder.encoder.layer.{i} (no conv kernels), the rest by
    flax's names, every shape the port module's."""
    _, params, port, _ = _pair()
    model = UpstreamDownstreamModel(port, 3)
    sd = probe_state_dict_from_jax({"featurizer": {"weights": np.zeros(3, np.float32)},
                                    "downstream": params})
    want = model.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    assert "downstream.encoder.encoder.layer.1.attention.self.query.weight" in sd


def test_head_dropout_draws_from_the_generator():
    """The recipe's encoder drops 0.1 after the input LN and each sublayer
    in train(), from the caller's generator; eval() is deterministic."""
    port = SluTransformerHead(C, CLASSES, **HEAD)
    init_params(port, torch.Generator().manual_seed(1))
    xs, lens = torch.randn(B, T, C), torch.from_numpy(LENS)
    port.eval()
    ref = port(xs, lens)
    assert torch.equal(ref, port(xs, lens, generator=torch.Generator().manual_seed(3)))
    port.train()
    a = port(xs, lens, generator=torch.Generator().manual_seed(7))
    b = port(xs, lens, generator=torch.Generator().manual_seed(7))
    c = port(xs, lens, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)


# -- the recipes ----------------------------------------------------------------------


def _atis(root):
    (root / "nlu_iob").mkdir(parents=True)
    rows = {"train": [("utt1 BOS show me flights EOS", "O O O O atis_flight"),
                      ("utt2 BOS what fares EOS", "O O B-fare atis_airfare")],
            "dev": [("utt3 BOS cheapest EOS", "O B-cost atis_airfare")],
            "test": [("utt4 BOS ground transport EOS", "O O O atis_ground_service"),
                     ("utt5 BOS flights EOS", "O O atis_flight")]}
    for name, lines in rows.items():
        (root / "nlu_iob" / f"iob.{name}").write_text(
            "".join(f"{a}\t{b}\n" for a, b in lines))
    return {"atis": str(root)}


def _snips(root):
    (root / "data" / "nlu_annotation").mkdir(parents=True)
    for split, n in (("train", 3), ("valid", 2), ("test", 2)):
        df = pd.DataFrame({"id": [f"{split}-{i}" for i in range(n)],
                           "transcript": ["turn on the lights"] * n,
                           "annotation": [f"O O B-obj SwitchLightOn{i % 2}" for i in range(n)]})
        df.to_csv(root / "data" / "nlu_annotation" / split, sep="\t", index=False)
    return {"audio_slu": str(root), "train_speakers": ["Aditi", "Amy"],
            "test_speakers": ["Brian"]}


def _mosei(root, num_class):
    root.mkdir(parents=True)
    scores = [-3.4, -1.5, -0.5, 0.0, 0.5, 1.5, 2.5, 3.0]
    df = pd.DataFrame({"file": [f"clip{i}" for i in range(len(scores))],
                       "sentiment": scores,
                       "split": ["train", "train", "valid", "test"] * 2})
    df.to_csv(root / "labels.csv", index=False)
    return {"mosei_audio": str(root / "wavs"), "label_csv": str(root / "labels.csv"),
            "num_class": num_class}


PREPARERS = {"SluATIS": _atis, "SluAudioSnips": _snips,
             "MoseiSentiment 2": lambda r: _mosei(r, 2), "MoseiSentiment 3": lambda r: _mosei(r, 3),
             "MoseiSentiment 7": lambda r: _mosei(r, 7)}


@pytest.mark.parametrize("case", list(PREPARERS))
def test_preparer_csvs_equal_jax(tmp_path, case):
    """Stage 0 on a fake corpus tree: the same CSVs byte for byte."""
    cfg = {"prepare_data": PREPARERS[case](tmp_path / "corpus")}
    name = case.split()[0]
    for pkg, ws in ((jax_problem, tmp_path / "jax"), (port_problem, tmp_path / "port")):
        ws.mkdir()
        getattr(pkg, name)().prepare_data(ws, cfg)
    csvs = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert csvs == sorted(p.name for p in (tmp_path / "port").glob("*.csv"))
    assert csvs == ["test.csv", "train.csv", "valid.csv"]
    same_csvs(tmp_path, csvs)


@pytest.mark.parametrize("num_class", [2, 3, 6, 7])
def test_bin_sentiment_equals_jax(num_class):
    for score in np.linspace(-4.0, 4.0, 33):
        assert port_problem.MoseiSentiment._bin_sentiment(float(score), num_class) == \
            jax_problem.MoseiSentiment._bin_sentiment(float(score), num_class)


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_matches_jax(name):
    """The four recipes' defaults key for key; the CLI finds each."""
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
    assert Problem.get_class_from_name(name) is getattr(port_problem, name)


def test_slu_example_matches_jax(tmp_path, same_states, no_dropout):
    """SluExample's four stages on the tiny trunk's states in both
    packages: the CSVs, the transformer head's training (accumulation 2)
    and the test accuracy."""
    run_both(tmp_path, same_states, "SluExample")
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv"])
    same_training(tmp_path, 2e-4, shifts=("sap.attn.bias", "attention.self.key.bias"))
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("accuracy",))
