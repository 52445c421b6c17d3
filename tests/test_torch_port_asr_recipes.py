"""The CTC recipes of s3prl_tpu_torch vs s3prl_tpu (CPU), through
`Problem.run`: AsrExample on pseudo audio, SuperbASR's data and tokenizer
stages on a tiny LibriSpeech tree of FLAC files, single-file transcription
(`inference`) of a FLAC file, and the recipes' configurations.

Both packages get the tiny trunk of `test_torch_port_probe` through a recipe
subclass whose `build_upstream` returns it, and the port's probe starts
from the JAX probe's initial params (the recipes' fbank default is not
ported). The probes' dropout is set to 0: the two packages draw their masks
from different generators. Everything else is the recipes' own. SuperbPR
and SuperbSF: test_torch_port_asr_superb.

Tolerances: losses and gradient norms at rtol 1e-5, the test metrics
equal; the probe parameters at test_torch_port_recipes' atol 1e-6 (lr /
100 above an Adam rate of 1e-4), but for at most 1 in 1,000 elements of a
tensor, which stay within 2 lr an update: Adam's first moves are about lr
x sign(g), and the LSTM's input kernels hold weights whose gradient is
within f32 rounding of zero, so their sign, and with it their move, is
the rounding's (measured: 2 of 16,384 weights 2.8e-5 apart after two
updates of 1e-4).
"""

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from flax import serialization

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.data.flac import write_flac as jax_write_flac
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu_torch.data.flac import write_flac
from s3prl_tpu_torch.nn.upstream import SUpstream
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_probe import _wrap, tiny_pair  # noqa: F401 (fixture)
from test_torch_port_train import _losses, capture_init, start_from

SMALL = {"hidden_size": 16, "num_layers": 1, "proj_size": 16, "dropout": 0.0}
TRAIN = {"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2, "tensorboard": False}


def _pseudo(base, pkg):
    """Recipe `base` of package `pkg` on AsrExample's pseudo data."""
    return type(f"Pseudo{base}", (getattr(pkg, base),),
                {"prepare_data": getattr(pkg, "AsrExample").prepare_data})


def _recipes(bases, tiny_pair):
    """(JAX recipe, port recipe) on the tiny trunk; `bases` the two
    packages' recipe classes."""
    jax_up, port_up = tiny_pair
    captured = {}

    class JaxTiny(bases[0]):
        def build_upstream(self, **kwargs):
            return _wrap(JaxSUpstream, jax_up, False)

        def build_task(self, *args):
            task = super().build_task(*args)
            capture_init(task, captured)
            return task

    class PortTiny(bases[1]):
        def build_upstream(self, **kwargs):
            return _wrap(SUpstream, port_up, False)

        def build_task(self, *args):
            return start_from(super().build_task(*args), captured)

    return JaxTiny(), PortTiny()


def _run_both(tmp_path, recipes, stop=None, **overrides):
    jax_recipe, port_recipe = recipes
    config = jax_recipe.default_config()
    config.pop("target_dir")
    for key, value in overrides.items():
        config[key] = {**config.get(key, {}), **value} if isinstance(value, dict) else value
    jax_recipe.run(str(tmp_path / "jax"), stop=stop, **config)
    port_recipe.run(str(tmp_path / "port"), stop=stop, **config)
    assert (tmp_path / "port" / "tokenizer.json").read_text() == \
        (tmp_path / "jax" / "tokenizer.json").read_text()
    return config


def _close_probe(got, want, lr, updates, what):
    """A probe tensor after `updates` Adam updates of rate `lr`: every
    element at atol max(1e-6, lr / 100), but for at most 1 in 1,000 of
    them, which stay within Adam's largest move, 2 lr an update (module
    docstring)."""
    err, atol = np.abs(got - want), max(1e-6, lr / 100)
    assert (err > atol).mean() <= 1e-3 and err.max() <= 2 * lr * updates + atol, \
        (what, int((err > atol).sum()), float(err.max()))


def _same_results(tmp_path, metrics, lr, accumulate=1, rtol=1e-5):
    want = yaml.safe_load((tmp_path / "jax" / "result.yaml").read_text())
    got = yaml.safe_load((tmp_path / "port" / "result.yaml").read_text())
    assert got.keys() == want.keys() == {"test"}
    assert set(got["test"]) == set(want["test"]) == {"loss", *metrics}
    np.testing.assert_allclose(got["test"]["loss"], want["test"]["loss"], rtol=rtol)
    for name in metrics:
        assert got["test"][name] == want["test"][name], name
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_losses(tmp_path / "port" / "train", key),
                                   _losses(tmp_path / "jax" / "train", key), rtol=rtol)
    steps = {"valid_best": 2, "step_2": 2, "step_4": 4}
    for d in steps:
        jax_dir, port_dir = tmp_path / "jax" / "train" / d, tmp_path / "port" / "train" / d
        assert port_dir.exists() == jax_dir.exists(), d
        if not jax_dir.exists():
            continue
        params = serialization.msgpack_restore((jax_dir / "params.msgpack").read_bytes())
        want_sd = probe_state_dict_from_jax(params)
        got_sd = torch.load(port_dir / "model.pt")
        assert got_sd.keys() == want_sd.keys()
        for k in want_sd:
            _close_probe(got_sd[k].numpy(), want_sd[k].numpy(), lr, steps[d] // accumulate,
                         f"{d} {k}")


def test_asr_example_and_inference_match_jax(tmp_path, tiny_pair, capsys):
    """AsrExample's four stages (character CTC, batch 2 sorted by length,
    valid every 2 steps, Adam 1e-4); then `inference` of a FLAC file from
    valid_best in both packages: the same text, printed as ``<name>
    <text>`` and appended to inference.txt."""
    recipes = _recipes((jax_problem.AsrExample, port_problem.AsrExample), tiny_pair)
    config = _run_both(tmp_path, recipes, build_downstream={"dropout": 0.0}, train=TRAIN)
    _same_results(tmp_path, ("wer", "cer"), lr=1e-4)
    rng = np.random.RandomState(5)
    flac = tmp_path / "say.flac"
    write_flac(flac, (rng.randn(14000) * 3000).astype(np.int32), 16000)
    capsys.readouterr()
    want = recipes[0].inference(tmp_path / "jax", config, str(flac))
    got = recipes[1].inference(tmp_path / "port", config, str(flac))
    assert isinstance(got, str) and got == want
    assert capsys.readouterr().out.splitlines()[-1] == f"say {got}"
    assert (tmp_path / "port" / "inference.txt").read_text() == f"say {got}\n"


def test_superb_asr_prepares_a_flac_librispeech(tmp_path, tiny_pair):
    """SuperbASR's stages 0 and 1 on a LibriSpeech tree of FLAC files
    (written by the JAX package): the same CSVs and tokenizer, and the
    port's dataset decodes each file to the JAX dataset's samples."""
    from s3prl_tpu.data.dataset import Speech2TextDataset as JaxDataset
    from s3prl_tpu.data.encoder import load_tokenizer as jax_load_tokenizer
    from s3prl_tpu_torch.data.dataset import Speech2TextDataset
    from s3prl_tpu_torch.data.encoder import load_tokenizer

    rng = np.random.RandomState(1)
    root = tmp_path / "LibriSpeech"
    for split in ("train-clean-100", "dev-clean", "test-clean"):
        d = root / split / "103" / "1240"
        d.mkdir(parents=True)
        texts = {f"103-1240-{i:04d}": f"CHAPTER {split.upper()} WORD {i}" for i in range(2)}
        for uid in texts:
            jax_write_flac(d / f"{uid}.flac",
                           (rng.randn(int(16000 * rng.uniform(0.3, 0.6))) * 2000).astype(np.int32),
                           16000)
        (d / "103-1240.trans.txt").write_text("".join(f"{u} {t}\n" for u, t in texts.items()))
    recipes = _recipes((jax_problem.SuperbASR, port_problem.SuperbASR), tiny_pair)
    _run_both(tmp_path, recipes, stop=1, prepare_data={"librispeech": str(root)})
    for name in ("train.csv", "valid.csv", "test.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    csv = tmp_path / "port" / "train.csv"
    assert pd.read_csv(csv)["wav_path"].str.endswith(".flac").all()
    got = Speech2TextDataset(csv, load_tokenizer(tmp_path / "port" / "tokenizer.json"))
    want = JaxDataset(csv, jax_load_tokenizer(tmp_path / "jax" / "tokenizer.json"))
    for i in range(len(want)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["class_ids"], b["class_ids"])
        assert a["labels"] == b["labels"] and a["unique_name"] == b["unique_name"]
    assert got.lengths == want.lengths


@pytest.mark.parametrize("name", ["SuperbASR", "SuperbPR", "SuperbSF", "AsrExample"])
def test_recipe_configs_match_jax(name):
    """default_config as the JAX recipe's, and the CLI registry finds the
    class by name."""
    assert port_problem.Problem.get_class_from_name(name) is getattr(port_problem, name)
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
