"""The staged classification recipes of s3prl_tpu_torch vs s3prl_tpu (CPU),
through `Problem.run`: CommonExample and IcExample on pseudo audio
(`test_torch_port_superb.py`: SuperbSID's stages 1-3 on a fake corpus).

Both packages get the tiny trunk of `test_torch_port_probe` (the same
weights) through a recipe subclass whose `build_upstream` returns it, and
the port's probe starts from the JAX probe's initial params (the recipes'
fbank default is not ported). Everything else is the recipes' own: their
CSVs, encoders, samplers, bucketed collation, trainer, checkpoints and
evaluation. Tolerances: the test accuracy equal, losses at rtol 1e-5 and
the final probe parameters at atol 1e-6 (f32 sums in other orders).
"""

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu_torch.nn.upstream import SUpstream
from s3prl_tpu_torch.train import checkpoint as ckpt
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_probe import _wrap, tiny_pair  # noqa: F401 (fixture)
from test_torch_port_train import _losses, capture_init, start_from

TRAIN = {"tensorboard": False}


def _recipes(name, tiny_pair):
    """(JAX recipe, port recipe) of problem `name` on the tiny trunk."""
    jax_up, port_up = tiny_pair
    captured = {}

    class JaxTiny(getattr(jax_problem, name)):
        def build_upstream(self, **kwargs):
            return _wrap(JaxSUpstream, jax_up, False)

        def build_task(self, *args):
            task = super().build_task(*args)
            capture_init(task, captured)
            return task

    class PortTiny(getattr(port_problem, name)):
        def build_upstream(self, **kwargs):
            return _wrap(SUpstream, port_up, False)

        def build_task(self, *args):
            return start_from(super().build_task(*args), captured)

    return JaxTiny(), PortTiny()


def _run_both(tmp_path, tiny_pair, name, **overrides):
    jax_recipe, port_recipe = _recipes(name, tiny_pair)
    config = jax_recipe.default_config()
    config.pop("target_dir")
    for key, value in overrides.items():
        config[key] = {**config.get(key, {}), **value} if isinstance(value, dict) else value
    config["train"] = {**config["train"], **TRAIN}
    start = config.pop("start", 0)
    jax_recipe.run(str(tmp_path / "jax"), start=start, **config)
    port_recipe.run(str(tmp_path / "port"), start=start, **config)
    return port_recipe, config


def _same_results(tmp_path):
    want = yaml.safe_load((tmp_path / "jax" / "result.yaml").read_text())
    got = yaml.safe_load((tmp_path / "port" / "result.yaml").read_text())
    assert got.keys() == want.keys() == {"test"}
    assert got["test"]["accuracy"] == want["test"]["accuracy"]
    np.testing.assert_allclose(got["test"]["loss"], want["test"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(_losses(tmp_path / "port" / "train"),
                               _losses(tmp_path / "jax" / "train"), rtol=1e-5)
    for d in ("valid_best", "step_4"):
        jax_dir, port_dir = tmp_path / "jax" / "train" / d, tmp_path / "port" / "train" / d
        assert port_dir.exists() == jax_dir.exists(), d
        if not jax_dir.exists():
            continue
        params = serialization.msgpack_restore((jax_dir / "params.msgpack").read_bytes())
        want_sd = probe_state_dict_from_jax(params)
        got_sd = torch.load(port_dir / "model.pt")
        assert got_sd.keys() == want_sd.keys()
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{d} {k}")


@pytest.mark.parametrize("name", ["CommonExample", "IcExample"])
def test_example_recipe_matches_jax(tmp_path, tiny_pair, name):
    """All four stages; then stage 2 again auto-resumes at step 4 and
    trains no step."""
    port_recipe, config = _run_both(tmp_path, tiny_pair, name)
    assert (tmp_path / "port" / "encoder.json").read_text() == \
        (tmp_path / "jax" / "encoder.json").read_text()
    _same_results(tmp_path)
    train_dir = tmp_path / "port" / "train"
    lines = (train_dir / "metrics.jsonl").read_text().splitlines()
    port_recipe.run(str(tmp_path / "port"), start=2, stop=2, **config)
    assert (train_dir / "metrics.jsonl").read_text().splitlines() == lines
    assert ckpt.latest_checkpoint(train_dir).name == "step_4"
