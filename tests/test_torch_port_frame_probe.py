"""The TERA-era frame probes of s3prl_tpu_torch vs s3prl_tpu (CPU): each
recipe's task (its head, FrameClassificationTask or the utterance task)
on the same states with the JAX params carried across, FrameProbeExample
through `Problem.run`, the phone and speaker preparers' CSVs, and the
eleven recipes' default configs.

The recipe helpers here serve the QbE, HEAR and MOS tests too: both
packages train on the states of the port's tiny trunk (the JAX recipe's
upstream runs it through a host callback, `_mirror`), the port's probe
starting from the JAX probe's initial params (`capture_init`,
`start_from`); a JAX recipe that builds its SUpstream itself gets the
mirror by monkeypatch. Dropout is 0 (the packages' generators differ).

Tolerances: losses at rtol 1e-5; the task caches' counts and predictions
equal; gradients at atol 1e-5; the preparers' CSVs byte for byte (the
workspace prefix aside); after training, the metrics equal, the losses at
rtol 1e-5 and each saved probe parameter by the CTC recipes' rule
(`_close_probe`: atol max(1e-6, lr / 100) but for 1 in 1,000 elements,
which stay within 2 lr an update). A bias that adds one value to every
logit of a softmax (an attention pooling's score bias) has a gradient of
zero but for rounding, which Adam scales to a move of up to lr: such
parameters (`shifts`) are held within 2 lr an update.
"""

import types

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.data.encoder import CategoryEncoder as JaxEncoder
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu_torch.data.encoder import CategoryEncoder
from s3prl_tpu_torch.nn.upstream import SUpstream
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_asr_recipes import _close_probe
from test_torch_port_probe import _wrap, tiny_pair  # noqa: F401 (fixture)
from test_torch_port_speaker_recipes import _mirror
from test_torch_port_train import _losses, capture_init, start_from
from test_torch_port_w2v2 import perturbed

FRAME_RECIPES = ["LibriPhoneLinear", "LibriPhone1Hidden", "LibriPhoneConcat",
                 "TimitPhoneConvBank", "TimitPhoneLinear", "TimitPhone1Hidden",
                 "TimitPhoneConcat", "SpeakerLinearUtter", "SpeakerLinearFrame",
                 "Voxceleb1FrameLevel", "FrameProbeExample"]
KEY = jax.random.key(0)  # the JAX tasks' dropout key (dropout 0)


# -- the recipe helpers (also used by the QbE, HEAR and MOS tests) ------------------


@pytest.fixture(scope="module")
def same_states(tiny_pair):  # noqa: F811 (fixture)
    """(the JAX upstream on the port's trunk, the port's upstream)."""
    return _mirror(tiny_pair[1]), tiny_pair[1]


def recipe_pair(name, same_states, monkeypatch=None, jax_modules=()):
    """(JAX recipe, port recipe) of problem `name` on the same states; the
    JAX modules in `jax_modules` that build their SUpstream themselves get
    the mirror."""
    jax_up, port_up = same_states
    captured = {}
    if monkeypatch is not None:
        for module in jax_modules:
            monkeypatch.setattr(module, "SUpstream",
                                lambda **kwargs: _wrap(JaxSUpstream, jax_up, False))

    class JaxTiny(getattr(jax_problem, name)):
        def build_upstream(self, **kwargs):
            return _wrap(JaxSUpstream, jax_up, False)

        def build_task(self, *args, **kwargs):
            task = super().build_task(*args, **kwargs)
            capture_init(task, captured)
            return task

    class PortTiny(getattr(port_problem, name)):
        def build_upstream(self, **kwargs):
            return _wrap(SUpstream, port_up, False)

        def build_task(self, *args, **kwargs):
            return start_from(super().build_task(*args, **kwargs), captured)

    return JaxTiny(), PortTiny()


def run_both(tmp_path, same_states, name, monkeypatch=None, jax_modules=(), **overrides):
    """Every stage of recipe `name` in both packages (the JAX one first)
    on the same config: its defaults with `overrides` merged in."""
    jax_recipe, port_recipe = recipe_pair(name, same_states, monkeypatch, jax_modules)
    config = jax_recipe.default_config()
    config.pop("target_dir")
    for key, value in overrides.items():
        config[key] = {**config.get(key, {}), **value} if isinstance(value, dict) else value
    if "train" in config:
        config["train"] = {**config["train"], "tensorboard": False}
    jax_recipe.run(str(tmp_path / "jax"), **config)
    port_recipe.run(str(tmp_path / "port"), **config)
    return config


def same_csvs(tmp_path, names):
    """Each CSV of both workspaces byte for byte, the workspace prefix aside."""
    jax_ws, port_ws = tmp_path / "jax", tmp_path / "port"
    for name in names:
        assert (port_ws / name).read_text() == \
            (jax_ws / name).read_text().replace(str(jax_ws), str(port_ws)), name


def same_training(tmp_path, lr, shifts=()):
    """Train losses at rtol 1e-5; each saved step's probe parameters (and
    valid_best's) by `_close_probe` after their Adam updates of rate lr,
    the parameters ending in `shifts` within 2 lr an update."""
    np.testing.assert_allclose(_losses(tmp_path / "port" / "train"),
                               _losses(tmp_path / "jax" / "train"), rtol=1e-5)
    saved = sorted(d.name for d in (tmp_path / "jax" / "train").glob("step_*"))
    assert saved and saved == sorted(d.name for d in (tmp_path / "port" / "train").glob("step_*"))
    for d in saved + ["valid_best"]:
        jax_dir, port_dir = tmp_path / "jax" / "train" / d, tmp_path / "port" / "train" / d
        assert port_dir.exists() == jax_dir.exists(), d
        if not jax_dir.exists():
            continue
        want = probe_state_dict_from_jax(
            serialization.msgpack_restore((jax_dir / "params.msgpack").read_bytes()))
        got = torch.load(port_dir / "model.pt")
        assert got.keys() == want.keys()
        updates = int(torch.load(port_dir / "optimizer.pt")["count"])
        for k in want:
            if k.endswith(tuple(shifts)):
                assert np.abs(got[k].numpy() - want[k].numpy()).max() <= 2 * lr * updates, k
            else:
                _close_probe(got[k].numpy(), want[k].numpy(), lr, updates, f"{d} {k}")


def results(tmp_path, splits=("test",)):
    """(port result.yaml, JAX result.yaml), the same splits in both."""
    want = yaml.safe_load((tmp_path / "jax" / "result.yaml").read_text())
    got = yaml.safe_load((tmp_path / "port" / "result.yaml").read_text())
    assert got.keys() == want.keys() == set(splits)
    return got, want


def same_metrics(got, want, exact, close=()):
    """The metrics in `exact` equal, those in `close` and the loss at rtol
    1e-5; no other key."""
    assert set(got) == set(want) == {"loss", *exact, *close}
    for name in exact:
        assert got[name] == want[name], name
    for name in ("loss", *close):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, err_msg=name)


# -- each recipe's task on the same states ------------------------------------------

L, B, T, H = 3, 4, 30, 24
LENS = np.asarray([30, 17, 5, 1], np.int32)
NUM_SPEAKERS = 7


def task_pair(name):
    """Recipe `name`'s JAX and port task (dropout 0) over an upstream of L
    layers of width H, with the JAX params (perturbed) carried across."""
    up = types.SimpleNamespace(num_layers=L, hidden_sizes=[H] * L)
    config = getattr(jax_problem, name)().default_config()
    if "dropout" in config["build_downstream"]:
        config["build_downstream"] = {**config["build_downstream"], "dropout": 0.0}
    speakers = [f"spk{i}" for i in range(NUM_SPEAKERS)]
    jax_task = getattr(jax_problem, name)().build_task(up, JaxEncoder(speakers), config)
    port_task = getattr(port_problem, name)().build_task(up, CategoryEncoder(speakers), config)
    return jax_task, port_task


def frame_batch(name, rng):
    if name.startswith(("Libri", "Timit", "FrameProbe")):
        labels = rng.randint(0, 41, (B, T + 3)).astype(np.int32)
        labels[np.arange(T + 3)[None, :] >= (LENS + np.asarray([3, 1, -2, 0]))[:, None]] = -100
        labels[1, 4:7] = -100
        return {"frame_labels": labels}
    return {"class_id": rng.randint(0, NUM_SPEAKERS, B).astype(np.int32)}


@pytest.mark.parametrize("name", FRAME_RECIPES)
def test_recipe_task_matches_jax(name):
    """The task's loss and cache in train mode, and every parameter's
    gradient against jax.grad; the phone labels run 3 frames past the
    states' (cut), padded with -100 and with -100 inside a row."""
    jax_task, task = task_pair(name)
    rng = np.random.RandomState(1)
    hs = rng.randn(L, B, T, H).astype(np.float32)
    batch = frame_batch(name, rng)
    params = perturbed(jax.jit(lambda k, x: jax_task.init_params(
        k, x, jnp.asarray(LENS), batch))(KEY, jnp.asarray(hs)))
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    (want, want_cache), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(LENS), batch, KEY,
                                          True), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(LENS), batch,
                                      None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert cache.keys() == want_cache.keys()
    for k in cache:
        if k != "loss":
            np.testing.assert_array_equal(cache[k].numpy(), np.asarray(want_cache[k]), err_msg=k)
    loss.backward()
    want_grads = probe_state_dict_from_jax(want_grads)
    named = dict(task.module.named_parameters())
    assert named.keys() == want_grads.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


# -- the recipes --------------------------------------------------------------------


def test_frame_probe_example_matches_jax(tmp_path, same_states):
    """FrameProbeExample's four stages: stage 0's CSVs, the linear phone
    probe over 100-fps frame labels (cut to the states' 50 fps, padded
    with -100 into 1-s buckets), AdamW 2e-4 with a valid pass every 2
    steps, then the test accuracy."""
    run_both(tmp_path, same_states, "FrameProbeExample")
    same_csvs(tmp_path, ["train.csv", "valid.csv", "test.csv"])
    same_training(tmp_path, 2e-4)
    got, want = results(tmp_path)
    same_metrics(got["test"], want["test"], ("accuracy",))
    assert 0.0 <= got["test"]["accuracy"] <= 1.0


def _phone_tree(root):
    """converted_aligned_phones.txt over 12 LibriSpeech-style ids, 10 in
    train_split.txt (one without labels, one blank line) and 3 in
    test_split.txt."""
    root.mkdir(parents=True)
    ids = [f"{100 + i % 3}-{20 + i % 2}-{i:04d}" for i in range(12)]
    rng = np.random.RandomState(3)
    (root / "converted_aligned_phones.txt").write_text("\n".join(
        f"{u} " + " ".join(map(str, rng.randint(0, 41, 5 + i))) for i, u in enumerate(ids[:11])))
    (root / "train_split.txt").write_text("\n".join(ids[:9] + ["", ids[11]]) + "\n")
    (root / "test_split.txt").write_text("\n".join(ids[9:]) + "\n")
    return root


@pytest.mark.parametrize("name,prep", [
    ("LibriPhoneLinear", lambda p: {"libri_root": "/corpus/LibriSpeech", "phone_path": p}),
    ("TimitPhoneConvBank", lambda p: {"data_root": "/corpus/timit", "phone_path": p,
                                      "train_dev_seed": 7}),
    ("SpeakerLinearUtter", lambda p: {"libri_root": "/corpus/LibriSpeech", "split_file": p}),
])
def test_preparer_csvs_equal_jax(tmp_path, name, prep):
    """Stage 0 on a fake phone-alignment tree: the 90/10 split seeded by
    train_dev_seed (LibriSpeech / TIMIT layouts) and the speaker probe's
    splits, byte for byte."""
    cfg = {"prepare_data": prep(str(_phone_tree(tmp_path / "phones")))}
    for pkg, ws in ((jax_problem, tmp_path / "jax"), (port_problem, tmp_path / "port")):
        ws.mkdir()
        getattr(pkg, name)().prepare_data(ws, cfg)
    csvs = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert csvs == sorted(p.name for p in (tmp_path / "port").glob("*.csv"))
    assert len(csvs) == (2 if name == "SpeakerLinearUtter" else 3)
    same_csvs(tmp_path, csvs)


@pytest.mark.parametrize("name", FRAME_RECIPES)
def test_default_config_matches_jax(name):
    """The eleven recipes' defaults, key for key."""
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()
