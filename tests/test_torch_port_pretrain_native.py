"""The JAX package's native pretraining checkpoints through the port's hub
(CPU): a msgpack checkpoint written by the JAX Trainer's `save_checkpoint`
for each layout its loaders read (HuBERT's ``{trunk, final_proj,
label_embs}``, data2vec's ``{student, teacher}``, a bare trunk, the MAM
task's ``{encoder, head}``, APC's ``{apc}``, NPC's ``{params: {npc},
batch_stats: {npc}}``) loads through ``hub.load(name, ckpt=...)`` in both
packages, as the train directory, the step directory and the ``.msgpack``
file, with standardized states within atol 5e-4 of the JAX hub's; a layout
neither reads raises ValueError in both. The entries' configurations are
patched tiny in both registries (the native loaders take the entry's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.models.hubert import HubertForPretrain as JaxHubert
from s3prl_tpu.models.hubert import HubertPretrainConfig as JaxPreCfg
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.train.checkpoint import save_checkpoint
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from s3prl_tpu_torch.upstream.convert import native_checkpoint
from test_torch_port_mel_ssl import LENS, tiny_entries, waves  # noqa: F401
from test_torch_port_pretrain_tasks import D2V, TINY
from test_torch_port_w2v2 import perturbed

MEL = {"tera": ("PretrainTera", {"hidden_size": 64, "num_hidden_layers": 2,
                                 "num_attention_heads": 4, "intermediate_size": 128}),
       "apc": ("PretrainAPC", {"hidden_size": 32, "num_layers": 3}),
       "npc": ("PretrainNPC", {"hidden_size": 32, "n_blocks": 2})}


def run_both(name, ckpt):
    """(JAX states, port states) of entry `name` from `ckpt` on the batch."""
    x = waves()
    jup = jax_hub.load(name, ckpt=str(ckpt))
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    up = hub.load(name, ckpt=str(ckpt), device="cpu")
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    return np.asarray(want), got.numpy()


@pytest.fixture
def tiny_trunks(monkeypatch):
    """The hubert and data2vec entries at the tiny widths in both registries."""
    monkeypatch.setattr(jax_registry, "BASE", JaxConfig(**TINY))
    monkeypatch.setattr(jax_registry, "DATA2VEC_BASE", JaxConfig(**D2V))
    monkeypatch.setattr(port_registry, "HUBERT_BASE", Wav2Vec2Config(**TINY))
    monkeypatch.setattr(port_registry, "DATA2VEC_BASE", Wav2Vec2Config(**D2V))


def _trunk_params(fields):
    init = jax.jit(lambda k: JaxTrunk(JaxConfig(**fields)).init(
        k, jnp.zeros((1, 3200)), jnp.asarray([3200]), None, deterministic=True))
    return perturbed(init(jax.random.key(0))["params"])


@pytest.mark.parametrize("layout", ["hubert", "data2vec", "bare"])
def test_native_trunk_checkpoints(tiny_trunks, tmp_path, layout):
    if layout == "hubert":
        model = JaxHubert(JaxConfig(**TINY), JaxPreCfg(num_classes=16, final_dim=16))
        init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 3200)), jnp.asarray([3200]), None,
                                            deterministic=True))
        params, name = perturbed(init(jax.random.key(1))["params"]), "hubert"
    elif layout == "data2vec":
        student = _trunk_params(D2V)
        params = {"student": student,
                  "teacher": jax.tree_util.tree_map(lambda a: a * 0.5, student)}
        name = "data2vec"
    else:
        params, name = _trunk_params(TINY), "hubert"
    train = tmp_path / "train"
    save_checkpoint(train, 1, jax.tree_util.tree_map(lambda a: a * 0.0, params))
    save_checkpoint(train, 2, params)  # the highest step wins
    want, got = run_both(name, train)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    for ckpt in (train / "step_2", train / "step_2" / "params.msgpack"):
        got2 = hub.load(name, ckpt=str(ckpt), device="cpu")(
            torch.from_numpy(waves()), torch.from_numpy(LENS))[0]
        assert torch.equal(got2, torch.from_numpy(got))
    kind, tree = native_checkpoint(train)
    assert kind == "jax" and set(tree) == set(params)


@pytest.mark.parametrize("name", list(MEL))
def test_native_mel_checkpoints(tiny_entries, tmp_path, name):  # noqa: F811
    from s3prl_tpu.problem import pretrain as jax_pretrain

    problem, model = MEL[name]
    task = getattr(jax_pretrain, problem)().build_task({"build_model": model})
    feats = jnp.zeros((1, 50, 80))
    variables = task.init_params(jax.random.key(2), feats, jnp.asarray([50]), {})
    variables = perturbed(variables)
    if name == "npc":  # running statistics away from 0 / 1, variances positive
        stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, variables["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": stats}
    save_checkpoint(tmp_path / "train", 3, variables)
    want, got = run_both(name, tmp_path / "train")
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("name,expected", [("hubert", "'trunk'"), ("tera", "'encoder'"),
                                           ("npc", "NPC task layout")])
def test_unknown_native_layout_raises_in_both(tiny_trunks, tiny_entries, tmp_path,  # noqa: F811
                                              name, expected):
    save_checkpoint(tmp_path / "bad", 1, {"something_else": {"w": jnp.ones((2, 2))}})
    with pytest.raises(ValueError, match="expected"):
        jax_hub.load(name, ckpt=str(tmp_path / "bad"))
    with pytest.raises(ValueError, match=expected):
        hub.load(name, ckpt=str(tmp_path / "bad"), device="cpu")
