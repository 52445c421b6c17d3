"""The mel-domain SSL pretraining tasks in s3prl_tpu_torch vs s3prl_tpu
(CPU): masked reconstruction (Mockingjay, TERA, AudioALBERT), APC and
VQ-APC, NPC and SpecAugment reconstruction, each built by both packages'
recipe (`build_task`) at a tiny width, each loss within 1e-5 relative of
JAX's and every parameter's gradient at cosine >= 0.99999 against
``jax.grad`` on the same weights and the same draws: JAX's MAM mask, its
SpecAugment bands and its Gumbel noise handed to both tasks by monkeypatch,
dropout 0. NPC's running statistics stay as they were (the JAX task throws
the update away).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.nn.specaug as jax_specaug
import s3prl_tpu.problem.pretrain as jax_pretrain
import s3prl_tpu.task.reconstruction as jax_rec
import s3prl_tpu_torch.problem.pretrain as port_pretrain
import s3prl_tpu_torch.task.reconstruction as port_rec
from s3prl_tpu.ops.mam import mam_mask as jax_mam_mask
from s3prl_tpu_torch.models.apc import VQLayer
from s3prl_tpu_torch.upstream.convert import (apc_pretrain_state_dict_from_jax,
                                              mam_pretrain_state_dict_from_jax,
                                              npc_pretrain_state_dict_from_jax)
from test_torch_port_pretrain_tasks import assert_grads, jax_grad, port_step
from test_torch_port_w2v2 import perturbed


def features(B=3, T=57, D=80, lens=(57, 40, 9), seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, D).astype(np.float32), np.asarray(lens, np.int32)


MEL_MODEL = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 64, "hidden_dropout_prob": 0.0,
             "attention_probs_dropout_prob": 0.0}


def _both(problem, config):
    """The JAX and the port task of recipe `problem` on `config`."""
    return (getattr(jax_pretrain, problem)().build_task(config),
            getattr(port_pretrain, problem)().build_task(config))


def _mel_run(jtask, task, convert, feats, lens, init_vars=False):
    jparams = jtask.init_params(jax.random.key(0), jnp.asarray(feats), jnp.asarray(lens), {})
    jparams = perturbed(jparams)
    jloss, _, jgrads = jax_grad(jtask, jparams, feats[None], lens, {})
    task.module.load_state_dict(convert(jparams))
    loss, _ = port_step(task, torch.from_numpy(feats[None]), torch.from_numpy(lens), {})
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    return jparams, jgrads


@pytest.mark.parametrize("problem,mask_frequency", [
    ("PretrainMockingjay", 0.0), ("PretrainTera", 0.2), ("PretrainAudioAlbert", 0.2)])
def test_masked_reconstruction_loss_and_grads(monkeypatch, problem, mask_frequency):
    D = 240 if problem == "PretrainMockingjay" else 80
    feats, lens = features(D=D)
    kw = dict(mask_proportion=0.15, mask_consecutive=7, mask_frequency=mask_frequency)
    masked, label = jax_mam_mask(jax.random.key(3), jnp.asarray(feats), jnp.asarray(lens), **kw)
    masked, label = np.asarray(masked), np.asarray(label)
    assert label.any() and (masked != feats).any()
    monkeypatch.setattr(jax_rec, "mam_mask", lambda *a, **k: (jnp.asarray(masked),
                                                              jnp.asarray(label)))
    monkeypatch.setattr(port_rec, "mam_mask", lambda *a, **k: (torch.from_numpy(masked),
                                                               torch.from_numpy(label)))
    config = {"build_model": MEL_MODEL, "build_task": {"loss": "L1", **kw}}
    jtask, task = _both(problem, config)
    _, jgrads = _mel_run(jtask, task, mam_pretrain_state_dict_from_jax, feats, lens)
    assert_grads(task.module, mam_pretrain_state_dict_from_jax(jgrads))


@pytest.mark.parametrize("vq", [False, True])
def test_apc_and_vq_apc_loss_and_grads(monkeypatch, vq):
    """APC, and VQ-APC on JAX's Gumbel noise (the straight-through code)."""
    feats, lens = features()
    model = {"input_size": 80, "hidden_size": 32, "num_layers": 2, "dropout": 0.0}
    if vq:
        model.update(vq_codebook_size=[16], vq_code_dim=[32])
        noise = np.asarray(jax.random.gumbel(jax.random.key(9), (3, 57, 16)))
        monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=None:
                            jnp.asarray(noise, dtype))
        monkeypatch.setattr(VQLayer, "draw_gumbel",
                            staticmethod(lambda logits, gen: torch.from_numpy(noise)))
    jtask, task = _both("PretrainVqApc" if vq else "PretrainAPC",
                        {"build_model": model, "build_task": {"n_future": 3}})
    _, jgrads = _mel_run(jtask, task, apc_pretrain_state_dict_from_jax, feats, lens)
    # flax's GRU cells keep no hidden-side r / z biases: the port's take no
    # gradient (`nn.heads.GRU`), the converter gives zeros for them
    assert_grads(task.module, apc_pretrain_state_dict_from_jax(jgrads))


def test_npc_loss_grads_and_running_stats():
    feats, lens = features()
    model = {"input_size": 80, "hidden_size": 32, "n_blocks": 2, "kernel_size": 7,
             "mask_size": 3, "dropout": 0.0}
    jtask, task = _both("PretrainNPC", {"build_model": model})
    jvars, jgrads = _mel_run(jtask, task, npc_pretrain_state_dict_from_jax, feats, lens)
    stats = {k: v.clone() for k, v in task.module.state_dict().items() if "running" in k}
    assert stats and all(torch.equal(v, task.module.state_dict()[k]) for k, v in stats.items())
    assert_grads(task.module, {k: v for k, v in npc_pretrain_state_dict_from_jax(
        {"params": jgrads["params"], "batch_stats": jvars["batch_stats"]}).items()
        if "running" not in k and "num_batches" not in k})


def test_spec_augment_reconstruction_loss_and_grads(monkeypatch):
    feats, lens = features(D=240)
    B, T, D = feats.shape
    fmask = np.asarray(jax_specaug._band_mask(jax.random.key(1), B, D, 2, 27))
    tmask = np.asarray(jax_specaug._band_mask(jax.random.key(2), B, T, 2, 20))
    monkeypatch.setattr(jax_specaug, "_band_mask", lambda key, B, L, M, W: jnp.asarray(
        fmask if L == D else tmask))
    monkeypatch.setattr(port_rec, "spec_masks", lambda *a, **k: (torch.from_numpy(fmask),
                                                                  torch.from_numpy(tmask)))
    config = {"build_model": MEL_MODEL, "build_task": {"time_mask_width": 20}}
    jtask, task = _both("PretrainSpecAugment", config)
    _, jgrads = _mel_run(jtask, task, mam_pretrain_state_dict_from_jax, feats, lens)
    assert_grads(task.module, mam_pretrain_state_dict_from_jax(jgrads))


def test_tasks_train_and_eval_draw_from_the_generator():
    """Without the monkeypatches each task draws its masks from the step's
    generator: the same seed gives the same loss, another seed another."""
    feats, lens = features()
    _, task = _both("PretrainTera", {"build_model": MEL_MODEL})
    task.init_params(torch.Generator().manual_seed(0))
    hs, h_lens = torch.from_numpy(feats[None]), torch.from_numpy(lens)

    def loss(seed, train):
        return float(task.loss_and_cache(hs, h_lens, {}, torch.Generator().manual_seed(seed),
                                         train)[0])

    assert loss(0, True) == loss(0, True) != loss(1, True)
    assert loss(0, False) == loss(0, False)
    assert not task.module.training
