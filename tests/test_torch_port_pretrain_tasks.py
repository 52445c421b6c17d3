"""The waveform pretraining tasks in s3prl_tpu_torch vs s3prl_tpu (CPU):
HuBERT, data2vec and DistilHuBERT, each task's loss within 1e-5 relative of
JAX's and every parameter's gradient at cosine >= 0.99999 against
``jax.grad``, on the same weights (the JAX tree carried by the port's
``*_pretrain_state_dict_from_jax``) and the same masks
(`test_torch_port_pretrain_mel` holds the mel-domain tasks).

The packages draw masks and dropout from streams of their own, so each test
computes the JAX span mask once and hands it to both tasks by monkeypatch;
the dropout rates are 0. HuBERT runs the JAX Example's trunk (group-norm
extractor), data2vec a tiny layer-norm trunk whose teacher takes K3's plain
version on the CPU. data2vec's `post_update` is held to JAX's EMA at 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.task.data2vec_pretrain as jax_d2v
import s3prl_tpu.task.hubert_pretrain as jax_hubert
import s3prl_tpu_torch.kernels.conv_frontend as port_cf
import s3prl_tpu_torch.task.data2vec_pretrain as port_d2v
import s3prl_tpu_torch.task.hubert_pretrain as port_hubert
from s3prl_tpu.models.distiller import DistillerConfig as JaxDistillerConfig
from s3prl_tpu.models.distiller import DistillerModel as JaxDistiller
from s3prl_tpu.models.hubert import HubertForPretrain as JaxHubert
from s3prl_tpu.models.hubert import HubertPretrainConfig as JaxPreCfg
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.ops.masking import compute_mask_indices as jax_mask_indices
from s3prl_tpu.task.data2vec_pretrain import Data2VecPretrainTask as JaxD2VTask
from s3prl_tpu.task.distiller_pretrain import DistillerPretrainTask as JaxDistillerTask
from s3prl_tpu.task.hubert_pretrain import HubertPretrainTask as JaxHubertTask
from s3prl_tpu_torch.models.distiller import DistillerConfig, DistillerModel
from s3prl_tpu_torch.models.hubert import HubertForPretrain, HubertPretrainConfig
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.task.data2vec_pretrain import Data2VecPretrainTask
from s3prl_tpu_torch.task.distiller_pretrain import DistillerPretrainTask
from s3prl_tpu_torch.task.hubert_pretrain import HubertPretrainTask
from s3prl_tpu_torch.upstream.convert import (data2vec_pretrain_state_dict_from_jax,
                                              distiller_state_dict_from_jax,
                                              hubert_pretrain_state_dict_from_jax)
from test_torch_port_w2v2 import perturbed

TINY = dict(  # the JAX Examples' trunk (problem/pretrain.py:604-617)
    conv_feature_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4), (32, 2, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
    encoder_attention_heads=4, dropout=0.0, attention_dropout=0.0, dropout_input=0.0)
# a data2vec-like trunk: layer-norm extractor without conv bias (k0 = 2 s0:
# K3's route in eval), post-LN, the depth-5 pos-conv stack
D2V = dict(TINY, extractor_mode="layer_norm", layer_norm_first=False, normalize=True,
           conv_pos=20, conv_pos_groups=4, pos_conv_depth=5, post_extract_proj_always=True,
           feat_pad_rule="conv")
LENS = np.asarray([9600, 6401, 3300], np.int32)
RNG = jax.random.key(7)
# a gradient whose norm is below this share of the whole gradient's is zero
# but for rounding (analytically: softmax ignores a key bias, BatchNorm a
# conv bias before it)
ZERO = 1e-5


def waves(lens=LENS, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lens), max(lens)).astype(np.float32) * 0.1
    return x * (np.arange(max(lens))[None] < lens[:, None]), lens



def jax_grad(task, params, hs, h_lens, batch, rng=RNG):
    fn = jax.jit(jax.value_and_grad(
        lambda p: task.loss_and_cache(p, hs, h_lens, batch, rng, True), has_aux=True))
    (loss, cache), grads = fn(params)
    return float(loss), cache, jax.tree_util.tree_map(np.asarray, grads)


def port_step(task, hs, h_lens, batch):
    task.module.zero_grad(set_to_none=True)
    loss, cache = task.loss_and_cache(hs, h_lens, batch, torch.Generator().manual_seed(0), True)
    loss.backward()
    return float(loss.detach()), cache


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def assert_grads(module, grad_sd):
    """Every parameter's .grad against the JAX gradient carried to the same
    layout: the module loads it for a moment, so the fused QKV and every
    layout rule take it as they take weights."""
    saved = {n: p.detach().clone() for n, p in module.state_dict().items()}
    module.load_state_dict({**saved, **grad_sd})
    want = {n: p.detach().clone() for n, p in module.named_parameters()}
    module.load_state_dict(saved)
    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    checked = 0
    for name, p in module.named_parameters():
        g, w = p.grad, want[name]
        if g is None:
            assert float(w.abs().max()) == 0.0, name
            continue
        if float(w.norm()) <= ZERO * total:  # zero but for rounding (a key bias,
            # a conv bias before BatchNorm): the port's must be as small
            assert float(g.norm()) <= ZERO * total, (name, float(g.norm()), total)
            continue
        assert cosine(g, w) >= 0.99999, (name, cosine(g, w))
        checked += 1
    assert checked > 0


def wav_batch(lens=LENS):
    x, lens = waves(lens)
    return {"x": x, "x_len": lens}


# -- HuBERT -------------------------------------------------------------------


def test_hubert_task_loss_and_grads(monkeypatch):
    jcfg, pcfg = JaxConfig(**TINY), Wav2Vec2Config(**TINY)
    jmodel = JaxHubert(jcfg, JaxPreCfg(num_classes=16, final_dim=16))
    batch = wav_batch()
    rng = np.random.RandomState(3)
    T_feat = int(max(LENS)) // 320
    units_len = np.asarray([T_feat, 19, 10], np.int32)
    units = rng.randint(0, 16, (3, T_feat)).astype(np.int32) * (
        np.arange(T_feat)[None] < units_len[:, None])
    batch.update(units=units, units_len=units_len)
    params = perturbed(jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(batch["x"]), jnp.asarray(LENS), None, deterministic=True))(
        jax.random.key(0))["params"])
    valid = np.arange(T_feat)[None] < np.minimum(LENS, units_len)[:, None]
    mask = np.asarray(jax_mask_indices(jax.random.key(5), (3, T_feat), jnp.asarray(~valid),
                                       0.8, 4))
    monkeypatch.setattr(jax_hubert, "compute_mask_indices", lambda *a, **k: jnp.asarray(mask))
    monkeypatch.setattr(port_hubert, "compute_mask_indices",
                        lambda *a, **k: torch.from_numpy(mask))
    jtask = JaxHubertTask(jmodel, mask_length=4, pred_nomask_weight=0.5)
    hs, h_lens = batch["x"][None, ..., None], LENS
    jloss, jcache, jgrads = jax_grad(jtask, params, hs, h_lens, batch)

    module = HubertForPretrain(pcfg, HubertPretrainConfig(num_classes=16, final_dim=16))
    module.load_state_dict(hubert_pretrain_state_dict_from_jax(params, pcfg))
    task = HubertPretrainTask(module, mask_length=4, pred_nomask_weight=0.5)
    loss, cache = port_step(task, torch.from_numpy(hs), torch.from_numpy(h_lens), batch)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert float(cache["masked_acc"]) == pytest.approx(float(jcache["masked_acc"]), abs=1e-6)
    assert_grads(module, hubert_pretrain_state_dict_from_jax(jgrads, pcfg))


# -- data2vec -----------------------------------------------------------------


@pytest.fixture(scope="module")
def d2v_params():
    jcfg = JaxConfig(**D2V)
    init = jax.jit(lambda k, w, n: JaxTrunk(jcfg).init(k, w, n, None, deterministic=True))
    student = perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)),
                             jnp.asarray([3200]))["params"])
    teacher = jax.tree_util.tree_map(
        lambda a: a + 0.01 * np.random.RandomState(1).randn(*a.shape).astype(np.float32),
        student)
    return {"student": student, "teacher": teacher}


def _d2v_tasks(params, monkeypatch, mask):
    jcfg, pcfg = JaxConfig(**D2V), Wav2Vec2Config(**D2V)
    monkeypatch.setattr(jax_d2v, "compute_mask_indices", lambda *a, **k: jnp.asarray(mask))
    monkeypatch.setattr(port_d2v, "compute_mask_indices", lambda *a, **k: torch.from_numpy(mask))
    kw = dict(average_top_k_layers=2, ema_decay=0.9, mask_length=4)
    jtask = JaxD2VTask(JaxTrunk(jcfg), **kw)
    task = Data2VecPretrainTask(Wav2Vec2Trunk(pcfg), **kw)
    task.module.load_state_dict(data2vec_pretrain_state_dict_from_jax(params, pcfg))
    return jtask, task, pcfg


def test_data2vec_task_loss_grads_and_ema(d2v_params, monkeypatch):
    batch = wav_batch()
    T = int(max(LENS)) // 320 - 1  # the conv rule's frames of the padded batch
    t_lens = np.asarray([29, 19, 9])
    mask = np.asarray(jax_mask_indices(jax.random.key(5), (3, T),
                                       jnp.asarray(np.arange(T)[None] >= t_lens[:, None]),
                                       0.65, 4))
    jtask, task, pcfg = _d2v_tasks(d2v_params, monkeypatch, mask)
    hs, h_lens = batch["x"][None, ..., None], LENS
    # the JAX trainer differentiates the whole tree, and the teacher's K3
    # (forward-only Pallas) cannot be linearized: JAX's data2vec on a
    # layer-norm extractor takes no step (ROADMAP.md Queue 3). Its student's
    # gradient with the teacher held constant is the port's.
    with pytest.raises(ValueError, match="Linearization failed"):
        jax_grad(jtask, d2v_params, hs, h_lens, batch)
    teacher = d2v_params["teacher"]
    fn = jax.jit(jax.value_and_grad(lambda s: jtask.loss_and_cache(
        {"student": s, "teacher": teacher}, hs, h_lens, batch, RNG, True), has_aux=True))
    (jloss, jcache), student_jgrads = fn(d2v_params["student"])
    jloss = float(jloss)
    jgrads = {"student": student_jgrads, "teacher": jax.tree_util.tree_map(
        np.zeros_like, teacher)}
    calls = []
    ref = port_cf.conv0_ln_gelu_reference
    monkeypatch.setattr(port_cf, "conv0_ln_gelu_reference",
                        lambda *a, **k: calls.append(1) or ref(*a, **k))
    loss, cache = port_step(task, torch.from_numpy(hs), torch.from_numpy(h_lens), batch)
    assert calls == [1]  # the teacher's K3 route (its plain version on the CPU), once
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert float(cache["target_var"]) == pytest.approx(float(jcache["target_var"]), rel=1e-5)
    assert all(p.grad is None for p in task.module.teacher.parameters())
    student_grads = data2vec_pretrain_state_dict_from_jax(jgrads, pcfg)
    assert_grads(task.module.student, {k[8:]: v for k, v in student_grads.items()
                                       if k.startswith("student.")})

    # the EMA: the port's post_update against JAX's, both from the same tree
    moved = jax.tree_util.tree_map(lambda a: a * 1.5 - 0.01, d2v_params["student"])
    new = {"student": moved, "teacher": d2v_params["teacher"]}
    task.module.load_state_dict(data2vec_pretrain_state_dict_from_jax(new, pcfg))
    task.post_update()
    want = data2vec_pretrain_state_dict_from_jax(jtask.post_update(new), pcfg)
    got = task.module.state_dict()
    for k, v in want.items():
        assert torch.allclose(got[k], v, atol=1e-6, rtol=0), k


# -- DistilHuBERT --------------------------------------------------------------


def test_distiller_task_loss_and_grads():
    fields = dict(conv_feature_layers=TINY["conv_feature_layers"], encoder_layers=2,
                  encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=4,
                  conv_pos=16, conv_pos_groups=4, dropout=0.0, attention_dropout=0.0,
                  activation_dropout=0.0, final_dim=32, n_tasks=2)
    jcfg, pcfg = JaxDistillerConfig(**fields), DistillerConfig(**fields)
    batch = wav_batch()
    jmodel = JaxDistiller(jcfg)
    params = perturbed(jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(batch["x"]), jnp.asarray(LENS), deterministic=True))(
        jax.random.key(0))["params"])
    # the teacher's standardized states [L_t + 1, B, T', 32] and lengths
    T = int(max(LENS)) // 320
    hs = np.random.RandomState(4).randn(4, 3, T, 32).astype(np.float32)
    h_lens = (LENS - 1) // 320 + 1
    jtask = JaxDistillerTask(jmodel, n_tasks=2, pred_layer_id=[1, 3])
    jloss, jcache, jgrads = jax_grad(jtask, params, hs, h_lens, batch)
    module = DistillerModel(pcfg)
    module.load_state_dict(distiller_state_dict_from_jax(params, pcfg))
    task = DistillerPretrainTask(module, n_tasks=2, pred_layer_id=[1, 3])
    loss, cache = port_step(task, torch.from_numpy(hs), torch.from_numpy(h_lens), batch)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    for key in ("rec_loss", "sim_loss"):
        assert float(cache[key]) == pytest.approx(float(jcache[key]), rel=1e-5)
    assert_grads(module, distiller_state_dict_from_jax(jgrads, pcfg))
