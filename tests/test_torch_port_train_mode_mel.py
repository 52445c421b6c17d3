"""The mel-domain upstreams' and the MOS predictor's train mode in
s3prl_tpu_torch vs s3prl_tpu (CPU), the refusals where the JAX train mode
raises, dropout at p = 0.1, and the Trainer with ``upstream_trainable``
over every family.

The models run at a tiny width (Mockingjay 64 / 2 layers / 4 heads, APC 3 x
32, NPC 2 blocks x 32, the MOS predictor's nested upstreams likewise) on
perturbed JAX params carried to the port by its converters; one rate at
1.0 and the others 0 (p = 1 gives zeros in both packages), f32 at atol
5e-4. The trunks' helpers are `test_torch_port_train_mode`'s.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

import s3prl_tpu.models.apc as jax_apc
import s3prl_tpu.models.mockingjay as jax_mockingjay
import s3prl_tpu.models.mos as jax_mos
import s3prl_tpu.models.npc as jax_npc
import s3prl_tpu_torch.nn.heads as port_heads
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu_torch.models.apc import APCConfig, APCModel
from s3prl_tpu_torch.models.mockingjay import MockingjayConfig, MockingjayEncoder
from s3prl_tpu_torch.models.mos import MosConfig, MosModel
from s3prl_tpu_torch.models.npc import NPCConfig, NPCModel
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from s3prl_tpu_torch.nn import init_params
from s3prl_tpu_torch.nn.upstream import UpstreamDownstreamModel
from s3prl_tpu_torch.task import UtteranceClassificationTask
from s3prl_tpu_torch.train.trainer import Trainer, TrainerConfig
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import (apc_state_dict_from_jax,
                                              mockingjay_state_dict_from_jax,
                                              mos_state_dict_from_jax, npc_state_dict_from_jax)
from test_torch_port_train import _batches, _Loader
from test_torch_port_train_mode import (WIDTH, port_states, port_trunk, trunk_params,  # noqa: F401
                                        waves)
from test_torch_port_w2v2 import perturbed

MOCKINGJAY = dict(input_dim=80, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=128, hidden_dropout_prob=0.0)
APC = dict(hidden_size=32, num_layers=3, dropout=0.0)
NPC = dict(hidden_size=32, n_blocks=2, dropout=0.0, batch_norm=False)
MEL = {  # family -> (JAX model, port model, config fields, the rate, converter)
    "mockingjay": (jax_mockingjay.MockingjayEncoder, MockingjayEncoder, MOCKINGJAY,
                   "hidden_dropout_prob"),
    "mockingjay-pre-ln": (jax_mockingjay.MockingjayEncoder, MockingjayEncoder,
                          dict(MOCKINGJAY, pre_layer_norm=True), "hidden_dropout_prob"),
    "apc": (jax_apc.APCModel, APCModel, APC, "dropout"),
    "npc": (jax_npc.NPCModel, NPCModel, NPC, "dropout"),
}
JAX_CONFIGS = {"mockingjay": jax_mockingjay.MockingjayConfig, "apc": jax_apc.APCConfig,
               "npc": jax_npc.NPCConfig}
PORT_CONFIGS = {"mockingjay": MockingjayConfig, "apc": APCConfig, "npc": NPCConfig}



def mel_models(family, **fields):
    jcls, pcls, base, _ = MEL[family]
    kind = family.split("-")[0]
    fields = dict(base, **fields)
    return jcls(JAX_CONFIGS[kind](**fields)), pcls(PORT_CONFIGS[kind](**fields))


def mel_feats(seed=0):
    rng = np.random.RandomState(seed)
    lens = np.asarray([40, 23, 2], np.int32)
    x = rng.randn(3, 40, 80).astype(np.float32)
    return x * (np.arange(40)[None, :, None] < lens[:, None, None]), lens


def mel_convert(family, variables):
    kind = family.split("-")[0]
    if kind == "mockingjay":
        return mockingjay_state_dict_from_jax(variables["params"])
    if kind == "apc":
        return apc_state_dict_from_jax(variables["params"])
    return npc_state_dict_from_jax(variables)


@pytest.mark.parametrize("rate", [0.0, 1.0])
@pytest.mark.parametrize("family", list(MEL))
def test_mel_dropout_site_matches_jax(family, rate):
    """The mel-domain models in train mode with their rate at 0 and 1 (JAX:
    mockingjay.py:87, :92, :138; apc.py:80; npc.py:56, NPC without
    BatchNorm, whose train mode JAX cannot run)."""
    site = MEL[family][3]
    jmodel, pmodel = mel_models(family, **{site: rate})
    x, lens = mel_feats()
    kind = family.split("-")[0]
    mode = (lambda t: {"train": t}) if kind in ("apc", "npc") else (
        lambda t: {"deterministic": not t})
    variables = jax.jit(lambda k: jmodel.init(k, jnp.asarray(x), jnp.asarray(lens),
                                              **mode(False)))(jax.random.key(0))
    variables = {"params": perturbed(variables["params"])}
    want = jax.jit(lambda v, f, n: jmodel.apply(v, f, n, **mode(True),
                                                rngs={"dropout": jax.random.key(5)})[0])(
        variables, jnp.asarray(x), jnp.asarray(lens))
    pmodel.load_state_dict(mel_convert(family, variables))
    pmodel.train()
    with torch.no_grad():
        got = pmodel(torch.from_numpy(x), torch.from_numpy(lens),
                     torch.Generator().manual_seed(0))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)
    if rate:
        with torch.no_grad():
            evaluated = pmodel.eval()(torch.from_numpy(x), torch.from_numpy(lens))[0]
        assert not np.allclose(got.numpy(), evaluated.numpy(), atol=1e-3)


MOS_NESTED = {"apc": ("apc", APC, "dropout"),
              "tera": ("tera", dict(MOCKINGJAY), "hidden_dropout_prob"),
              "wav2vec2": ("trunk", dict(WIDTH, extractor_mode="default",
                                         layer_norm_first=False), "dropout")}


def mos_configs(upstream, rate):
    field, base, site = MOS_NESTED[upstream]
    fields = dict(base, **{site: rate})
    jnested = {"apc": jax_apc.APCConfig, "tera": jax_mockingjay.MockingjayConfig,
               "trunk": JaxConfig}[field](**fields)
    pnested = {"apc": APCConfig, "tera": MockingjayConfig, "trunk": Wav2Vec2Config}[field](
        **fields)
    head = dict(upstream=upstream, projector_dim=16)
    return (jax_mos.MosConfig(**head, **{field: jnested}),
            MosConfig(**head, **{field: pnested}))


@pytest.mark.parametrize("upstream", list(MOS_NESTED))
def test_mos_nested_dropout_matches_jax(upstream):
    """The MOS predictor in train mode with its nested upstream's rate at
    1.0 (mos.py:79-89): the scores are JAX's."""
    jcfg, pcfg = mos_configs(upstream, 1.0)
    jmodel = jax_mos.MosModel(jcfg)
    params = perturbed(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 16000)), jnp.asarray([16000])))(jax.random.key(0))["params"])
    x, lens = waves([16001, 16000, 9000])
    want, want_lens = jax.jit(lambda w, n: jmodel.apply(
        {"params": params}, w, n, deterministic=False,
        rngs={"dropout": jax.random.key(1)}))(jnp.asarray(x), jnp.asarray(lens))
    pmodel = MosModel(pcfg)
    pmodel.load_state_dict(mos_state_dict_from_jax(params, pcfg))
    up = Upstream("mos", pmodel.eval(), 1, 1, pcfg.downsample_rate)
    got, _ = up.model.train()(torch.from_numpy(x), torch.from_numpy(lens),
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4, rtol=0)
    evaluated, _ = pmodel.eval()(torch.from_numpy(x), torch.from_numpy(lens))
    assert not np.allclose(got.detach().numpy(), evaluated.detach().numpy(), atol=1e-4)


def test_refusals_match_the_jax_train_mode():
    """VQ-APC (no "gumbel" stream) and NPC with BatchNorm (immutable
    batch_stats) raise in the JAX train mode; the port's upstream raises
    at the call, and runs both in eval mode."""
    x, lens = mel_feats()
    cases = {"vq": (jax_apc.APCModel(jax_apc.APCConfig(**APC, vq_codebook_size=(8,),
                                                       vq_code_dim=(32,))),
                    APCModel(APCConfig(**APC, vq_codebook_size=(8,), vq_code_dim=(32,))),
                    flax.errors.InvalidRngError, '"gumbel"'),
             "bn": (jax_npc.NPCModel(jax_npc.NPCConfig(**dict(NPC, batch_norm=True))),
                    NPCModel(NPCConfig(**dict(NPC, batch_norm=True))),
                    flax.errors.ModifyScopeVariableError, '"batch_stats"')}
    for name, (jmodel, pmodel, error, match) in cases.items():
        variables = jmodel.init({"params": jax.random.key(0), "gumbel": jax.random.key(1)},
                                jnp.asarray(x), jnp.asarray(lens), train=False)
        with pytest.raises(error):
            jmodel.apply(variables, jnp.asarray(x), jnp.asarray(lens), train=True,
                         rngs={"dropout": jax.random.key(2)})
        port_heads_init(pmodel)
        up = Upstream(name, _FeatsModel(pmodel), pmodel.cfg.num_layers if name == "vq" else 5,
                      32, 160)
        with pytest.raises(NotImplementedError, match=match):
            up(torch.zeros(1, 1600), torch.tensor([1600]), train=True)
        up(torch.zeros(1, 1600), torch.tensor([1600]))


class _FeatsModel(torch.nn.Module):
    """Waves -> 80 features a frame of 160 samples -> the model (the
    upstream contract's shape, without a front end)."""

    def __init__(self, model):
        super().__init__()
        self.model, self.cfg = model, model.cfg

    def forward(self, wavs, wav_lens, generator=None):
        feats = wavs[:, :wavs.shape[1] // 160 * 160].reshape(wavs.shape[0], -1, 160)[..., :80]
        lens = torch.div(wav_lens, 160, rounding_mode="floor")
        return self.model(feats, lens, generator)[0], lens


def port_heads_init(model):
    init_params(model, torch.Generator().manual_seed(0))


def test_dropout_keeps_its_share_and_scale():
    """p = 0.1: the kept share of 10^6 draws lies within 5 binomial
    standard deviations of 0.9, each kept value is x / 0.9, and one seed
    gives bit-equal masks on the CPU."""
    x = torch.rand(1_000_000) + 0.5
    got = port_heads.dropout(x, 0.1, True, torch.Generator().manual_seed(7))
    kept = got != 0
    share = kept.float().mean().item()
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    torch.testing.assert_close(got[kept], x[kept] / 0.9, rtol=0, atol=0)
    again = port_heads.dropout(x, 0.1, True, torch.Generator().manual_seed(7))
    assert torch.equal(got, again)
    assert not torch.equal(got, port_heads.dropout(x, 0.1, True,
                                                   torch.Generator().manual_seed(8)))


def test_model_dropout_at_p_0_1(trunk_params):
    """Mockingjay's input state at p = 0.1: each value is 0 or the eval
    value / 0.9, about 90% kept; a trunk with every rate at 0.1 gives
    bit-equal states from one generator seed and others from another."""
    _, pmodel = mel_models("mockingjay", hidden_dropout_prob=0.1)
    port_heads_init(pmodel)
    x, lens = mel_feats(3)
    with torch.no_grad():
        evaluated = pmodel.eval()(torch.from_numpy(x), torch.from_numpy(lens))[0][0]
        trained = pmodel.train()(torch.from_numpy(x), torch.from_numpy(lens),
                                 torch.Generator().manual_seed(0))[0][0]
    kept = trained != 0
    torch.testing.assert_close(trained[kept], evaluated[kept] / 0.9, rtol=1e-6, atol=1e-6)
    share = kept.float().mean().item()
    assert abs(share - 0.9) < 5 * (0.9 * 0.1 / kept.numel()) ** 0.5
    rates = dict(dropout=0.1, activation_dropout=0.1, dropout_input=0.1)
    up = port_trunk("hubert-pre-ln", trunk_params["hubert-pre-ln"], **rates)
    wavs, lens = waves()
    a, _ = port_states(up, wavs, lens, True, seed=4)
    b, _ = port_states(up, wavs, lens, True, seed=4)
    c, _ = port_states(up, wavs, lens, True, seed=5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


TRAIN = dict(total_steps=2, log_step=1, eval_step=100, save_step=100, tensorboard=False,
             optimizer={"name": "Adam", "lr": 1e-3})


def _task(num_layers, hidden):
    return UtteranceClassificationTask(
        UpstreamDownstreamModel(port_heads.UtteranceLevel(hidden, 4, (8,)), num_layers), 4)


def _trainable_upstreams(trunk_params):
    """Upstreams with their dropouts on at 0.1: the HuBERT-Large-style
    trunk, WavLM, Mockingjay, APC, NPC (no BatchNorm) and a MOS predictor."""
    rates = dict(dropout=0.1, activation_dropout=0.1, dropout_input=0.1)
    ups = {family: port_trunk(family, trunk_params[family], **rates)
           for family in ("hubert-pre-ln", "wavlm")}
    for family in ("mockingjay", "apc", "npc"):
        _, pmodel = mel_models(family, **{MEL[family][3]: 0.1})
        port_heads_init(pmodel)
        layers = {"mockingjay": 3, "apc": 3, "npc": 5}[family]
        hidden = {"mockingjay": 64, "apc": 32, "npc": 32}[family]
        ups[family] = Upstream(family, _FeatsModel(pmodel).eval(), layers, hidden, 160)
    _, pcfg = mos_configs("tera", 0.1)
    mos = MosModel(pcfg)
    port_heads_init(mos)
    ups["mos_tera"] = Upstream("mos_tera", mos.eval(), 1, 1, 160)
    return ups


def test_trainer_trains_a_probe_over_train_mode_upstreams(trunk_params, tmp_path):
    """upstream_trainable with the dropouts on: the probe takes two
    updates, the upstream none; no upstream parameter gets a gradient and
    the states need none."""
    for name, up in _trainable_upstreams(trunk_params).items():
        before = {k: v.clone() for k, v in up.model.state_dict().items()}
        seen = []
        hook = up.model.register_forward_hook(
            lambda m, i, o: seen.append((m.training, o[0].requires_grad)))
        task = _task(up.num_layers, up.hidden_size)
        trainer = Trainer(up, task, tmp_path / name,
                          TrainerConfig(**dict(TRAIN, upstream_trainable=True)))
        trainer.train(_Loader(_batches(2)))
        hook.remove()
        assert seen == [(True, False)] * 2, name
        assert all(p.grad is None for p in up.model.parameters()), name
        assert all(torch.equal(before[k], v) for k, v in up.model.state_dict().items()), name
        assert all(torch.isfinite(p).all() for p in task.module.parameters()), name


class _DropHead(port_heads.UtteranceLevel):
    """UtteranceLevel over its input at dropout 0.5, drawn from the
    probe's generator."""

    def forward(self, xs, xs_len, generator=None):
        xs = port_heads.dropout(xs, 0.5, self.training, generator)
        return super().forward(xs, xs_len, generator)


def test_probe_draws_do_not_move(trunk_params, tmp_path):
    """At rates 0 a trainable upstream's step is the frozen one: the same
    losses and probe, so the probe's generator stream is unchanged by the
    upstream's own."""
    up = port_trunk("hubert-pre-ln", trunk_params["hubert-pre-ln"])
    results = []
    for trainable in (False, True):
        task = UtteranceClassificationTask(UpstreamDownstreamModel(
            _DropHead(128, 4, (8,)), 3), 4)
        trainer = Trainer(up, task, tmp_path / str(trainable),
                          TrainerConfig(**dict(TRAIN, upstream_trainable=trainable)))
        trainer.train(_Loader(_batches(2)))
        results.append({k: v.clone() for k, v in task.module.state_dict().items()})
    for k, v in results[0].items():
        assert torch.equal(v, results[1][k]), k
