"""Voice conversion in s3prl_tpu_torch vs s3prl_tpu (CPU): the Taco2-AR
decoder, Griffin-Lim and `log_mel_to_wav`, MCD, one VC task step, the
frame-rate failure over a 320-stride upstream, and VcExample end to end.

The JAX params (every leaf perturbed) reach the port through
`probe_state_dict_from_jax`. The prenet's dropout stays on at inference in
both packages, drawn from streams of their own, so the comparisons turn it
off in both: the JAX `_Prenet` replaced by one without its dropout, the
port's `PRENET_DROPOUT` set to 0 (monkeypatch). Tolerances: the decoder at
atol 1e-5 in f32; the task's loss and MCD at rtol 1e-5, its gradients at
rtol 1e-4 / atol 1e-6; MCD exactly equal (the same numpy DP); Griffin-Lim's
waves at atol 2e-4 of their peak after 4 iterations and 2e-3 after 32 on
the same magnitudes (a bin the clip zeroed has rounding for its phase in
either package, and each round feeds the last one's phases back). `log_mel_to_wav` is held to JAX's Griffin-Lim on numpy's
float64 magnitudes: its filter bank's pinv is ill-conditioned, and JAX's
f32 product moves the magnitudes by up to 0.4% of their peak
(`ops.vocoder`).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import s3prl_tpu.models.taco2ar as jax_taco2ar
import s3prl_tpu_torch.models.taco2ar as port_taco2ar
from s3prl_tpu.data.collate import pad_collate as jax_pad_collate
from s3prl_tpu.ops import vocoder as jax_vocoder
from s3prl_tpu.ops.audio import log_mel as jax_log_mel
from s3prl_tpu.problem.vc import VcExample as JaxVcExample
from s3prl_tpu.problem.vc import _VcDataset as JaxVcDataset
from s3prl_tpu.task.voice_conversion import mcd as jax_mcd
from s3prl_tpu_torch.data.collate import pad_collate
from s3prl_tpu_torch.models.taco2ar import Taco2ARConfig, Taco2ARDecoder
from s3prl_tpu_torch.ops import vocoder
from s3prl_tpu_torch.ops.audio import log_mel, mel_scale_matrix
from s3prl_tpu_torch.problem import VcExample
from s3prl_tpu_torch.problem.vc import _VcDataset
from s3prl_tpu_torch.task.voice_conversion import mcd
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_w2v2 import perturbed

# Griffin-Lim's waves over their peak, by iterations: the phase of a bin
# the clip zeroed is rounding in either package, and each round feeds the
# last one's phases back
GL_ATOL = {4: 2e-4, 32: 2e-3}
SMALL = dict(mel_dim=80, prenet_units=16, lstm_units=24, num_lstm_layers=2,
             postnet_channels=16, postnet_kernel=5, postnet_layers=3)


class _PrenetWithoutDropout(jax_taco2ar._Prenet):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        for i in range(2):
            x = fnn.relu(fnn.Dense(self.units, name=f"fc{i}")(x))
        return x


@pytest.fixture
def no_prenet_dropout(monkeypatch):
    monkeypatch.setattr(jax_taco2ar, "_Prenet", _PrenetWithoutDropout)
    monkeypatch.setattr(port_taco2ar, "PRENET_DROPOUT", 0.0)


def _decoder_pair(spk=0, H=16):
    cfg = dict(SMALL, spk_embed_dim=spk)
    jdec = jax_taco2ar.Taco2ARDecoder(jax_taco2ar.Taco2ARConfig(**cfg))
    feats = jnp.zeros((1, 4, H))
    mels = jnp.zeros((1, 4, 80))
    spk_embed = jnp.zeros((1, spk)) if spk else None
    params = jdec.init({"params": jax.random.key(0), "prenet": jax.random.key(1)}, feats, mels,
                       spk_embed)["params"]
    params = perturbed(params)
    pdec = Taco2ARDecoder(Taco2ARConfig(**cfg), H)
    pdec.load_state_dict(probe_state_dict_from_jax(params))
    return jdec, params, pdec


@pytest.mark.parametrize("spk", [0, 8])
def test_taco2ar_matches_flax(no_prenet_dropout, spk):
    """[2, 30, 16] features and mels through both decoders (with and
    without a speaker embedding) on the same weights, atol 1e-5."""
    jdec, params, pdec = _decoder_pair(spk)
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 30, 16).astype(np.float32)
    mels = rng.randn(2, 30, 80).astype(np.float32)
    spk_embed = rng.randn(2, spk).astype(np.float32) if spk else None
    want = jdec.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mels),
                      None if spk_embed is None else jnp.asarray(spk_embed),
                      rngs={"prenet": jax.random.key(2)})
    got = pdec(torch.from_numpy(feats), torch.from_numpy(mels),
               None if spk_embed is None else torch.from_numpy(spk_embed))
    assert got.shape == (2, 30, 80)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_prenet_drops_half_in_train_and_eval():
    """The prenet's dropout is on in eval as in train, draws from the
    generator given (one seed: bit-equal), and keeps about half: with
    positive weights and biases every unit is active, so the output's
    nonzero share is the last layer's keep rate."""
    prenet = port_taco2ar._Prenet(80, 256)
    with torch.no_grad():
        for fc in (prenet.fc0, prenet.fc1):
            fc.weight.abs_()
            fc.bias.fill_(1.0)
    x = torch.rand(64, 50, 80)
    with torch.no_grad():
        trained = prenet.train()(x, torch.Generator().manual_seed(0))
        evaluated = prenet.eval()(x, torch.Generator().manual_seed(0))
        other = prenet.eval()(x, torch.Generator().manual_seed(1))
    assert torch.equal(trained, evaluated) and not torch.equal(evaluated, other)
    share = (evaluated != 0).float().mean().item()
    assert abs(share - 0.5) < 5 * (0.25 / evaluated.numel()) ** 0.5


def _log_mels(seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(8000) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(8000),
                     0.2 * np.sin(2 * np.pi * 523 * t) + 0.02 * rng.randn(8000)])
    return log_mel(torch.from_numpy(wavs.astype(np.float32)), n_mels=80)[0]


@pytest.mark.parametrize("n_iter", [4, 32])
def test_griffin_lim_matches_jax(n_iter):
    """`griffin_lim` from zero phase on the same magnitudes (random, and a
    tone's with bins of zero)."""
    mags = {"random": np.abs(np.random.RandomState(1).randn(2, 20, 201)).astype(np.float32),
            "tone": _magnitudes(_log_mels())}
    for name, mag in mags.items():
        want = np.asarray(jax_vocoder.griffin_lim(jnp.asarray(mag), n_iter=n_iter))
        got = vocoder.griffin_lim(torch.from_numpy(mag), n_iter=n_iter).numpy()
        assert got.shape == want.shape == (2, 160 * (mag.shape[1] - 1)), name
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=GL_ATOL[n_iter],
                                   rtol=0, err_msg=name)


def _magnitudes(mels):
    """The linear magnitudes of log-mels by numpy in float64: the filter
    bank's pinv, the clip at 0, the square root."""
    inv = np.linalg.pinv(mel_scale_matrix(201, 80, 16000.0)).astype(np.float64)
    power = np.exp(np.asarray(mels, np.float64)) - 1e-10
    return np.sqrt(np.clip(power @ inv, 0.0, None)).astype(np.float32)


@pytest.mark.parametrize("n_iter", [4, 32])
def test_log_mel_to_wav_matches_jax(n_iter):
    """`log_mel_to_wav`: the magnitudes as numpy's float64 product gives
    them (JAX's f32 product moves them, see `ops.vocoder`), then JAX's
    Griffin-Lim on them, peak-normalised to 0.95."""
    mels = _log_mels()
    wav = jax_vocoder.griffin_lim(jnp.asarray(_magnitudes(mels.numpy())), n_iter=n_iter)
    want = np.asarray(wav / jnp.maximum(jnp.max(jnp.abs(wav), -1, keepdims=True), 1e-6) * 0.95)
    got = vocoder.log_mel_to_wav(mels, n_iter=n_iter).numpy()
    assert got.shape == want.shape == (2, 160 * (mels.shape[1] - 1))
    np.testing.assert_allclose(np.abs(got).max(-1), 0.95, rtol=1e-6)
    np.testing.assert_allclose(got, want, atol=GL_ATOL[n_iter], rtol=0)


def test_mcd_matches_jax():
    rng = np.random.RandomState(0)
    for T1, T2 in ((12, 12), (7, 15), (20, 9)):
        hyp = rng.randn(T1, 80).astype(np.float32)
        ref = rng.randn(T2, 80).astype(np.float32)
        assert mcd(hyp, ref) == jax_mcd(hyp, ref)


class _Up:
    num_layers = 3
    hidden_sizes = [16] * 3


def _task_pair():
    """The JAX VcExample task and the port's on its perturbed params."""
    cfg = JaxVcExample().default_config()
    jtask = JaxVcExample().build_task(_Up(), cfg)
    ptask = VcExample().build_task(_Up(), cfg)
    return jtask, ptask


def _vc_batch(T_h=60, rng=None):
    rng = rng or np.random.RandomState(0)
    hs = rng.randn(3, 2, T_h, 16).astype(np.float32)
    h_lens = np.asarray([T_h, 41], np.int32)
    target = rng.randn(2, 50, 80).astype(np.float32)
    target[1, 40:] = 0.0
    batch = {"target_mel": target, "target_mel_len": np.asarray([50, 40], np.int32)}
    return hs, h_lens, batch


def test_vc_task_step_matches_jax(no_prenet_dropout):
    """One train step's loss and gradients and one eval step's loss and
    MCD, from the same params."""
    jtask, ptask = _task_pair()
    hs, h_lens, batch = _vc_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = perturbed(jtask.init_params(jax.random.key(0), jnp.asarray(hs),
                                         jnp.asarray(h_lens), jbatch))
    ptask.module.load_state_dict(probe_state_dict_from_jax(params))

    def jloss(p):
        return jtask.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(h_lens), jbatch,
                                    jax.random.key(1), True)

    (want, jcache), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    got, pcache = ptask.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(h_lens), batch,
                                       torch.Generator().manual_seed(0), True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    want_grads = probe_state_dict_from_jax(grads)
    for name, p in ptask.module.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    want_eval, jcache = jtask.loss_and_cache(params, jnp.asarray(hs), jnp.asarray(h_lens),
                                             jbatch, jax.random.key(1), False)
    with torch.no_grad():
        got_eval, pcache = ptask.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(h_lens),
                                                batch, torch.Generator().manual_seed(0), False)
    np.testing.assert_allclose(got_eval.item(), float(want_eval), rtol=1e-5)
    want_logs = jtask.reduction("valid", [{k: np.asarray(v) for k, v in jcache.items()}])
    got_logs = ptask.reduction("valid", [{k: v.numpy() for k, v in pcache.items()}])
    assert set(got_logs) == set(want_logs) == {"loss", "l1", "mcd"}
    for key in want_logs:
        np.testing.assert_allclose(got_logs[key], want_logs[key], rtol=1e-5, err_msg=key)


def test_vc_over_a_320_stride_upstream_fails_in_both():
    """Features at half the mels' frame rate: the decoder cannot join them
    frame by frame; JAX's concatenate and the port raise TypeError."""
    jtask, ptask = _task_pair()
    hs, h_lens, batch = _vc_batch(T_h=25)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jtask.init_params(jax.random.key(0), jnp.asarray(hs), jnp.asarray(h_lens), jbatch)
    with pytest.raises(TypeError, match="25 frames.*mels 50"):
        ptask.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(h_lens), batch,
                             torch.Generator().manual_seed(0), True)


def test_state_dict_keys_are_the_converters():
    """The port's VC model holds exactly the converter's keys, shapes
    included, for the default recipe's decoder (two LSTM layers of 512)."""
    cfg = JaxVcExample().default_config()
    cfg["build_downstream"] = {"lstm_units": 32, "num_lstm_layers": 2}
    jtask = JaxVcExample().build_task(_Up(), cfg)
    hs, h_lens, batch = _vc_batch()
    params = jtask.init_params(jax.random.key(0), jnp.asarray(hs), jnp.asarray(h_lens),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    sd = probe_state_dict_from_jax(params)
    module = VcExample().build_task(_Up(), cfg).module
    want = {k: tuple(v.shape) for k, v in sd.items()}
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want


def test_dataset_and_collate_match_jax(tmp_path):
    """_VcDataset's target log-mel and pad_collate's target_mel_len."""
    problem, config = VcExample(), VcExample().default_config()
    problem.prepare_data(tmp_path, config)
    items = [_VcDataset(tmp_path / "train.csv")[i] for i in range(3)]
    jitems = [JaxVcDataset(tmp_path / "train.csv")[i] for i in range(3)]
    for got, want in zip(items, jitems):
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_allclose(got["target_mel"], want["target_mel"], atol=1e-3, rtol=0)
    got, want = pad_collate(items), jax_pad_collate(jitems)
    np.testing.assert_array_equal(got["target_mel_len"], want["target_mel_len"])
    np.testing.assert_array_equal(got["x_len"], want["x_len"])
    assert got["target_mel"].shape == want["target_mel"].shape
    mel = np.asarray(jax_log_mel(jnp.asarray(items[0]["x"][None]), n_mels=80)[0])[0]
    np.testing.assert_allclose(items[0]["target_mel"], mel, atol=1e-3, rtol=0)


def test_vc_example_end_to_end(tmp_path):
    """VcExample through Problem.run on the port: result.yaml with finite l1
    and MCD, and a Griffin-Lim wave under wav_hyp/ for each test row."""
    import yaml

    problem = VcExample()
    config = problem.default_config()
    config.pop("target_dir")
    config["build_upstream"] = {"name": "fbank", "extra_conf": {"device": "cpu"}}
    results = problem.run(str(tmp_path), **config)
    logs = results["evaluate_stage"]["test"]
    assert np.isfinite(logs["l1"]) and np.isfinite(logs["mcd"])
    assert yaml.safe_load((tmp_path / "result.yaml").read_text()) == {"test": logs}
    waves = sorted(p.name for p in (tmp_path / "wav_hyp").glob("*.wav"))
    assert waves == ["test_0.wav", "test_1.wav"]
