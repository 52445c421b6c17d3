"""SUPERB-SG's enhancement and separation in s3prl_tpu_torch vs s3prl_tpu
(CPU): the host metrics (STOI, eSTOI, PESQ, the analytic PESQ, SI-SDR),
SeparationTask with one and two sources against the JAX task with the
same head weights (the recipe's SepRNN, dropout 0: the packages'
generators differ), SeExample through `Problem.run` on the fbank front
end, the recipes' configs, and the JAX package's frame-rate defect, which
the port copies.

The task batch (B = 4, a 1-s bucket) holds a row whose upstream states,
mixture and sources are row 0's with the sources swapped (its best
permutation is the other one) and a row with two equal sources (a tie:
both packages take the first minimum). The states come at the STFT's rate
(101 frames) and at half of it (51, a stride-320 upstream's).

Tolerances: the metrics equal on the same numpy input; the loss at rtol
1e-5, best_perm equal, masks and the reconstructions at atol 1e-5, every
gradient at atol 1e-5 (the reconstructions by `test_torch_port_audio`'s
iSTFT rule where the window sum vanishes at a cut reconstruction's end),
the reduction's logs at rtol 1e-4 (on each
package's own reconstructions).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from s3prl_tpu.metric import quality as jax_quality
from s3prl_tpu.task.enhancement import si_sdr as jax_si_sdr
from s3prl_tpu_torch.metric import quality
from s3prl_tpu_torch.task.enhancement import si_sdr
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_audio import _istft_close
from test_torch_port_w2v2 import perturbed

KEY = jax.random.key(0)
L, B, H, T_WAV = 2, 4, 24, 16000
LENS = np.asarray([16000, 16000, 12000, 9000], np.int32)


def _signals(seed=0, n=12000):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    clean = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))).astype(
        np.float32)
    return clean, (clean + 0.2 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("metric", ["stoi", "estoi", "pesq", "pesq nb", "pesq_analytic",
                                    "si_sdr"])
def test_quality_metrics_equal_jax(metric):
    clean, noisy = _signals()
    if metric == "si_sdr":
        assert si_sdr(noisy, clean) == jax_si_sdr(noisy, clean)
        assert si_sdr(np.zeros(10), np.zeros(10)) == jax_si_sdr(np.zeros(10), np.zeros(10))
        return
    name, _, option = metric.partition(" ")
    kwargs = ({"extended": True} if name == "estoi" else {"mode": option} if option else {})
    fn = "stoi" if name == "estoi" else name
    got = getattr(quality, fn)(clean, noisy, 16000, **kwargs)
    want = getattr(jax_quality, fn)(clean, noisy, 16000, **kwargs)
    assert got == want and np.isfinite(got)


# -- the task ----------------------------------------------------------------------


def task_pair(num_sources):
    """The recipe's JAX and port task over an upstream of L layers of width
    H: SepRNN of 2 x BLSTM 16, dropout 0."""
    up = types.SimpleNamespace(num_layers=L, hidden_sizes=[H] * L)
    name = "SuperbSE" if num_sources == 1 else "SuperbSS"
    config = getattr(jax_problem, name)().default_config()
    config["build_downstream"] = {"hidden_size": 16, "num_layers": 2, "dropout": 0.0}
    return (getattr(jax_problem, name)().build_task(up, config),
            getattr(port_problem, name)().build_task(up, config))


def task_batch(num_sources, T, seed=1):
    """hs [L, B, T, H] and a 1-s bucket of mixtures and sources: row 1 is
    row 0 with its sources swapped, row 2's sources are equal."""
    rng = np.random.RandomState(seed)
    valid = np.arange(T_WAV) < LENS[:, None]
    hs = rng.randn(L, B, T, H).astype(np.float32)
    sources = (rng.randn(B, num_sources, T_WAV) * 0.1 * valid[:, None]).astype(np.float32)
    hs[:, 1] = hs[:, 0]
    sources[1] = sources[0, ::-1]
    sources[2, :] = sources[2, :1]
    x = (sources.sum(1) + 0.05 * rng.randn(B, T_WAV) * valid).astype(np.float32)
    x[1] = x[0]
    h_lens = np.minimum((LENS - 1) // (T_WAV // (T - 1)) + 1, T).astype(np.int32)
    return hs, h_lens, {"x": x, "x_len": LENS, "sources": sources}


def test_enhancement_task_matches_jax():
    """EnhancementTask (one source) at the STFT's rate (101 frames):
    `task_matches_jax`, the reduction's si_sdr, si_sdri, stoi and pesq
    included (SeparationTask's two sources at 51 frames:
    test_torch_port_separation)."""
    task_matches_jax(1, 101)


def task_matches_jax(num_sources, T):
    """Train mode: the loss, best_perm, masks and every gradient; eval mode:
    the cache (masks, out_lens, the reconstructions [B, S, <= 16,000]) and,
    where the reconstructions cover the utterances, the reduction's logs."""
    jax_task, task = task_pair(num_sources)
    hs, h_lens, batch = task_batch(num_sources, T)
    params = perturbed(jax.jit(lambda k, x: jax_task.init_params(
        k, x, jnp.asarray(h_lens), batch))(KEY, jnp.asarray(hs)))
    task.module.load_state_dict(probe_state_dict_from_jax(params))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, want_cache), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_task.loss_and_cache(p, jnp.asarray(hs), jnp.asarray(h_lens), jbatch, KEY,
                                          True), has_aux=True))(params)
    loss, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(h_lens), batch,
                                      None, True)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert cache.keys() == want_cache.keys()
    np.testing.assert_array_equal(cache["best_perm"].numpy(), np.asarray(want_cache["best_perm"]))
    np.testing.assert_array_equal(cache["out_lens"].numpy(), np.asarray(want_cache["out_lens"]))
    if num_sources == 2:
        best = cache["best_perm"].tolist()
        assert best[1] == 1 - best[0] and best[2] == 0  # swapped; the tie's first
    np.testing.assert_allclose(cache["masks"].numpy(), np.asarray(want_cache["masks"]), atol=1e-5)
    loss.backward()
    grads = probe_state_dict_from_jax(grads)
    for k, p in task.module.named_parameters():
        if p.requires_grad:  # bias_ih: held at zero
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)

    want, want_cache = jax.jit(lambda p: jax_task.loss_and_cache(
        p, jnp.asarray(hs), jnp.asarray(h_lens), jbatch, KEY, False))(params)
    with torch.no_grad():
        _, cache = task.loss_and_cache(torch.from_numpy(hs), torch.from_numpy(h_lens), batch,
                                       None, False)
    assert cache.keys() == want_cache.keys()
    Tm = min(T, 101)
    assert cache["est_wav"].shape == (B, num_sources, min(T_WAV, 256 + 160 * (Tm - 1)))
    for k in ("masks", "x", "sources"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(want_cache[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    _istft_close(cache["est_wav"].numpy().reshape(B * num_sources, -1),
                 np.asarray(want_cache["est_wav"]).reshape(B * num_sources, -1), Tm, "est_wav")
    if T < 101:  # the reconstruction falls short of the utterances: both raise
        return
    record = lambda c: {**{k: np.asarray(v) for k, v in c.items()},
                        "unique_name": [f"u{b}" for b in range(B)]}
    want_logs = jax_task.reduction("test", [record(want_cache)])
    got_logs = task.reduction("test", [record(cache)])
    assert got_logs.keys() == want_logs.keys() == (
        {"loss", "si_sdr", "si_sdri"} | ({"stoi", "pesq"} if num_sources == 1 else set()))
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k], want_logs[k], rtol=1e-4, err_msg=k)


# -- the recipes' configs and preparers --------------------------------------------


@pytest.mark.parametrize("name", ["SuperbSS", "SuperbSE", "SeExample"])
def test_default_config_matches_jax(name):
    assert getattr(port_problem, name)().default_config() == \
        getattr(jax_problem, name)().default_config()


def test_libri2mix_and_voicebank_preparers_equal_jax(tmp_path):
    """Stage 0 of SuperbSS on Libri2Mix's metadata CSVs and of SuperbSE on
    Voicebank-DEMAND's folders, byte for byte."""
    meta = tmp_path / "libri2mix" / "wav16k" / "min" / "metadata"
    meta.mkdir(parents=True)
    for name in ("train-100", "dev", "test"):
        (meta / f"mixture_{name}_mix_clean.csv").write_text(
            "mixture_ID,mixture_path,source_1_path,source_2_path\n"
            + "".join(f"{name}{i},/m/{name}{i}.wav,/s1/{i}.wav,/s2/{i}.wav\n" for i in range(3)))
    vb = tmp_path / "voicebank"
    for d in ("noisy_trainset_wav", "clean_trainset_wav", "noisy_testset_wav"):
        (vb / d).mkdir(parents=True)
    for i in (2, 0, 1):
        (vb / "noisy_trainset_wav" / f"p{i}.wav").write_bytes(b"")
    (vb / "noisy_testset_wav" / "q0.wav").write_bytes(b"")
    for recipe, cfg in (("SuperbSS", {"libri2mix": str(tmp_path / "libri2mix")}),
                        ("SuperbSE", {"voicebank": str(vb)})):
        for pkg in ("jax", "port"):
            ws = tmp_path / recipe / pkg
            ws.mkdir(parents=True)
            getattr(jax_problem if pkg == "jax" else port_problem, recipe)().prepare_data(
                ws, {"prepare_data": cfg})
        names = sorted(p.name for p in (tmp_path / recipe / "jax").glob("*.csv"))
        assert names == sorted(p.name for p in (tmp_path / recipe / "port").glob("*.csv"))
        assert len(names) == (3 if recipe == "SuperbSS" else 2)
        for n in names:
            assert (tmp_path / recipe / "port" / n).read_bytes() == \
                (tmp_path / recipe / "jax" / n).read_bytes()
