"""The Trainer on the CTC task of s3prl_tpu_torch vs s3prl_tpu (CPU): three
steps of frozen-upstream BLSTM-CTC training on the tiny trunk of
`test_torch_port_probe`, every batch holding a row its frames cannot emit
(optax's loss near 1e5, which both packages train on).

Tolerances: per-step losses, gradient norms and greedy WER / CER at rtol
1e-5; the final probe parameters at atol 2e-6. test_torch_port_train's 1e-6
holds on batches without an infeasible row (measured 3e-7), but the
infeasible rows' gradients come through values near 1e5, whose f32 steps
are 2**-7, and Adam's first moves are about lr x sign(g), so a gradient
within rounding of zero can move a weight by up to 2 lr: one weight in
4,096 lands 1.5e-6 away (measured).
"""

import numpy as np
import jax

import s3prl_tpu.nn.heads as jax_heads
from s3prl_tpu.data.encoder import CharacterTokenizer as JaxCharacterTokenizer
from s3prl_tpu.nn.upstream import UpstreamDownstreamModel as JaxModel
from s3prl_tpu.task.speech2text_ctc import Speech2TextCTCTask as JaxCTCTask
from s3prl_tpu.train.trainer import Trainer as JaxTrainer
from s3prl_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from s3prl_tpu_torch.data.collate import pad_collate
from s3prl_tpu_torch.data.encoder import CharacterTokenizer
from s3prl_tpu_torch.nn import RNNEncoder, UpstreamDownstreamModel
from s3prl_tpu_torch.task import Speech2TextCTCTask
from s3prl_tpu_torch.train.trainer import Trainer, TrainerConfig
from s3prl_tpu_torch.upstream.convert import probe_state_dict_from_jax
from test_torch_port_asr import TEXTS
from test_torch_port_probe import tiny_pair  # noqa: F401 (fixture)
from test_torch_port_train import _Loader, _losses, capture_init, start_from


def _asr_batches(tokenizer, n=3, T_=6400, seed=11):
    """Batches of the tiny trunk's waves with transcripts; the 401-sample
    row has 2 frames and 3 tokens (infeasible: about 1e5, as in JAX)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lens = np.asarray([T_, T_ - 1500 * (i + 1), 401], np.int32)
        x = (rng.randn(3, T_) * (np.arange(T_) < lens[:, None])).astype(np.float32)
        texts = [TEXTS[(i + b) % len(TEXTS)] for b in range(2)] + ["abc"]
        items = [{"class_ids": np.asarray(tokenizer.encode(t), np.int32), "labels": t,
                  "unique_name": f"u{i}_{b}"} for b, t in enumerate(texts)]
        out.append({"x": x, "x_len": lens, **pad_collate(items)})
    return out


def test_ctc_trainer_matches_jax(tiny_pair, tmp_path):
    """Three Trainer steps (featurizer -> RNNEncoder(2 layers) -> CTC ->
    clip -> Adam) in both packages, an infeasible row in every batch:
    per-step losses, gradient norms (the norm holds no bias_ih: it is not
    trained) and greedy WER / CER, then the probe's final parameters."""
    jax_up, port_up = tiny_pair
    train = dict(total_steps=3, log_step=1, eval_step=100, save_step=100, tensorboard=False,
                 optimizer={"name": "Adam", "lr": 1e-3})
    jax_tok, port_tok = JaxCharacterTokenizer.from_text(TEXTS), CharacterTokenizer.from_text(TEXTS)
    batches = _asr_batches(port_tok)
    jax_task = JaxCTCTask(JaxModel(jax_heads.RNNEncoder(
        jax_tok.vocab_size, hidden_size=8, num_layers=2, proj_size=8, dropout=0.0), 3), jax_tok)
    captured = capture_init(jax_task)
    jax_trainer = JaxTrainer(jax_up, jax_task, tmp_path / "jax", JaxTrainerConfig(**train))
    jax_trainer.train(_Loader(batches))
    task = start_from(Speech2TextCTCTask(UpstreamDownstreamModel(RNNEncoder(
        128, port_tok.vocab_size, 8, 2, proj_size=8, dropout=0.0), 3), port_tok), captured)
    trainer = Trainer(port_up, task, tmp_path / "port", TrainerConfig(**train))
    trainer.train(_Loader(batches))
    for key in ("loss", "grad_norm", "wer", "cer"):
        want, got = _losses(tmp_path / "jax", key), _losses(tmp_path / "port", key)
        assert len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    assert min(_losses(tmp_path / "port")) > 1e4  # the infeasible rows
    want = probe_state_dict_from_jax(jax.device_get(jax_trainer.params))
    got = trainer.task.module.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=2e-6, rtol=0,
                                   err_msg=k)
