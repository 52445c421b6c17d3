"""StExample of s3prl_tpu_torch vs s3prl_tpu through `Problem.run` (CPU), on
its default upstream, fbank: stage 0's toy translations, stage 1's subword
tokenizer (byte-equal JSON), four steps of the FrameLevelLinear encoder and
the decoder (Adam 1e-3, linear schedule) with a valid pass every 2 steps
(teacher-forced BLEU, dev-best), then greedy decoding to 128 tokens and the
test BLEU. Both packages train on the port's fbank states (the JAX
recipe's upstream runs them through a host callback, `_mirror`), the
port's module starting from the JAX task's initial params (captured from
its ``init_params``); the decoder's dropout is 0 in both (the packages'
generators differ).

Tolerances: the train losses at rtol 1e-5, each saved parameter by
`test_torch_port_frame_probe`'s rule, the attention keys' biases within 2
lr an update (a key bias adds q . b to every score of a query, which the
softmax cancels: its gradient is zero but for rounding, which Adam scales
to a move of up to lr; measured 1.8e-4 apart after two updates of 1e-3),
the test BLEU equal.
"""

import functools

import s3prl_tpu.problem as jax_problem
import s3prl_tpu.problem.translation as jax_translation
import s3prl_tpu_torch.problem as port_problem
import s3prl_tpu_torch.problem.translation as port_translation
from s3prl_tpu.nn.upstream import SUpstream as JaxSUpstream
from s3prl_tpu_torch.nn.upstream import SUpstream
from test_torch_port_enhancement_recipe import fbank_states  # noqa: F401 (fixture)
from test_torch_port_frame_probe import results, same_training
from test_torch_port_probe import _wrap
from test_torch_port_train import start_from


def test_st_example_matches_jax(tmp_path, fbank_states, monkeypatch):  # noqa: F811
    jax_up, port_up = fbank_states
    captured = {}

    class Capturing(jax_translation.SpeechTranslationTask):
        def init_params(self, *args):
            captured["params"] = super().init_params(*args)
            return captured["params"]

    class PortExample(port_problem.StExample):
        def build_upstream(self, **kwargs):
            return _wrap(SUpstream, port_up, False)

        def build_task(self, *args, **kwargs):
            return start_from(super().build_task(*args, **kwargs), captured)

    monkeypatch.setattr(jax_translation, "SUpstream",
                        lambda **kwargs: _wrap(JaxSUpstream, jax_up, False))
    monkeypatch.setattr(jax_translation, "SpeechTranslationTask", Capturing)
    for module in (jax_translation, port_translation):
        monkeypatch.setattr(module, "DecoderConfig",
                            functools.partial(module.DecoderConfig, dropout=0.0))
    config = jax_problem.StExample().default_config()
    config.pop("target_dir")
    assert config["build_upstream"] == {"name": "fbank"}
    config["train"] = {**config["train"], "tensorboard": False}
    jax_problem.StExample().run(str(tmp_path / "jax"), **config)
    PortExample().run(str(tmp_path / "port"), **config)
    for name in ("train.csv", "tokenizer.json"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text() \
            .replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    same_training(tmp_path, 1e-3, shifts=(".k.bias",))
    got, want = results(tmp_path)
    assert set(got["test"]) == set(want["test"]) == {"bleu"}
    assert got["test"]["bleu"] == want["test"]["bleu"]
