"""The legacy surface of s3prl_tpu_torch vs s3prl_tpu (CPU): the
`run_downstream` CLI shim (train, evaluate, inference, the Hub flag), Hub
staging (`train.hub_export`) and the SUPERB submission packager
(`submit`), each held to the JAX package's own tests of them
(tests/test_integration.py, tests/test_hub_export.py) on the port's
checkpoint format (``model.pt`` / ``optimizer.pt`` step directories). The
shim's example runs train the default ``fbank`` upstream on the CPU
(``-o build_upstream.device=cpu``). Nothing here reaches the network:
every Hub call runs without a token.
"""

import shutil
import zipfile
from pathlib import Path

import pytest
import torch
import yaml

from s3prl_tpu import run_downstream as jax_rd
from s3prl_tpu import submit as jax_submit
from s3prl_tpu_torch import run_downstream as rd
from s3prl_tpu_torch import submit
from s3prl_tpu_torch.problem import CommonExample
from s3prl_tpu_torch.train import checkpoint as ckpt
from s3prl_tpu_torch.train.hub_export import push_to_hub, stage_hub_repo

SHORT = ("build_upstream.device=cpu,,train.total_steps=2,,train.save_step=2,,"
         "train.eval_step=2,,train.log_step=2")


@pytest.fixture
def no_token(monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("HUGGING_FACE_HUB_TOKEN", raising=False)


def test_shim_flags_and_names_are_the_jax_ones():
    """The 20 legacy names map to the same recipes, each registered in the
    port; the flags parse alike."""
    assert rd.DOWNSTREAM_TO_PROBLEM == jax_rd.DOWNSTREAM_TO_PROBLEM
    assert len(rd.DOWNSTREAM_TO_PROBLEM) == 20
    for name in set(rd.DOWNSTREAM_TO_PROBLEM.values()):
        rd.Problem.get_class_from_name(name)
    argv = ["-m", "inference", "-u", "hubert", "-d", "sid", "-p", "/x", "-k", "c.pt", "-s",
            "3", "-o", "a.b=1", "-t", "u.wav", "-a", "--push_to_hf_hub", "--hf_hub_org", "org"]
    assert vars(rd.get_args(argv)) == vars(jax_rd.get_args(argv))


def test_shim_config(monkeypatch):
    """-u, -k (SUpstream's path_or_url), -o (the legacy syntax, literal
    values, hub.load's keywords filed under extra_conf) and -a reach the
    recipe's run."""
    seen = {}

    def run(self, target_dir, start=0, stop=None, **config):
        seen.update(config, target_dir=target_dir, start=start)

    monkeypatch.setattr(CommonExample, "run", run)
    rd.main(["-m", "evaluate", "-u", "hubert", "-d", "example", "-p", "/exp", "-k", "c.pt",
             "-a", "-o", "build_upstream.device=cpu,,build_upstream.dtype=bf16,,"
             "build_upstream.normalize=True,,train.total_steps=7"])
    assert seen["target_dir"] == "/exp" and seen["start"] == len(CommonExample.STAGES) - 1
    assert seen["build_upstream"] == {"name": "hubert", "path_or_url": "c.pt",
                                      "normalize": True,
                                      "extra_conf": {"device": "cpu", "dtype": "bf16"}}
    assert seen["train"]["total_steps"] == 7 and seen["train"]["auto_resume"] is True
    with pytest.raises(SystemExit, match="unknown downstream"):
        rd.main(["-d", "nope", "-p", "/exp"])


def test_run_downstream_shim(tmp_path):
    """-m train -u fbank -d example -p <dir> with -o overrides writes
    result.yaml (tests/test_integration.py::test_run_downstream_shim)."""
    rd.main(["-m", "train", "-u", "fbank", "-d", "example", "-p", str(tmp_path), "-o", SHORT])
    result = yaml.safe_load((tmp_path / "result.yaml").read_text())
    assert 0.0 <= result["test"]["accuracy"] <= 1.0
    assert ckpt.latest_checkpoint(tmp_path / "train").name == "step_2"


def test_shim_inference_mode_and_hub_flag(tmp_path, no_token):
    """Train through the shim with --push_to_hf_hub (staged offline), then
    `-m inference -t <file>` predicts one of the example's labels
    (tests/test_integration.py::test_shim_inference_mode)."""
    expdir = tmp_path / "exp"
    rd.main(["-m", "train", "-d", "example", "-p", str(expdir), "-o", SHORT,
             "--push_to_hf_hub"])
    staged = list((expdir / "hf_hub").iterdir())
    assert len(staged) == 1 and staged[0].name.startswith("fbank__")
    assert (staged[0] / "model" / "model.pt").exists()
    assert "library_name: s3prl_tpu_torch" in (staged[0] / "README.md").read_text()
    wav = next((expdir / "wavs").glob("test_*.wav"))
    pred = rd.main(["-m", "inference", "-d", "example", "-p", str(expdir), "-t", str(wav),
                    "-o", "build_upstream.device=cpu"])
    assert pred in {"alpha", "beta", "gamma"}
    assert (expdir / "inference.txt").read_text().strip().endswith(pred)


def _fake_expdir(tmp_path: Path) -> Path:
    """An experiment with a complete dev-best checkpoint in the port's
    format, its config and result."""
    exp = tmp_path / "exp"
    ckpt.save_checkpoint(exp / "train", 8, {"w": torch.ones(2)}, {"state": {}})
    ckpt.mark_valid_best(exp / "train", 8)
    shutil.rmtree(exp / "train" / "step_8")
    (exp / "config.yaml").write_text("build_upstream:\n  name: hubert\n")
    (exp / "result.yaml").write_text("test:\n  accuracy: 0.97\n")
    return exp


def test_stage_hub_repo_layout(tmp_path):
    """tests/test_hub_export.py::test_stage_hub_repo_layout on the port's
    checkpoints: the dev-best under model/, the experiment without hf_hub,
    the card."""
    exp = _fake_expdir(tmp_path)
    root = stage_hub_repo(exp, upstream="hubert", problem="SuperbSID",
                          repo_name="hubert__abc123")
    assert root.name == "hubert__abc123"
    model_state, opt_state, _ = ckpt.load_checkpoint(root / "model")
    assert torch.equal(model_state["w"], torch.ones(2)) and opt_state == {"state": {}}
    assert (root / "experiment" / "config.yaml").exists()
    assert not (root / "experiment" / "hf_hub").exists()
    card = (root / "README.md").read_text()
    assert "s3prl_tpu_torch" in card and "hubert" in card and "accuracy: 0.97" in card
    assert "model.pt" in card and "upstream:hubert" in card
    again = stage_hub_repo(exp, repo_name="hubert__abc123")  # restaged in place
    assert not (again / "experiment" / "hf_hub").exists()


def test_stage_falls_back_to_latest_step(tmp_path):
    exp = _fake_expdir(tmp_path)
    shutil.move(str(exp / "train" / "valid_best"), str(exp / "train" / "step_8"))
    root = stage_hub_repo(exp, repo_name="r1")
    assert (root / "model" / "model.pt").exists()
    shutil.rmtree(exp / "train")
    assert not (stage_hub_repo(exp, repo_name="r2") / "model").exists()


def test_push_without_token_returns_staged_path(tmp_path, no_token):
    exp = _fake_expdir(tmp_path)
    out = push_to_hub(exp, upstream="fbank", problem="SuperbKS")
    assert Path(out).is_dir()  # staged locally, not a URL
    assert (Path(out) / "README.md").exists() and Path(out).name.startswith("fbank__")


def test_submit_packager_matches_jax(tmp_path):
    """tests/test_integration.py::test_submit_packager: the same zip entries
    as the JAX packager's for two tasks; no expdir raises."""
    exp = tmp_path / "exp"
    (exp / "train").mkdir(parents=True)
    (exp / "result.yaml").write_text("test: {accuracy: 0.5}")
    (exp / "predict.csv").write_text("id,label\n")
    (exp / "train" / "metrics.jsonl").write_text('{"mode": "train"}')
    out, jax_out = tmp_path / "port.zip", tmp_path / "jax.zip"
    submit.main(["--output", str(out), "--sid", str(exp), "--ks", str(exp)])
    jax_submit.main(["--output", str(jax_out), "--sid", str(exp), "--ks", str(exp)])
    names = zipfile.ZipFile(out).namelist()
    assert names == zipfile.ZipFile(jax_out).namelist()
    assert "submission/sid/result.yaml" in names and "submission/ks/train_metrics.jsonl" in names
    assert submit.TASKS == jax_submit.TASKS
    with pytest.raises(SystemExit, match="no task expdirs"):
        submit.main(["--output", str(tmp_path / "none.zip")])
