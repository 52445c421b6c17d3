"""SUPERB leaderboard submission packager (port of s3prl_tpu/submit.py; the
reference's s3prl/submit/submit.py): each task's prediction artifacts from
its experiment directory into the zip layout the leaderboard expects, one
directory a task.

    python -m s3prl_tpu_torch.submit --output submission.zip \\
        --asr exp/asr --sid exp/sid ...
"""

from __future__ import annotations

import argparse
import logging
import shutil
import tempfile
import zipfile
from pathlib import Path

logger = logging.getLogger(__name__)

TASKS = ["pr", "asr", "ks", "ic", "sf", "sid", "asv", "sd", "er", "qbe", "se", "ss", "st"]


def collect(task: str, expdir: Path, staging: Path) -> None:
    """Copies the task's result.yaml, metrics.jsonl, predict.csv and
    trials.csv (those present) and its training metrics into staging/task."""
    task_dir = staging / task
    task_dir.mkdir(parents=True, exist_ok=True)
    for name in ["result.yaml", "metrics.jsonl", "predict.csv", "trials.csv"]:
        src = expdir / name
        if src.exists():
            shutil.copy(src, task_dir / name)
    train_dir = expdir / "train"
    if (train_dir / "metrics.jsonl").exists():
        shutil.copy(train_dir / "metrics.jsonl", task_dir / "train_metrics.jsonl")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", required=True)
    for task in TASKS:
        parser.add_argument(f"--{task}", default=None, help=f"{task} expdir")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        staging = Path(tmp) / "submission"
        staging.mkdir()
        found = 0
        for task in TASKS:
            expdir = getattr(args, task)
            if expdir:
                collect(task, Path(expdir), staging)
                found += 1
        if not found:
            raise SystemExit("no task expdirs given")
        with zipfile.ZipFile(args.output, "w", zipfile.ZIP_DEFLATED) as z:
            for f in sorted(staging.rglob("*")):
                if f.is_file():
                    z.write(f, f.relative_to(staging.parent))
    logger.info(f"wrote {args.output} with {found} tasks")


if __name__ == "__main__":
    main()
