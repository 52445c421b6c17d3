"""Directory checkpoints + auto-resume (port of s3prl_tpu/train/checkpoint.py).

Behavioral spec from the reference's new-API checkpoint scheme
(s3prl/problem/base.py:374-421, 470-503, 601-628): per-step directories
`step_<N>/` holding the model / optimizer state / training stats + config,
`valid_best/` tracked by a configurable metric/direction, `keep_num_ckpts`
GC, and resume = newest step dir. The model and optimizer are `torch.save`
state dicts (`model.pt`, `optimizer.pt`); stats/config are yaml.
"""

from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

import yaml
import torch

logger = logging.getLogger(__name__)

# Written last, inside the tmp dir, before the atomic rename: a step dir
# without it is an interrupted write and is never resumed from.
COMPLETE_MARKER = ".complete"


def save_checkpoint(
    exp_dir,
    step: int,
    model_state: dict,
    opt_state: Optional[dict] = None,
    stats: Optional[dict] = None,
    config: Optional[dict] = None,
    keep_num_ckpts: Optional[int] = 2,
) -> Path:
    """Atomic directory checkpoint: write to `step_<N>.tmp`, fsync-free but
    marker-gated, then `os.replace` into place — a crash mid-write can never
    leave a corrupt `step_<N>/` for auto-resume to pick (the reference uses
    the same tempfile+move discipline for downloads,
    s3prl/util/download.py:65-99)."""
    step_dir = Path(exp_dir) / f"step_{step}"
    tmp_dir = Path(exp_dir) / f"step_{step}.tmp"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    torch.save(model_state, tmp_dir / "model.pt")
    if opt_state is not None:
        torch.save(opt_state, tmp_dir / "optimizer.pt")
    with open(tmp_dir / "training_stats.yaml", "w") as f:
        yaml.safe_dump(dict(step=step, **(stats or {})), f)
    if config is not None:
        with open(tmp_dir / "config.yaml", "w") as f:
            yaml.safe_dump(config, f)
    # marker records the byte size of every payload file so that both
    # interrupted writes AND post-write corruption (e.g. truncation) are
    # detected and the dir skipped on resume
    sizes = {
        p.name: p.stat().st_size
        for p in tmp_dir.iterdir()
        if p.name != COMPLETE_MARKER
    }
    with open(tmp_dir / COMPLETE_MARKER, "w") as f:
        yaml.safe_dump(sizes, f)
    if step_dir.exists():  # re-save of the same step (e.g. after resume)
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    if keep_num_ckpts:
        _gc_old_ckpts(exp_dir, keep_num_ckpts)
    return step_dir


def _is_complete(d: Path) -> bool:
    marker = d / COMPLETE_MARKER
    if not marker.exists():
        return False
    try:
        with open(marker) as f:
            sizes = yaml.safe_load(f) or {}
        for name, size in sizes.items():
            if (d / name).stat().st_size != size:
                logger.warning("checkpoint %s: %s size mismatch — skipping", d, name)
                return False
    except OSError:
        return False
    return True


def _step_dirs(exp_dir) -> list:
    dirs = [
        d
        for d in Path(exp_dir).glob("step_*")
        if d.is_dir() and not d.name.endswith(".tmp") and _is_complete(d)
    ]
    return sorted(dirs, key=lambda d: int(d.name.split("_")[1]))


def _gc_old_ckpts(exp_dir, keep: int) -> None:
    dirs = _step_dirs(exp_dir)
    for d in dirs[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_checkpoint(exp_dir) -> Optional[Path]:
    dirs = _step_dirs(exp_dir)
    return dirs[-1] if dirs else None


def load_checkpoint(step_dir, map_location=None) -> Tuple[dict, Optional[dict], dict]:
    """(model state dict, optimizer state dict or None, training stats)."""
    step_dir = Path(step_dir)
    model_state = torch.load(step_dir / "model.pt", map_location=map_location)
    opt_state = None
    if (step_dir / "optimizer.pt").exists():
        opt_state = torch.load(step_dir / "optimizer.pt", map_location=map_location)
    with open(step_dir / "training_stats.yaml") as f:
        stats = yaml.safe_load(f) or {}
    return model_state, opt_state, stats


def mark_valid_best(exp_dir, step: int) -> None:
    """Copy step_<N> to valid_best/ (reference: problem/base.py:601-612).

    Atomic like save_checkpoint: stage to valid_best.tmp then rename, so a
    crash mid-copy can't leave a half-written valid_best/."""
    src = Path(exp_dir) / f"step_{step}"
    dst = Path(exp_dir) / "valid_best"
    tmp = Path(exp_dir) / "valid_best.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    shutil.copytree(src, tmp)
    if dst.exists():
        shutil.rmtree(dst)
    os.replace(tmp, dst)
