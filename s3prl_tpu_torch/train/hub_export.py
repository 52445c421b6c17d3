"""Publish a trained downstream experiment to the Hugging Face Hub (port of
s3prl_tpu/train/hub_export.py; the reference's legacy runner,
s3prl/downstream/runner.py:526-594 push_to_huggingface_hub): stage the
experiment directory into a Hub repo layout, the dev-best checkpoint (else
the newest step) under ``model/``, a generated model card, then upload.

The checkpoints are the port's step directories (`train.checkpoint`:
``model.pt`` and ``optimizer.pt``, torch state dicts). The upload is
``huggingface_hub.HfApi.upload_folder`` when that package imports and a
token is set; otherwise `push_to_hub` returns the staged directory, ready
for ``huggingface-cli upload``. Nothing is installed or fetched here.
"""

from __future__ import annotations

import logging
import os
import shutil
import uuid
from pathlib import Path
from typing import Optional

from . import checkpoint as ckpt

logger = logging.getLogger(__name__)

_CARD_TEMPLATE = """---
library_name: s3prl_tpu_torch
tags:
- speech
- s3prl
- s3prl_tpu_torch
- benchmark:superb
{upstream_tag}---

# {repo_name}

Downstream probe trained with **s3prl_tpu_torch** (SUPERB on PyTorch and CUDA).

- upstream: `{upstream}`
- problem: `{problem}`
- experiment dir layout: `train/valid_best/model.pt` and `optimizer.pt` (torch
  state dicts), `config.yaml`, `result.yaml`, TensorBoard events.

## Results

```yaml
{results}
```

## Usage

```python
from s3prl_tpu_torch.train import checkpoint as ckpt
model_state, optimizer_state, stats = ckpt.load_checkpoint("model")
task.module.load_state_dict(model_state)
```
"""


def stage_hub_repo(
    expdir: str | os.PathLike,
    upstream: str = "unknown",
    problem: str = "unknown",
    organization: Optional[str] = None,
    repo_name: Optional[str] = None,
) -> Path:
    """Stages `expdir` into ``expdir/hf_hub/<repo_name>/``: the whole
    experiment (without ``hf_hub``) under ``experiment/``, the dev-best
    checkpoint (else the newest complete step) under ``model/``, and the
    model card ``README.md``."""
    expdir = Path(expdir)
    if repo_name is None:
        # the reference's convention: <upstream>__<id8> (runner.py:539-544)
        repo_name = f"{upstream.replace('/', '__')}__{str(uuid.uuid4())[:8]}"
    root = expdir / "hf_hub" / repo_name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(expdir, root / "experiment", ignore=shutil.ignore_patterns("hf_hub"),
                    dirs_exist_ok=True)
    # dev-best first, the newest step dir otherwise (runner.py:573-585)
    best = expdir / "train" / "valid_best"
    src = best if best.exists() else ckpt.latest_checkpoint(expdir / "train")
    if src is not None:
        shutil.copytree(src, root / "model")
    else:
        logger.warning("no checkpoint found under %s; staging without model", expdir)
    result_yaml = expdir / "result.yaml"
    results = result_yaml.read_text().strip() if result_yaml.exists() else ""
    upstream_tag = f"- upstream:{upstream}\n" if upstream != "unknown" else ""
    (root / "README.md").write_text(_CARD_TEMPLATE.format(
        repo_name=repo_name, upstream=upstream, problem=problem, results=results or "{}",
        upstream_tag=upstream_tag))
    return root


def push_to_hub(
    expdir: str | os.PathLike,
    upstream: str = "unknown",
    problem: str = "unknown",
    organization: Optional[str] = None,
    repo_name: Optional[str] = None,
    private: bool = False,
) -> str:
    """Stages the experiment and uploads it when ``huggingface_hub``
    imports and ``HF_TOKEN`` (or ``HUGGING_FACE_HUB_TOKEN``) is set: the
    repo's URL then, the staged directory otherwise."""
    root = stage_hub_repo(expdir, upstream, problem, organization, repo_name)
    repo_id = f"{organization}/{root.name}" if organization else root.name
    token = os.environ.get("HF_TOKEN") or os.environ.get("HUGGING_FACE_HUB_TOKEN")
    try:
        from huggingface_hub import HfApi
    except ImportError:
        logger.info("huggingface_hub not installed; staged repo left at %s (push it with "
                    "`huggingface-cli upload %s %s`)", root, repo_id, root)
        return str(root)
    if not token:
        logger.info("no HF token (set HF_TOKEN); staged repo left at %s", root)
        return str(root)
    api = HfApi(token=token)
    url = api.create_repo(repo_id=repo_id, private=private, exist_ok=True)
    api.upload_folder(repo_id=repo_id, folder_path=str(root))
    logger.info("pushed experiment to %s", url)
    return str(url)
