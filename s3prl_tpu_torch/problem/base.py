"""Problem layer — staged recipes over the training engine (a copy of
s3prl_tpu/problem/base.py).

Behavioral spec from the reference's Problem base (s3prl/problem/base.py):
- a subclass registry keyed by class name (base.py:124-127), used by the CLI;
- `default_config()` where **top-level keys are builder-method names and
  their dicts are those methods' kwargs** — the "config mirrors the code"
  contract (base.py:48-62);
- a staged `run()` (prepare_data -> build_encoder -> train -> evaluate) with
  `start`/`stop` stage gating (base.py:943-952);
- `main(argv)`: default_config ⊕ --config yaml ⊕ dotted overrides, with
  `--print_config` and `???`-missing enforcement (base.py:954-995).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional

import yaml

from ..util.config import (
    check_no_missing,
    deep_merge,
    field_doc,
    load_yaml,
    parse_overrides,
)

logger = logging.getLogger(__name__)


class Problem:
    _registry: Dict[str, type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        Problem._registry[cls.__name__] = cls

    @classmethod
    def get_class_from_name(cls, name: str) -> type:
        if name not in cls._registry:
            raise KeyError(f"unknown problem '{name}'; available: {sorted(cls._registry)}")
        return cls._registry[name]

    # ------------------------------------------------------------------
    def default_config(self) -> dict:
        raise NotImplementedError

    #: ordered stage methods; each gets (workspace, config) and may read the
    #: artifacts of previous stages from the workspace directory
    STAGES: List[str] = []

    def run(self, target_dir: str, start: int = 0, stop: Optional[int] = None, **config):
        """Execute stages [start, stop] (inclusive), reference-style gating."""
        workspace = Path(target_dir)
        workspace.mkdir(parents=True, exist_ok=True)
        with open(workspace / "config.yaml", "w") as f:
            yaml.safe_dump({"target_dir": str(target_dir), **config}, f)
        results = {}
        for i, stage_name in enumerate(self.STAGES):
            if i < start:
                continue
            if stop is not None and i > stop:
                break
            logger.info(f"[stage {i}] {stage_name}")
            results[stage_name] = getattr(self, stage_name)(workspace, config)
        return results

    # ------------------------------------------------------------------
    def inference(self, workspace: Path, config: dict, wav_path: str):
        """Single-file prediction against the trained checkpoint (the legacy
        `-m inference` mode, s3prl/downstream/runner.py:506-524). Problems
        that support it implement it (`CommonProblem.inference`).
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not implement single-file inference"
        )

    # ------------------------------------------------------------------
    def main(self, argv: Optional[List[str]] = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        config = self.default_config()
        if "--print_config" in argv:
            print(field_doc(config))
            return None
        if "--config" in argv:
            i = argv.index("--config")
            config = deep_merge(config, load_yaml(argv[i + 1]))
            del argv[i : i + 2]
        config = deep_merge(config, parse_overrides(argv))
        check_no_missing(config)
        target_dir = config.pop("target_dir")
        start = config.pop("start", 0)
        stop = config.pop("stop", None)
        return self.run(target_dir, start=start, stop=stop, **config)
