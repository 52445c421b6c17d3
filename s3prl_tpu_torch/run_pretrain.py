"""Legacy-style CLI shim: ``python -m s3prl_tpu_torch.run_pretrain -u tera -n exp``
(port of s3prl_tpu/run_pretrain.py; the reference's s3prl/run_pretrain.py:
33-58): maps ``-u recipe`` onto the Pretrain* problems and ``-o`` onto
dotted config overrides (``a.b=v,,c=w``); the recipes train on the card,
``-o device=cpu`` on the CPU."""

from __future__ import annotations

import argparse
import logging

from .problem.base import Problem
from . import problem as _registry  # noqa: F401
from .util.config import parse_override_string, set_dotted

logging.basicConfig(level=logging.INFO)

RECIPE_TO_PROBLEM = {
    "mockingjay": "PretrainMockingjay",
    "tera": "PretrainTera",
    "audio_albert": "PretrainAudioAlbert",
    "apc": "PretrainAPC",
    "hubert": "PretrainHubert",
    "example": "PretrainExample",
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-u", "--upstream", required=True, help="pretraining recipe")
    parser.add_argument("-n", "--expdir", required=True)
    parser.add_argument("-o", "--override", default="")
    args = parser.parse_args(argv)

    name = RECIPE_TO_PROBLEM.get(args.upstream)
    if name is None:
        raise SystemExit(f"unknown recipe '{args.upstream}'; known: {sorted(RECIPE_TO_PROBLEM)}")
    problem = Problem.get_class_from_name(name)()
    config = problem.default_config()
    config["target_dir"] = args.expdir
    from .run_downstream import _flatten

    for key, value in _flatten(parse_override_string(args.override)):
        set_dotted(config, key, value)
    target_dir = config.pop("target_dir")
    return problem.run(target_dir, **config)


if __name__ == "__main__":
    main()
