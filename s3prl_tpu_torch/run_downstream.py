"""Legacy-style CLI shim (port of s3prl_tpu/run_downstream.py; the
reference's s3prl/run_downstream.py:19-150):

    python -m s3prl_tpu_torch.run_downstream -m train -u hubert -d sid -p exp/sid

maps ``-m mode -u upstream -d downstream`` onto the problem layer, 20
legacy names onto the port's recipes. ``-o`` takes dotted overrides
``a.b=c,,d.e=f`` (utility/helper.py:71-99 syntax); a key of
``build_upstream`` that `SUpstream` does not take is a keyword of
`hub.load` and goes under its ``extra_conf``, so
``-o build_upstream.device=cpu`` runs the upstream on the CPU (the card is
the default). ``-k`` is the upstream checkpoint (`SUpstream`'s
``path_or_url``). ``-m inference -t <wav>`` predicts one file with the
trained probe; ``--push_to_hf_hub`` stages the experiment for the Hugging
Face Hub after training (`train.hub_export`).
"""

from __future__ import annotations

import argparse
import inspect
import logging
from pathlib import Path

from .nn.upstream import SUpstream
from .problem import Problem
from .util.config import parse_override_string, set_dotted

# legacy -d names -> problem classes
DOWNSTREAM_TO_PROBLEM = {
    "asr": "SuperbASR",
    "ctc": "SuperbASR",
    "phone_linear": "SuperbPR",
    "timit_phone": "SuperbPR",
    "pr": "SuperbPR",
    "speech_commands": "SuperbKS",
    "ks": "SuperbKS",
    "fluent_commands": "SuperbIC",
    "ic": "SuperbIC",
    "voxceleb1": "SuperbSID",
    "sid": "SuperbSID",
    "sv_voxceleb1": "SuperbASV",
    "asv": "SuperbASV",
    "emotion": "SuperbER",
    "er": "SuperbER",
    "diarization": "SuperbSD",
    "sd": "SuperbSD",
    "snips": "SuperbSF",
    "sf": "SuperbSF",
    "example": "CommonExample",
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--mode", choices=["train", "evaluate", "inference"],
                        default="train")
    parser.add_argument("-u", "--upstream", default="fbank")
    parser.add_argument("-d", "--downstream", required=True)
    parser.add_argument("-p", "--expdir", required=True, help="target dir")
    parser.add_argument("-k", "--upstream_ckpt", default=None)
    parser.add_argument("-s", "--upstream_feature_selection", default=None)
    parser.add_argument("-o", "--override", default="", help="a.b=c,,d.e=f overrides")
    parser.add_argument(
        "-t", "--evaluate_split", default="test",
        help="in inference mode: the path of one audio file (the reference's "
        "runner.py:506-524 reuses this flag for the input file)")
    # the reference's semantics: resume is opt-in through -a
    # (run_downstream.py:93-107); without it a stale expdir trains anew
    parser.add_argument("-a", "--auto_resume", action="store_true", default=False)
    # run_downstream.py:77-78: publish the trained experiment to the Hugging
    # Face Hub (train/hub_export.py: staged always, uploaded with a token)
    parser.add_argument("--push_to_hf_hub", action="store_true", default=False)
    parser.add_argument("--hf_hub_org", default=None)
    return parser.parse_args(argv)


_SUPSTREAM_KEYS = set(inspect.signature(SUpstream).parameters)


def _upstream_keywords(config: dict) -> None:
    """Moves the keys of ``build_upstream`` that `SUpstream` does not take
    (`hub.load`'s keywords: ``device``, ``dtype``, ``flash``, ...) under its
    ``extra_conf``."""
    up = config.setdefault("build_upstream", {})
    extra = up.setdefault("extra_conf", {})
    for key in [k for k in up if k not in _SUPSTREAM_KEYS]:
        extra[key] = up.pop(key)
    if not extra:
        del up["extra_conf"]


def _flatten(d, prefix=""):
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    name = DOWNSTREAM_TO_PROBLEM.get(args.downstream)
    if name is None:
        raise SystemExit(
            f"unknown downstream '{args.downstream}'; known: {sorted(DOWNSTREAM_TO_PROBLEM)}")
    problem = Problem.get_class_from_name(name)()
    config = problem.default_config()
    config["target_dir"] = args.expdir
    set_dotted(config, "build_upstream.name", args.upstream)
    if args.upstream_ckpt:
        set_dotted(config, "build_upstream.path_or_url", args.upstream_ckpt)
    for key, value in _flatten(parse_override_string(args.override)):
        set_dotted(config, key, value)
    _upstream_keywords(config)
    config.setdefault("train", {})["auto_resume"] = bool(args.auto_resume)
    target_dir = config.pop("target_dir")
    if args.mode == "train":
        result = problem.run(target_dir, **config)
        if args.push_to_hf_hub:
            from .train.hub_export import push_to_hub

            push_to_hub(target_dir, upstream=args.upstream, problem=name,
                        organization=args.hf_hub_org)
        return result
    if args.mode == "inference":
        return problem.inference(Path(target_dir), config, args.evaluate_split)
    # evaluate: the last stage only
    return problem.run(target_dir, start=len(problem.STAGES) - 1, **config)


if __name__ == "__main__":
    main()
