"""Config system: nested-dict merge + dotted CLI overrides (a copy of s3prl_tpu/util/config.py).

Re-creates the behavior of the reference's config layer without omegaconf:
- the reference merges {recipe default_config() ⊕ --config yaml ⊕ --a.b.c value
  CLI overrides} and enforces ``???`` missing values
  (reference: s3prl/problem/base.py:954-995, s3prl/util/override.py:53).
- "config keys = builder-method kwargs" contract is preserved by the problem
  layer on top of this module.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, List

import yaml

MISSING = "???"


def load_yaml(path) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: dict, *overrides: dict) -> dict:
    """Recursively merge dicts; later arguments win. Returns a new dict."""
    out = copy.deepcopy(base)
    for ov in overrides:
        _merge_into(out, ov)
    return out


def _merge_into(dst: dict, src: dict) -> None:
    for k, v in (src or {}).items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _parse_value(text: str) -> Any:
    """Parse a CLI value string into a python object (safe literal eval)."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
        if lowered in ("null", "none"):
            return None
        return text


def set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def parse_overrides(argv: List[str]) -> dict:
    """Parse ``--a.b.c value`` style overrides into a nested dict.

    Mirrors the reference's parse_overrides (s3prl/util/override.py:53):
    arguments come in (--dotted.key, value) pairs.
    """
    if len(argv) % 2 != 0:
        raise ValueError(f"overrides must come in (--key, value) pairs: {argv}")
    out: dict = {}
    for i in range(0, len(argv), 2):
        key = argv[i]
        if not key.startswith("--"):
            raise ValueError(f"override key must start with '--': {key}")
        set_dotted(out, key[2:], _parse_value(str(argv[i + 1])))
    return out


def parse_override_string(string: str) -> dict:
    """Parse the legacy override string ``a.b.c=v,,d.e=w`` (the reference's
    ``-o`` flag, s3prl/utility/helper.py:71-99), each value a safe literal."""
    out: dict = {}
    if not string:
        return out
    for item in string.split(",,"):
        item = item.strip()
        if not item:
            continue
        key, _, value = item.partition("=")
        set_dotted(out, key.strip(), _parse_value(value.strip()))
    return out


def check_no_missing(cfg: dict, prefix: str = "") -> None:
    """Raise if any value is the MISSING sentinel '???'."""
    for k, v in cfg.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            check_no_missing(v, path)
        elif isinstance(v, str) and v == MISSING:
            raise ValueError(f"config field '{path}' is required but missing (???)")


def field_doc(cfg: dict, indent: int = 0) -> str:
    """Render a config as indented yaml-ish text (for --print_config)."""
    return yaml.safe_dump(cfg, sort_keys=False, default_flow_style=False)
