"""YAML config loading and merging (OmegaConf-free).

The port's own copy of ``generative_detection_tpu/config/merge.py``: base YAML
files are merged left to right, then CLI dotlist overrides (``a.b.c=value``)
are applied on top, last one wins. Dotlist values are parsed as YAML scalars.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Mapping

import yaml


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    return cfg or {}


def deep_merge(base: Any, override: Any) -> Any:
    """Recursively merge ``override`` into ``base`` (dicts merged, rest replaced)."""
    if isinstance(base, Mapping) and isinstance(override, Mapping):
        out = dict(base)
        for k, v in override.items():
            out[k] = deep_merge(out[k], v) if k in out else copy.deepcopy(v)
        return out
    return copy.deepcopy(override)


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_dotlist(config: dict, dotlist: Iterable[str]) -> dict:
    """Apply ``key.path=value`` overrides."""
    out = copy.deepcopy(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Dotlist override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        key = key.lstrip("-")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = _parse_value(raw)
    return out


def merge_configs(base_paths: Iterable[str], dotlist: Iterable[str] = ()) -> dict:
    """Merge base YAMLs left to right, then apply dotlist overrides."""
    config: dict = {}
    for path in base_paths:
        config = deep_merge(config, load_yaml(path))
    return apply_dotlist(config, dotlist)


def to_plain(obj: Any) -> Any:
    """Deep-convert to plain dicts and lists (for YAML snapshots in run dirs)."""
    if isinstance(obj, Mapping):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj
