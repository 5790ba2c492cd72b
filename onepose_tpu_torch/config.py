"""Hydra-style configs for the port's entry points: YAML files under
``configs/``, ``+group=name`` overlays, dotted-key overrides and ``${...}``
interpolation, over nested dicts with attribute access.

The port's own copy of ``Config``, ``load_config`` and ``expand_multirun``
(with the helpers they call) from ``onepose_tpu/config.py``; it reads the
same ``configs/`` tree. ``yaml`` is imported where a file is read.
"""
from __future__ import annotations

import os
import os.path as osp
import re
from typing import Any, Dict, List, Optional, Sequence

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Nested dict with attribute access; missing keys raise AttributeError."""

    def __getattr__(self, name: str):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value):
        self[name] = value

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _wrap(obj):
    if isinstance(obj, dict):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _merge(base: Dict, overlay: Dict) -> Dict:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(cfg: Dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _resolve_value(expr: str, root: Dict):
    expr = expr.strip()
    if expr.startswith("hydra:"):
        if expr == "hydra:runtime.cwd":
            return os.getcwd()
        raise KeyError(f"unsupported resolver: {expr}")
    node: Any = root
    for part in expr.split("."):
        node = node[part]
    return node


def _interpolate(obj, root: Dict, depth: int = 0):
    if depth > 10:
        raise RecursionError("interpolation cycle")
    if isinstance(obj, dict):
        for k in list(obj.keys()):
            obj[k] = _interpolate(obj[k], root, depth)
        return obj
    if isinstance(obj, list):
        return [_interpolate(v, root, depth) for v in obj]
    if isinstance(obj, str):
        m = _INTERP_RE.fullmatch(obj)
        if m:  # whole-string interpolation keeps the value's type
            val = _resolve_value(m.group(1), root)
            return _interpolate(val, root, depth + 1)

        def sub(match):
            val = _resolve_value(match.group(1), root)
            val = _interpolate(val, root, depth + 1)
            return str(val)

        if _INTERP_RE.search(obj):
            return _INTERP_RE.sub(sub, obj)
    return obj


def _load_yaml(path: str) -> Dict:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    data.pop("defaults", None)  # hydra defaults-list: overlays handle this
    return data


def load_config(overrides: Optional[Sequence[str]] = None,
                config_dir: str = "configs",
                config_name: str = "config.yaml") -> Config:
    """Compose a config.

    overrides: e.g. ["+experiment=test_GATsSPG", "object_detect_mode=GT_box",
    "save_wis3d=False"]. ``+group=name`` merges configs/<group>/<name>.yaml;
    ``a.b=value`` sets a dotted key (value YAML-parsed).
    """
    import yaml

    cfg: Dict = {}
    base_path = osp.join(config_dir, config_name)
    if osp.exists(base_path):
        cfg = _merge(cfg, _load_yaml(base_path))

    dotted: List[tuple] = []
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        if key.startswith("+"):
            group = key[1:]
            overlay_path = osp.join(config_dir, group, value + ".yaml")
            cfg = _merge(cfg, _load_yaml(overlay_path))
        else:
            dotted.append((key, yaml.safe_load(value)))
    for key, value in dotted:
        _set_dotted(cfg, key, value)

    cfg = _interpolate(cfg, cfg)
    wrapped = _wrap(cfg)
    if wrapped.get("print_config"):
        print_config(wrapped)
    return wrapped


def _split_sweep(value: str) -> List[str]:
    """Split a sweep value on top-level commas (commas inside [] / {} / ()
    belong to a single YAML value, e.g. ``milestones=[5,10]``)."""
    parts, buf, depth = [], [], 0
    for ch in value:
        if ch in "[{(":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


def expand_multirun(overrides: Sequence[str]) -> List[List[str]]:
    """Hydra basic-sweeper surface (the reference's ``-m`` path feeding the
    optuna return value of its ``train.py``): every
    ``key=a,b,c`` override (non-``+``) with top-level commas becomes a sweep
    axis; returns the cartesian product as a list of override lists."""
    import itertools

    axes: List[List[str]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        values = _split_sweep(value) if not key.startswith("+") else [value]
        axes.append([f"{key}={v}" for v in values])
    return [list(combo) for combo in itertools.product(*axes)]


def print_config(cfg: Dict, indent: int = 0):
    """Print the config tree, one key a line."""
    for k, v in cfg.items():
        if isinstance(v, dict):
            print("  " * indent + f"{k}:")
            print_config(v, indent + 1)
        else:
            print("  " * indent + f"{k}: {v}")
