"""YAML config loading (port of `tokensgen_tpu/utils/config.py`): a yaml file
becomes an attribute-accessible nested dict, with per-item
`input_config.public` defaults merged into each item's `params`."""

from __future__ import annotations

import datetime
import json
import os
import shutil
from typing import Any, Dict, List, Optional


class Config(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, key: str):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value):
        self[key] = value

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


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a yaml config; ``overrides`` maps dotted keys to values."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = _wrap(raw)
    for key, val in (overrides or {}).items():
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, Config())
        node[parts[-1]] = val
    return cfg


def merge(base: Dict, override: Dict) -> Config:
    out = Config({k: _wrap(v) for k, v in base.items()})
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(v)
    return out


def input_items(cfg: Config) -> List[Config]:
    """Expand `input_config`: `public` defaults merged with each item's
    `params`; an `input_json` file's items extend or override them."""
    ic = cfg.get("input_config", Config())
    public = ic.get("public", Config())
    items_json = ic.get("input_json")
    if items_json:
        with open(items_json) as f:
            ext = json.load(f)
        ic = merge(ic, ext.get("input_config") or {})
    items = []
    for name, item in ic.items():
        if name in ("public", "input_json") or not isinstance(item, dict):
            continue
        merged = merge(public, item.get("params", Config()))
        merged["name"] = name
        for k, v in item.items():
            if k != "params":
                merged[k] = v
        items.append(merged)
    return items


def create_output_folders(output_dir: str, name_prefix: str,
                          config_path: Optional[str] = None) -> str:
    """Timestamped run dir with the config archived into it."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    run_dir = os.path.join(output_dir, f"{name_prefix}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    if config_path:
        shutil.copy(config_path, os.path.join(run_dir, "config.yaml"))
    return run_dir
