"""YAML config loader with recursive ``inherit_from`` single-file inheritance.

The port's own copy of coslam_tpu/config.py: a config file may name a
parent via the ``inherit_from`` key; parents are loaded first and child
keys deep-merge over them, so the JAX package's scene YAMLs load
unchanged. ``yaml`` is imported when a file is loaded, so the package
imports without it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving the recursive ``inherit_from`` chain.

    Relative ``inherit_from`` paths are resolved against the current
    working directory first and, failing that, against the directory of
    the child config and its parents.
    """
    import yaml

    with open(path, "r") as f:
        child = yaml.full_load(f) or {}

    inherit_from = child.get("inherit_from")

    if inherit_from is not None:
        parent_path = inherit_from
        if not os.path.exists(parent_path):
            candidate = os.path.join(os.path.dirname(os.path.abspath(path)), inherit_from)
            if os.path.exists(candidate):
                parent_path = candidate
            else:
                # Also try resolving relative to the repo-style configs root
                # (e.g. 'configs/Replica/replica.yaml' referenced from anywhere).
                here = os.path.dirname(os.path.abspath(path))
                while here != os.path.dirname(here):
                    candidate = os.path.join(here, inherit_from)
                    if os.path.exists(candidate):
                        parent_path = candidate
                        break
                    here = os.path.dirname(here)
        cfg = load_config(parent_path, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, child)
    return cfg


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge ``dict2`` into ``dict1`` (dict2 entries win)."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
