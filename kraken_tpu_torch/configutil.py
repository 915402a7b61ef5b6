"""Layered YAML config loading.

The port's copy of ``kraken_tpu.configutil`` (``base.yaml`` + an overlay
through an ``extends`` key; one config dict per component; CLI flags
override), reading YAML with the port's own reader
(:mod:`kraken_tpu_torch.utils.yaml_lite`) instead of PyYAML.
"""

from __future__ import annotations

import os
from typing import Any

from kraken_tpu_torch.utils import yaml_lite


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> dict[str, Any]:
    """Load YAML; an ``extends: <relative path>`` key pulls in a base file
    first (recursively), with the extending file's values winning."""
    with open(path) as f:
        doc = yaml_lite.safe_load(f) or {}
    base_rel = doc.pop("extends", None)
    if base_rel:
        base = load_config(os.path.join(os.path.dirname(path), base_rel))
        doc = _deep_merge(base, doc)
    return doc
