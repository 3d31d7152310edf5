"""Crash-safe JSON documents next to the weights they describe.

Written to ``<path>.tmp`` first and renamed into place last, so a reader
never sees a torn file.
"""
from __future__ import annotations

import json
import os
from pathlib import Path


def save_json_atomic(path: str | os.PathLike, obj) -> Path:
    """Write a JSON document: serialize to ``<path>.tmp``, then rename it
    over ``path``, so a reader never sees a torn file.  Used for small
    sidecar artifacts (``repro_torch.autotune.TunedPlan``) that must be
    restorable next to the weights they describe."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, sort_keys=True) + "\n")
    os.rename(tmp, path)
    return path


def load_json(path: str | os.PathLike):
    """Read a document written by :func:`save_json_atomic`."""
    return json.loads(Path(path).read_text())
