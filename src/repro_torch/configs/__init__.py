"""Architecture configs of the port (so far: Yi-6B and Minitron-4B, the dense
family).

``get_config(name)`` returns the full-size config; ``get_smoke_config(name)``
a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.config()


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.smoke_config()
