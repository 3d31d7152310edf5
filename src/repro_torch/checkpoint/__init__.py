"""Checkpoint sidecars.  So far only the atomic JSON documents a
:class:`~repro_torch.autotune.plan.TunedPlan` persists through; the array
checkpoint is not ported yet."""
from . import ckpt  # noqa: F401
from .ckpt import load_json, save_json_atomic  # noqa: F401
