"""Checkpoints: the array ``Checkpointer`` (atomic step directories,
async save, retention, restore into a tree) and the atomic JSON documents a
:class:`~repro_torch.autotune.plan.TunedPlan` persists through."""
from . import ckpt  # noqa: F401
from .ckpt import Checkpointer, load_json, save_json_atomic  # noqa: F401
