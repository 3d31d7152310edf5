"""Streaming tiled-segmentation serving: the paper's target application
(U-Net medical-image segmentation) as a served workload.

``tiling``   — receptive-field-exact halo decomposition + stitching;
``adaptive`` — content-adaptive per-tile plane budgets on top of the
               certified per-layer :class:`~repro_torch.core.PlaneSchedule`;
``engine``   — request-queue + slot-table micro-batching executor with
               per-image relation-(2) cycle and pJ accounting.
"""
from . import adaptive, engine, synth, tiling  # noqa: F401
from .engine import SegEngine, SegRequest, SegResult, TileEvent  # noqa: F401
from .tiling import halo_for, plan_tiles, stitch, tiled_forward  # noqa: F401
