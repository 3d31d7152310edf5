"""Content-adaptive per-tile plane budgets (MINT, per region not per layer).

A medical image is mostly quiet background; the MSDF datapath's cost is
linear in digits consumed.  Dynamic activation quantization gives a flat
tile a scale proportional to its own amplitude, so — at the *same absolute
error budget the per-layer schedule already certified* — a tile at 1/2^k
of the image's amplitude can drop roughly k further LSB digits per layer
(:meth:`repro_torch.core.PlaneSchedule.refine` holds the exact inequality).

Budgets are quantized into integer *classes* ``k = floor(-log2 r)`` (``r``
= tile amplitude / image amplitude, measured on the tile's input window)
rather than refined per tile continuously: the serving engine groups tiles
by class so each micro-batch runs one *static* refined schedule, and the
``kernels.mma_matmul.plane_variant`` specializations stay shared across
tiles, images and requests.  Class ``k`` refines with the ratio upper
bound ``2**-k >= r`` — conservative by construction.

Soundness note: the amplitude ratio is exact at the first conv; deeper
layers see it through ReLU convs, which track amplitude well but carry no
worst-case guarantee.  The certified statement (tested) is the refinement
inequality per layer at the measured ratio; the serving benchmark measures
the realized end-to-end error alongside the modeled cycle savings.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.plane_schedule import PlaneSchedule

from .tiling import TilePlan

# Flat-zero tiles have r = 0 (infinite class); cap so every class still
# streams at least the MSB digit and the class set stays small/jittable.
MAX_CLASS = 6


def amplitude_ratio(tile: np.ndarray, image_amax: float) -> float:
    """max|tile| / max|image|, clamped into [0, 1]."""
    if image_amax <= 0.0:
        return 1.0
    return min(1.0, float(np.max(np.abs(tile))) / float(image_amax))


def budget_class(ratio: float, *, max_class: int = MAX_CLASS) -> int:
    """Amplitude octaves below full scale: largest k <= max_class with
    ratio <= 2**-k (k = 0 for full-amplitude tiles)."""
    if not (0.0 <= ratio <= 1.0):
        raise ValueError(f"ratio {ratio} outside [0, 1]")
    if ratio == 0.0:
        return max_class
    return min(max_class, max(0, int(math.floor(-math.log2(ratio)))))


def budget_class_from_thresholds(
    ratio: float, thresholds: tuple[float, ...]
) -> int:
    """Budget class under *calibrated* thresholds (the autotuner):
    the largest class ``c`` whose threshold still bounds the ratio
    (``ratio <= thresholds[c]``).  ``thresholds`` descend from 1.0, one per
    class — typically the amplitude octaves the calibration set actually
    occupies, so empty octaves cost no jit signatures.  A ratio calibration
    never saw lands in the nearest *louder* class — conservative (it drops
    no more digits than its measured-ratio bound allows)."""
    if not (0.0 <= ratio <= 1.0):
        raise ValueError(f"ratio {ratio} outside [0, 1]")
    if not thresholds or thresholds[0] != 1.0:
        raise ValueError(f"thresholds must start at 1.0, got {thresholds}")
    k = 0
    for c, t in enumerate(thresholds):
        if ratio <= t:
            k = c
        else:
            break
    return k


def class_schedule(base: PlaneSchedule, k: int) -> PlaneSchedule:
    """The static refined schedule micro-batches of class-``k`` tiles run:
    ``base`` refined at the class's conservative ratio bound 2**-k."""
    if k < 0:
        raise ValueError(f"class {k} < 0")
    if k == 0:
        return base
    return base.refine(2.0**-k)


def classify_tiles(
    canvas: np.ndarray,
    plan: TilePlan,
    *,
    max_class: int = MAX_CLASS,
    amax: float | None = None,
    thresholds: tuple[float, ...] | None = None,
) -> list[int]:
    """Budget class per tile of ``plan``, from each tile's *input window*
    (halo included — the window is what the forward actually consumes).
    Pass ``amax`` (the canvas abs-max) if already computed — admission
    also needs it for the amplitude-octave group key.  ``thresholds``
    switches from fixed octaves to a calibrated class table
    (:func:`budget_class_from_thresholds`)."""
    if amax is None:
        amax = float(np.max(np.abs(canvas)))
    out = []
    for t in plan.tiles:
        r = amplitude_ratio(canvas[t.y0 : t.y1, t.x0 : t.x1], amax)
        if thresholds is not None:
            out.append(budget_class_from_thresholds(r, thresholds))
        else:
            out.append(budget_class(r, max_class=max_class))
    return out
