"""Budget/geometry search: cycles minimized subject to a measured error budget.

The objective is hardware-meaningful by construction — relation (2) of the
paper, recomputed per layer under a candidate schedule
(``cycle_model.schedule_cycles``) and per tile window under a candidate
tile size (``cycle_model.unet_window_cycles`` × the halo overhead the
window geometry implies).  The constraint is the *measured* end-to-end
error on the calibration set: the greedy descent steers by the calibrated
first-order sensitivity table (drop the plane with the best
cycles-per-error ratio), then a validation loop re-adds planes — most
error-expensive first — until the measured error fits inside
``slack * target``.  The terminal state (all layers at 8 planes) has zero
truncation error, so the repair always terminates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import cycle_model as cm
from repro_torch.core.bitplane import N_BITS
from repro_torch.segserve import tiling
from repro_torch.segserve.adaptive import amplitude_ratio

from .calibrate import Calibration

# Predicted error must undershoot the target so the certificate's margin
# still fits under it: cert = measured * margin <= slack * margin * target,
# and slack * margin <= 1 is asserted by the API layer.
DEFAULT_SLACK = 0.6


def predicted_err(calib: Calibration, planes) -> float:
    """First-order composition of the measured single-layer sensitivities."""
    return float(
        sum(calib.sensitivity[l][int(b) - 1] for l, b in enumerate(planes))
    )


def greedy_schedule(
    calib: Calibration,
    layers: list[cm.ConvLayerSpec],
    target_rel_err: float,
    *,
    slack: float = DEFAULT_SLACK,
    mode: str = "pipelined",
    validate=None,
) -> tuple[int, ...]:
    """Fewest-cycle per-layer budgets whose error fits the budget.

    Greedy steepest descent on measured sensitivities: repeatedly drop the
    single plane with the best (cycles saved / predicted error added) ratio
    while the first-order error prediction stays within ``slack * target``.
    If a ``validate(planes) -> measured`` callback is given (the traced
    whole-canvas forward), a repair loop then re-adds planes — largest
    sensitivity contribution first — until the *measured* error also fits:
    sensitivities compose only to first order, and the measurement, not the
    prediction, is what the certificate will be built from.
    """
    if not (0.0 < slack <= 1.0):
        raise ValueError(f"slack {slack} outside (0, 1]")
    n_layers = len(layers)
    if calib.n_layers != n_layers:
        raise ValueError(
            f"calibration covers {calib.n_layers} layers, geometry has "
            f"{n_layers}"
        )
    budget = slack * target_rel_err

    def layer_cycles(l: int, b: int) -> int:
        return layers[l].cycles(
            tile_cycles=cm.schedule_tile_cycles(b, mode=mode)
        )

    planes = [N_BITS] * n_layers
    pred = 0.0
    while True:
        best = None
        for l in range(n_layers):
            b = planes[l]
            if b <= 1:
                continue
            d_err = (
                calib.sensitivity[l][b - 2] - calib.sensitivity[l][b - 1]
            )
            if pred + max(d_err, 0.0) > budget:
                continue
            d_cyc = layer_cycles(l, b) - layer_cycles(l, b - 1)
            score = d_cyc / max(d_err, 1e-12)
            if best is None or score > best[0]:
                best = (score, l, d_err)
        if best is None:
            break
        _, l, d_err = best
        planes[l] -= 1
        pred += max(d_err, 0.0)

    if validate is not None:
        while validate(tuple(planes)) > budget:
            # re-add the plane whose sensitivity contribution is largest
            worst = max(
                (l for l in range(n_layers) if planes[l] < N_BITS),
                key=lambda l: calib.sensitivity[l][planes[l] - 1],
                default=None,
            )
            if worst is None:
                break  # all layers back at 8 planes: zero truncation error
            planes[worst] += 1
    return tuple(planes)


def repair_sequence(planes, sensitivity, cap: int) -> list[int]:
    """The deterministic order repair re-adds planes in: repeatedly the
    fixable layer whose measured sensitivity contribution is largest (the
    dominant error source), exactly the rule the one-at-a-time loop used.
    Returns the layer index per step; applying a prefix of length ``t``
    gives the plane vector after ``t`` repairs."""
    p = list(planes)
    seq: list[int] = []
    while len(seq) < cap:
        worst = max(
            (l for l in range(len(p)) if p[l] < N_BITS),
            key=lambda l: sensitivity[l][p[l] - 1],
            default=None,
        )
        if worst is None:
            break
        p[worst] += 1
        seq.append(worst)
    return seq


def bisect_repair(measure, seq_len: int, budget: float):
    """Fewest repair steps whose measured error fits ``budget``, amortized.

    ``measure(t) -> float`` serves the calibration set at the plane vector
    after ``t`` repair steps — the expensive call (a full engine replay per
    invocation).  The one-at-a-time loop paid ``t* + 1`` measurements for a
    repair depth of ``t*``; this gallops (probe 1, 2, 4, ... until the
    error fits) and then bisects the bracketed interval, so deep repairs
    cost ``O(log t*)`` measurements while shallow ones (``t* <= 2``, the
    common case) pay exactly what the linear scan did.  Assumes error is
    non-increasing in repair depth — the same assumption the linear loop
    made; a non-monotone landscape still terminates at a *valid* certified
    point (the certificate is built from the measurement at the served
    vector), it just may not be the minimal one.

    Returns ``(t, measured_at_t, n_measure_calls)``.  When even the full
    sequence fails the budget the full depth is returned (the caller's cap
    semantics: serve the best achievable point, certificate records the
    miss).
    """
    calls = 0

    def m(t: int) -> float:
        nonlocal calls
        calls += 1
        return measure(t)

    got = m(0)
    if got <= budget or seq_len == 0:
        return 0, got, calls
    lo = 0  # known to fail
    t = 1
    while True:
        t = min(t, seq_len)
        got = m(t)
        if got <= budget:
            hi, m_hi = t, got
            break
        lo = t
        if t == seq_len:
            return seq_len, got, calls
        t *= 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        got = m(mid)
        if got <= budget:
            hi, m_hi = mid, got
        else:
            lo = mid
    return hi, m_hi, calls


def tile_candidates(cfg, images, *, limit: int = 8) -> tuple[int, ...]:
    """Viable core strides for ``images`` under ``cfg``'s geometry: multiples
    of ``2**depth`` from the minimum viable tile (the halo-walk guard) up to
    the largest canvas edge, thinned to at most ``limit`` candidates."""
    mult = 2**cfg.depth
    lo = cfg.min_viable_tile()
    hi = 0
    for im in images:
        h, w = im.shape[0], im.shape[1]
        hi = max(hi, -(-h // mult) * mult, -(-w // mult) * mult)
    hi = max(hi, lo)
    cands = list(range(lo, hi + 1, mult))
    if len(cands) > limit:
        step = (len(cands) - 1) / (limit - 1)
        cands = sorted({cands[round(i * step)] for i in range(limit)})
    return tuple(cands)


def plan_cycles(
    cfg, image, tile: int, classify, class_schedule, *,
    halo: int | None = None, mode: str = "pipelined",
) -> int:
    """Modeled relation-(2) cycles of serving one image at core stride
    ``tile`` under a class table: every tile window priced at its class's
    refined schedule (budget classes from the *input* canvas, exactly as
    admission will assign them).  ``classify(ratio) -> k`` and
    ``class_schedule(k) -> planes`` are the plan's calibrated tables."""
    image = np.asarray(image, np.float32)
    tplan = tiling.plan_tiles(
        image.shape[0], image.shape[1], depth=cfg.depth,
        convs_per_stage=cfg.convs_per_stage, tile=tile, halo=halo,
    )
    canvas = tiling.pad_canvas(image, tplan)
    amax = float(np.max(np.abs(canvas)))
    total = 0
    for spec in tplan.tiles:
        r = amplitude_ratio(canvas[spec.y0 : spec.y1, spec.x0 : spec.x1], amax)
        total += cm.unet_window_cycles(
            (spec.in_h, spec.in_w), cfg.in_ch, cfg.base, cfg.depth,
            cfg.convs_per_stage, class_schedule(classify(r)), mode=mode,
        )
    return total


def search_tile(
    cfg,
    images,
    classify,
    class_schedule,
    *,
    candidates: tuple[int, ...] | None = None,
    mode: str = "pipelined",
) -> tuple[int, int]:
    """Pick the core stride minimizing total modeled cycles over the
    calibration images (halo overhead vs adaptivity is the trade: big tiles
    amortize the halo, small tiles isolate quiet background into cheap
    budget classes).  Returns ``(tile, modeled_cycles)``."""
    if candidates is None:
        candidates = tile_candidates(cfg, images)
    if not candidates:
        raise ValueError("no viable tile candidates")
    best: tuple[int, int] | None = None
    for tile in candidates:
        cfg.validate_tile(tile)
        total = 0
        for image in images:
            total += plan_cycles(
                cfg, image, tile, classify, class_schedule, mode=mode
            )
        if best is None or total < best[1] or (
            total == best[1] and tile < best[0]
        ):
            best = (tile, total)
    return best
