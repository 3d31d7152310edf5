"""Calibration: measured activation statistics the search derives budgets from.

Instrumented forwards of the port's U-Net, on the card unless
``device='cpu'``, measure:

  * **per-layer amplitude** — each conv's post-ReLU abs-max
    (``unet.forward``'s ``taps`` hook), per whole canvas and per halo tile
    window;
  * **per-layer tile ratios** — how a tile's amplitude at depth ``l``
    relates to its *input* ratio: the measured gain table, plus per-class
    direct maxima that catch the bias floor of flat windows;
  * **octave histogram → calibrated thresholds** — budget-class boundaries
    come from the amplitude octaves the data actually occupies (empty
    octaves collapse, so the serving engine runs fewer class signatures);
  * **per-layer sensitivity** — measured end-to-end relative error of
    truncating exactly one layer to each budget.  The budgets go in as
    Python ints, so every budget launches the MMA kernel's own plane
    specialization (a 3-plane layer runs the 3-plane kernel, not the
    8-plane one on bit-masked data): the sweep runs the kernel at every
    plane count;
  * **sound per-tile certificate** — :func:`tiled_sound_bound` extends the
    interval machinery of ``unet.forward_with_error_bound`` to a tiled,
    class-refined deployment.

Everything is deterministic given (params, images, knobs); the
``fingerprint`` binds a downstream :class:`~repro_torch.autotune.plan.TunedPlan`
to exactly those inputs.  :func:`params_fingerprint` hashes the same bytes
in the same leaf order as the reference package's, so a plan's weights
binding is checkable from either package.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bitplane import N_BITS
from repro_torch.device import resolve_device
from repro_torch.models import unet
from repro_torch.segserve import tiling
from repro_torch.segserve.adaptive import (
    amplitude_ratio,
    budget_class,
    budget_class_from_thresholds,
)

# Ratios below this floor contribute to per-class direct maxima but not to
# the gain table: gain = ratio_l / ratio_in diverges as ratio_in -> 0, and
# flat windows are governed by their measured bias floor instead.
GAIN_FLOOR = 2.0**-12


def _leaves(tree) -> list:
    """The leaves of a parameter tree in ``jax.tree.leaves`` order: dict
    values by sorted key, list and tuple items in order, ``None`` empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _hash_arrays(h, arrays) -> None:
    for leaf in arrays:
        dtype = None
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                # numpy has no bf16: hash its bytes under the name numpy's
                # bf16 extension type (the reference's leaves) gives it
                dtype, leaf = "bfloat16", leaf.contiguous().view(torch.int16)
            leaf = leaf.numpy()
        a = np.asarray(leaf)
        h.update(str((a.shape, dtype or str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def params_fingerprint(params) -> str:
    """SHA-256 over the exact served weights alone — the half of a plan's
    binding a server can re-derive at admission time (it holds the params
    but not the calibration inputs).  Equal to the reference package's
    digest on the same weights."""
    h = hashlib.sha256()
    _hash_arrays(h, _leaves(params))
    return h.hexdigest()


def fingerprint(params, images, **knobs) -> str:
    """SHA-256 over the exact weights, calibration inputs and knobs a plan
    was derived from — byte-level, so any drift invalidates the plan."""
    h = hashlib.sha256()
    _hash_arrays(h, _leaves(params))
    _hash_arrays(h, images)
    h.update(repr(sorted((k, repr(v)) for k, v in knobs.items())).encode())
    return h.hexdigest()


@dataclass(frozen=True)
class Calibration:
    """Measured statistics of one (params, validation set, geometry) triple.

    ``sensitivity[l][b-1]`` is the measured end-to-end relative error of the
    whole-canvas forward with *only* layer ``l`` truncated to ``b`` planes
    (max over the calibration images; ``sensitivity[l][7] == 0`` by
    construction).  ``class_ratios[c][l]`` is the calibrated per-layer
    amplitude-ratio bound for threshold class ``c`` —
    ``min(1, max(measured direct max, threshold * layer_gain))`` — the
    ratio :meth:`repro_torch.core.PlaneSchedule.refine` consumes per class.
    """

    fingerprint: str
    n_images: int
    tile: int
    max_class: int
    layer_amax: tuple[float, ...]
    layer_gain: tuple[float, ...]
    sensitivity: tuple[tuple[float, ...], ...]
    octave_hist: tuple[int, ...]
    class_thresholds: tuple[float, ...]
    class_ratios: tuple[tuple[float, ...], ...]
    class_counts: tuple[int, ...]

    @property
    def n_layers(self) -> int:
        return len(self.layer_amax)


def _require_quant(cfg: unet.UNetConfig) -> None:
    if cfg.quant_mode != "mma_int8":
        raise ValueError(
            "autotune calibrates the digit-serial datapath; pass a "
            "UNetConfig with quant_mode='mma_int8' (the float path has no "
            "plane budgets to tune)"
        )


def _full8(cfg: unet.UNetConfig) -> unet.UNetConfig:
    return dataclasses.replace(cfg, plane_schedule=None, planes=8)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def rel_err(out, ref) -> float:
    """The one error metric of the subsystem: max |out - ref| over a
    guarded max |ref|, in float32 — shared by calibration, certification
    and the smoke so the certificate and the gate can never drift apart.
    Takes tensors (on one device) or numpy arrays."""
    out, ref = _as_tensor(out), _as_tensor(ref)
    denom = max(float(torch.max(torch.abs(ref))), 1e-8)
    return float(torch.max(torch.abs(out.to(torch.float32) - ref.to(torch.float32)))) / denom


def _canvas(image, cfg: unet.UNetConfig, tile: int, halo: int | None = None):
    image = np.asarray(image, np.float32)
    tplan = tiling.plan_tiles(
        image.shape[0], image.shape[1], depth=cfg.depth,
        convs_per_stage=cfg.convs_per_stage, tile=tile, halo=halo,
    )
    return tplan, tiling.pad_canvas(image, tplan)


def _tap_amax(params, x, cfg: unet.UNetConfig, device) -> np.ndarray:
    """Each conv's post-ReLU abs-max on one input, in schedule order."""
    taps: list = []
    unet.forward(params, x, cfg, taps=taps, device=device)
    return torch.stack([torch.max(torch.abs(t)) for t in taps]).cpu().numpy().astype(np.float64)


def _planes_forward(params, x, full_cfg: unet.UNetConfig, planes, device) -> torch.Tensor:
    """The schedule-sweep forward: per-conv budgets as Python ints, each a
    static plane specialization of the kernel."""
    return unet.forward(params, x, full_cfg, planes_arr=[int(b) for b in planes], device=device)


def calibrate_unet(
    params,
    cfg: unet.UNetConfig,
    images,
    *,
    tile: int | None = None,
    max_class: int = 6,
    budgets: tuple[int, ...] = (7, 6, 5, 4, 3, 2, 1),
    device=None,
) -> Calibration:
    """Instrumented calibration pass over ``images`` (each (H, W, Cin)).

    ``tile`` is the stats tiling (defaults to the geometry's minimum viable
    tile); the measured ratio/gain tables generalize across nearby tile
    sizes and the tile-size search re-prices geometry analytically.
    Forwards run on ``device`` (the CUDA card unless ``'cpu'``).
    """
    _require_quant(cfg)
    if not images:
        raise ValueError("calibration needs at least one image")
    dev = resolve_device(device)
    params = unet.params_to(params, dev)
    full_cfg = _full8(cfg)
    if tile is None:
        tile = cfg.min_viable_tile()
    else:
        cfg.validate_tile(tile)
    n_layers = len(cfg.conv_layers())

    layer_amax = np.zeros(n_layers)
    octave_hist = np.zeros(max_class + 1, np.int64)
    # raw per-tile records: (input ratio, per-layer ratios)
    tile_records: list[tuple[float, np.ndarray]] = []
    sens = np.zeros((n_layers, N_BITS))

    for image in images:
        plan, canvas = _canvas(image, cfg, tile)
        x = canvas[None]
        canvas_taps = _tap_amax(params, x, full_cfg, dev)
        layer_amax = np.maximum(layer_amax, canvas_taps)
        canvas_amax = float(np.max(np.abs(canvas)))

        for spec in plan.tiles:
            win = canvas[spec.y0 : spec.y1, spec.x0 : spec.x1]
            r_in = amplitude_ratio(win, canvas_amax)
            octave_hist[budget_class(r_in, max_class=max_class)] += 1
            win_taps = _tap_amax(params, win[None], full_cfg, dev)
            ratios = win_taps / np.maximum(canvas_taps, 1e-12)
            tile_records.append((r_in, np.minimum(ratios, 1.0)))

        # per-layer sensitivity sweep, every budget its own kernel variant
        ref = _planes_forward(params, x, full_cfg, [N_BITS] * n_layers, dev)
        for l in range(n_layers):
            for b in budgets:
                arr = [N_BITS] * n_layers
                arr[l] = int(b)
                out = _planes_forward(params, x, full_cfg, arr, dev)
                sens[l, b - 1] = max(sens[l, b - 1], rel_err(out, ref))

    # ---- calibrated thresholds: collapse unoccupied amplitude octaves ----
    occupied = sorted({0} | {k for k in range(max_class + 1) if octave_hist[k]})
    thresholds = tuple(2.0**-k if k else 1.0 for k in occupied)

    # ---- measured gain table + per-class direct maxima ------------------
    gains = np.ones(n_layers)
    direct = np.zeros((len(thresholds), n_layers))
    counts = np.zeros(len(thresholds), np.int64)
    for r_in, ratios in tile_records:
        if r_in >= GAIN_FLOOR:
            gains = np.maximum(gains, ratios / r_in)
        c = budget_class_from_thresholds(r_in, thresholds)
        counts[c] += 1
        direct[c] = np.maximum(direct[c], ratios)

    class_ratios = []
    for c, t in enumerate(thresholds):
        rho = np.minimum(1.0, np.maximum(direct[c], t * gains))
        class_ratios.append(tuple(float(v) for v in rho))

    return Calibration(
        fingerprint=fingerprint(
            params, images, cfg=repr(cfg), tile=tile, max_class=max_class,
            budgets=budgets,
        ),
        n_images=len(images),
        tile=tile,
        max_class=max_class,
        layer_amax=tuple(float(v) for v in layer_amax),
        layer_gain=tuple(float(v) for v in gains),
        sensitivity=tuple(tuple(float(v) for v in row) for row in sens),
        octave_hist=tuple(int(v) for v in octave_hist),
        class_thresholds=thresholds,
        class_ratios=tuple(class_ratios),
        class_counts=tuple(int(v) for v in counts),
    )


def make_rel_err_validator(params, cfg: unet.UNetConfig, images, *, device=None):
    """``validate(planes) -> measured rel err`` (whole-canvas, vs the full
    8-plane datapath, max over ``images``) — the search's fast validator.
    The per-image full-8 references depend only on (params, images), so they
    are computed once here and every candidate schedule pays a single
    forward per image, its budgets as Python ints (the kernel's own plane
    specializations)."""
    _require_quant(cfg)
    dev = resolve_device(device)
    params = unet.params_to(params, dev)
    full_cfg = _full8(cfg)
    n_layers = len(cfg.conv_layers())
    xs, refs = [], []
    for image in images:
        _, canvas = _canvas(image, cfg, cfg.min_viable_tile())
        x = torch.as_tensor(canvas[None], device=dev)
        xs.append(x)
        refs.append(_planes_forward(params, x, full_cfg, [N_BITS] * n_layers, dev))

    def validate(planes) -> float:
        arr = np.asarray(planes, np.int32)
        if arr.shape != (n_layers,):
            raise ValueError(f"schedule shape {arr.shape} != ({n_layers},)")
        return max(
            rel_err(_planes_forward(params, x, full_cfg, arr.tolist(), dev), ref)
            for x, ref in zip(xs, refs)
        )

    return validate


def measured_rel_err(params, cfg: unet.UNetConfig, images, planes, *, device=None) -> float:
    """One-shot form of :func:`make_rel_err_validator`."""
    return make_rel_err_validator(params, cfg, images, device=device)(planes)


def tiled_sound_bound(params, cfg: unet.UNetConfig, image, plan, *, device=None) -> float:
    """Worst-case *sound* bound for a tiled, class-refined deployment of
    ``plan`` on ``image``: the interval machinery of
    ``unet.forward_with_error_bound`` run per tile window at the window's
    refined schedule, abs bounds taken against the whole-canvas
    full-precision amplitude.  Unconditionally sound for the per-tile-
    quantized serving path — and honestly loose: op-norm propagation
    compounds worst cases the measured certificate does not."""
    _require_quant(cfg)
    dev = resolve_device(device)
    params = unet.params_to(params, dev)
    tplan, canvas = _canvas(image, cfg, plan.tile, plan.halo)
    canvas_amax = float(np.max(np.abs(canvas)))
    out_full = unet.forward(params, canvas[None], _full8(cfg), device=dev)
    denom = max(float(torch.max(torch.abs(out_full))), 1e-8)
    worst_abs = 0.0
    for spec in tplan.tiles:
        win = canvas[spec.y0 : spec.y1, spec.x0 : spec.x1]
        k = plan.classify(amplitude_ratio(win, canvas_amax))
        ccfg = dataclasses.replace(
            cfg, plane_schedule=tuple(plan.class_schedule(k)), planes=8
        )
        _, out_f, rel = unet.forward_with_error_bound(params, win[None], ccfg, device=dev)
        worst_abs = max(worst_abs, rel * float(torch.max(torch.abs(out_f))))
    return worst_abs / denom
