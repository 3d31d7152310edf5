"""Autotune front door: (model, validation batch, error budget, geometry)
-> a serialized, certified :class:`~repro_torch.autotune.plan.TunedPlan`.

``tune_unet`` runs the full pipeline for tiled segmentation, on the card
unless ``device='cpu'``:

  1. **calibrate** — instrumented forwards record per-layer amplitudes,
     per-tile ratio gains, the occupied amplitude octaves and the measured
     single-layer truncation sensitivities (``calibrate.calibrate_unet``);
  2. **search** — greedy cycles-per-error descent over per-layer plane
     budgets, validated against the measured whole-canvas error; budget
     classes from the calibrated thresholds; core stride picked by
     minimizing modeled relation-(2) cycles over the calibration images
     (``search``);
  3. **certify** — the exact serving path (``SegEngine`` with the plan,
     per-tile quantization) is replayed on the calibration images against
     its full-8 twin; planes are re-added until the measured end-to-end
     error fits ``slack * target``, and the certificate is that measurement
     inflated by ``margin`` (so ``measured <= cert <= target``).  The
     unconditionally sound interval bound (``calibrate.tiled_sound_bound``)
     is recorded alongside.

Every forward of the pipeline runs the port's U-Net, so on the card every
conv goes through the hand-written MMA kernel at the plane count the
candidate schedule gives it.

``tune_lm`` is the LM analogue: seed from the analytic
``serve.engine.lm_schedule_from_params`` policy, then measure-and-repair
against the quantized forward on a calibration token batch (the Horner
route, as the reference builds its own ``QuantConfig``).  ``tune_spec``
extends an LM plan with the speculative operating point (schema v3
``spec_planes``/``spec_k``), running the real ``SpecEngine`` on the
caller's impl: with ``impl='kernel'`` every draft and verify linear is the
scaled MMA kernel.  :func:`apply_plan_lm` installs an LM plan into an
``ArchConfig`` (the gateway's ``LMAdapter(plan=...)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cycle_model as cm
from repro_torch.core import quant
from repro_torch.core.bitplane import N_BITS
from repro_torch.core.plane_schedule import PlaneSchedule, layer_rel_bound
from repro_torch.device import resolve_device
from repro_torch.models import unet
from repro_torch.segserve.adaptive import budget_class_from_thresholds
from repro_torch.segserve.engine import SegEngine
from repro_torch.segserve.tiling import halo_for

from . import calibrate as _calibrate
from . import search as _search
from .plan import TunedPlan

DEFAULT_MARGIN = 1.25


def _check_budget_split(slack: float, margin: float) -> None:
    if margin < 1.0:
        raise ValueError(f"margin {margin} < 1 cannot cover its measurement")
    if slack * margin > 1.0 + 1e-9:
        raise ValueError(
            f"slack*margin = {slack * margin:.3f} > 1: the certificate "
            f"(measured*margin) could exceed the target the search met"
        )


def _quantized_weights(params):
    return [
        quant.quantize_weights(w, channel_axis=-1).values.reshape(-1, w.shape[-1])
        for w in unet.conv_weights_in_order(params)
    ]


def _layer_bounds(params, planes) -> tuple[float, ...]:
    return tuple(
        float(layer_rel_bound(w, int(b)))
        for w, b in zip(_quantized_weights(params), planes)
    )


def apply_plan(cfg: unet.UNetConfig, plan: TunedPlan) -> unet.UNetConfig:
    """Install a plan's certified layer schedule into a ``UNetConfig``."""
    if plan.workload != "unet":
        raise ValueError(f"cannot apply a {plan.workload!r} plan to a U-Net")
    return dataclasses.replace(cfg, plane_schedule=tuple(plan.planes))


def apply_plan_lm(cfg, plan: TunedPlan):
    """Install an LM plan into an ``ArchConfig``: the int8 MMA datapath at
    the plan's per-layer budgets (``quant.plane_schedule``), the impl as
    ``cfg`` gives it."""
    if plan.workload != "lm":
        raise ValueError(f"cannot apply a {plan.workload!r} plan to an LM")
    return cfg.replace(
        quant=dataclasses.replace(cfg.quant, mode="mma_int8",
                                  plane_schedule=tuple(plan.planes))
    )


def reference_plan(plan: TunedPlan) -> TunedPlan:
    """The plan's full-8 twin: identical tiling, thresholds and grouping,
    every budget at 8 planes — the reference a measured certificate is
    defined against."""
    n = len(plan.planes)
    return dataclasses.replace(
        plan,
        planes=(N_BITS,) * n,
        layer_bounds=None,
        class_planes=(
            None
            if plan.class_planes is None
            else ((N_BITS,) * n,) * len(plan.class_planes)
        ),
        certificate=dict(plan.certificate, reference=True),
        modeled={},
    )


def engine_from_plan(cfg: unet.UNetConfig, params, plan: TunedPlan, *, device=None, **kw):
    """A :class:`~repro_torch.segserve.engine.SegEngine` serving ``plan``'s
    tuned operating point (tile, halo, calibrated classes, per-tile quant)
    on ``device`` (the CUDA card unless ``'cpu'``)."""
    return SegEngine(apply_plan(cfg, plan), params, plan=plan, device=device, **kw)


def _engine_logits(params, cfg, images, plan, *, batch: int, device) -> list:
    """Stitched logits of every image served through ``plan``'s engine."""
    eng = engine_from_plan(cfg, params, plan, batch=batch, device=device)
    return [
        eng.run([np.asarray(image, np.float32)])[0].logits
        for image in images
    ]


def _engine_measured(params, cfg, images, plan, *, batch: int, device,
                     ref_logits=None) -> float:
    """Measured end-to-end rel-err of the exact serving path on the
    calibration images, against the plan's full-8 twin.  ``ref_logits``
    reuses precomputed reference outputs — the certify loop's reference
    (tile, thresholds, all-8 planes) is invariant across repairs."""
    if ref_logits is None:
        ref_logits = _engine_logits(
            params, cfg, images, reference_plan(plan), batch=batch, device=device
        )
    got = _engine_logits(params, cfg, images, plan, batch=batch, device=device)
    return max(
        _calibrate.rel_err(g, w) for g, w in zip(got, ref_logits)
    )


def tune_unet(
    params,
    cfg: unet.UNetConfig,
    images,
    *,
    target_rel_err: float,
    tile: int | None = None,
    tile_candidates: tuple[int, ...] | None = None,
    max_class: int = 6,
    slack: float = _search.DEFAULT_SLACK,
    margin: float = DEFAULT_MARGIN,
    mode: str = "pipelined",
    batch: int = 4,
    sound_bound: bool = True,
    max_repair: int | None = None,
    calibration: _calibrate.Calibration | None = None,
    device=None,
) -> TunedPlan:
    """Calibrate, search and certify a tuned plan for tiled U-Net serving.

    ``images`` is the calibration/validation set ((H, W, Cin) arrays) the
    certificate is conditioned on — serve the distribution you calibrated.
    ``tile`` pins the core stride (validated); otherwise the tile-size
    search picks it.  ``slack * margin <= 1`` is enforced so the final
    certificate (measured error x ``margin``) provably fits the target.
    ``calibration`` reuses a precomputed (target-independent)
    :func:`~repro_torch.autotune.calibrate.calibrate_unet` record.  Every
    forward runs on ``device`` (the CUDA card unless ``'cpu'``).
    """
    _check_budget_split(slack, margin)
    dev = resolve_device(device)
    params = unet.params_to(params, dev)
    images = [np.asarray(im, np.float32) for im in images]
    if tile is not None:
        cfg.validate_tile(tile)

    calib = calibration if calibration is not None else (
        _calibrate.calibrate_unet(params, cfg, images, max_class=max_class, device=dev)
    )
    layers = cfg.conv_layers()
    n_layers = len(layers)

    planes = list(
        _search.greedy_schedule(
            calib, layers, target_rel_err, slack=slack, mode=mode,
            validate=_calibrate.make_rel_err_validator(params, cfg, images, device=dev),
        )
    )

    def class_tables(base_planes):
        base = PlaneSchedule(
            planes=tuple(base_planes), target_rel_err=target_rel_err
        )
        return tuple(
            base.refine(calib.class_ratios[c]).planes
            for c in range(len(calib.class_thresholds))
        )

    class_planes = class_tables(planes)
    if tile is None:
        tile, _ = _search.search_tile(
            cfg, images,
            lambda r: budget_class_from_thresholds(r, calib.class_thresholds),
            lambda k: class_planes[k],
            candidates=tile_candidates, mode=mode,
        )
    halo = halo_for(cfg.depth, cfg.convs_per_stage)

    geometry = dict(
        hw=cfg.hw, in_ch=cfg.in_ch, base=cfg.base, depth=cfg.depth,
        convs_per_stage=cfg.convs_per_stage, n_classes=cfg.n_classes,
        impl=cfg.impl, pad_mode=cfg.pad_mode,
    )

    def build(planes_now, class_planes_now, certificate) -> TunedPlan:
        return TunedPlan(
            workload="unet",
            geometry=geometry,
            planes=tuple(planes_now),
            target_rel_err=float(target_rel_err),
            certificate=certificate,
            fingerprint=_calibrate.fingerprint(
                params, images, calibration=calib.fingerprint,
                target_rel_err=target_rel_err, tile=tile, slack=slack,
                margin=margin, mode=mode, batch=batch,
            ),
            params_fingerprint=_calibrate.params_fingerprint(params),
            layer_bounds=_layer_bounds(params, planes_now),
            tile=int(tile),
            halo=int(halo),
            class_thresholds=calib.class_thresholds,
            class_planes=class_planes_now,
            layer_gain=calib.layer_gain,
        )

    # ---- certify through the exact serving path -------------------------
    # The full-8 reference depends only on (tile, thresholds, geometry) —
    # invariant across repairs — so it is served exactly once.  The re-add
    # order is deterministic given the sensitivity table
    # (``search.repair_sequence``), so the loop reduces to finding the
    # fewest repair steps whose *measured* error fits, which
    # ``search.bisect_repair`` gallops/bisects in O(log) engine replays.
    budget = slack * target_rel_err
    cap = max_repair if max_repair is not None else N_BITS * n_layers
    ref_logits = _engine_logits(
        params, cfg, images,
        reference_plan(build(planes, class_planes, {})), batch=batch, device=dev,
    )
    seq = _search.repair_sequence(planes, calib.sensitivity, cap)

    def planes_after(t: int) -> list[int]:
        p = list(planes)
        for l in seq[:t]:
            p[l] += 1
        return p

    def measure(t: int) -> float:
        p = planes_after(t)
        return _engine_measured(
            params, cfg, images, build(p, class_tables(p), {}), batch=batch,
            device=dev, ref_logits=ref_logits,
        )

    repairs, measured, measure_calls = _search.bisect_repair(
        measure, len(seq), budget
    )
    planes = planes_after(repairs)
    class_planes = class_tables(planes)

    cert = float(measured * margin)
    certificate = dict(
        target_rel_err=float(target_rel_err),
        measured_rel_err=float(measured),
        cert=cert,
        margin=float(margin),
        slack=float(slack),
        n_images=len(images),
        repairs=repairs,
        measure_calls=measure_calls,
        holds=bool(cert <= target_rel_err),
    )
    plan = build(planes, class_planes, certificate)
    if sound_bound:
        sb = max(
            _calibrate.tiled_sound_bound(params, cfg, im, plan, device=dev)
            for im in images
        )
        certificate["sound_bound"] = float(sb)
        plan = build(planes, class_planes, certificate)

    # advisory relation-(2) account
    modeled_cycles = sum(
        _search.plan_cycles(
            cfg, im, plan.tile, plan.classify, plan.class_schedule,
            halo=plan.halo, mode=mode,
        )
        for im in images
    )
    full8_cycles = sum(
        _search.plan_cycles(
            cfg, im, plan.tile, lambda r: 0, lambda k: (N_BITS,) * n_layers,
            halo=plan.halo, mode=mode,
        )
        for im in images
    )
    return dataclasses.replace(
        plan,
        modeled=dict(
            cycles_calib=int(modeled_cycles),
            full8_cycles_calib=int(full8_cycles),
            mode=mode,
        ),
    )


# --------------------------------------------------------------------- LM


def tune_lm(
    params,
    cfg,
    tokens,
    *,
    target_rel_err: float,
    slack: float = _search.DEFAULT_SLACK,
    margin: float = DEFAULT_MARGIN,
    max_repair: int | None = None,
    device=None,
) -> TunedPlan:
    """Measured-and-certified per-layer budgets for a block-stacked LM.

    Seeds from the analytic weight-only policy
    (:func:`repro_torch.serve.engine.lm_schedule_from_params`), measures the
    end-to-end logits error on ``tokens`` against the full 8-plane
    datapath, and re-adds planes until the measurement fits ``slack *
    target``; the certificate is the final measurement inflated by
    ``margin``.  Every forward runs on ``device`` (the CUDA card unless
    ``'cpu'``) on the Horner route.  Install with :func:`apply_plan_lm`.
    """
    from repro_torch import models
    from repro_torch.configs.base import QuantConfig
    from repro_torch.serve.engine import lm_schedule_from_params

    _check_budget_split(slack, margin)
    dev = resolve_device(device)
    mod = models.build(cfg)
    params = mod.params_to(params, dev)
    toks = np.asarray(tokens, np.int32)

    def logits(qcfg) -> torch.Tensor:
        return mod.forward(params, toks, cfg.replace(quant=qcfg), device=dev).to(torch.float32)

    ref = logits(QuantConfig(mode="mma_int8", planes=8))
    denom = max(float(ref.abs().max()), 1e-8)

    def measured(planes) -> float:
        out = logits(QuantConfig(mode="mma_int8", planes=8, plane_schedule=tuple(planes)))
        return float((out - ref).abs().max()) / denom

    seed = lm_schedule_from_params(params, cfg, target_rel_err)
    planes = list(seed.planes)
    budget = slack * target_rel_err
    cap = max_repair if max_repair is not None else N_BITS * len(planes)
    repairs = 0
    m = measured(planes)
    while m > budget and repairs < cap:
        # repair the layer with the fewest planes (ties: largest analytic
        # bound) — the fewest-digit layer is the dominant error source
        fixable = [l for l in range(len(planes)) if planes[l] < N_BITS]
        if not fixable:
            break
        bounds = seed.layer_bounds or (0.0,) * len(planes)
        worst = min(fixable, key=lambda l: (planes[l], -bounds[l]))
        planes[worst] += 1
        repairs += 1
        m = measured(planes)

    cert = float(m * margin)
    fp, params_fp = _calibrate.fingerprints(
        params, [toks], target_rel_err=target_rel_err, slack=slack,
        margin=margin, family=cfg.family,
    )
    return TunedPlan(
        workload="lm",
        geometry=dict(
            family=cfg.family, n_layers=cfg.n_layers,
            d_model=getattr(cfg, "d_model", None),
        ),
        planes=tuple(planes),
        target_rel_err=float(target_rel_err),
        certificate=dict(
            target_rel_err=float(target_rel_err),
            measured_rel_err=float(m),
            cert=cert,
            margin=float(margin),
            slack=float(slack),
            n_tokens=int(toks.size),
            repairs=repairs,
            holds=bool(cert <= target_rel_err),
        ),
        fingerprint=fp,
        params_fingerprint=params_fp,
        layer_bounds=seed.layer_bounds,
    )


def tune_spec(
    params,
    cfg,
    prompts,
    *,
    plan: TunedPlan,
    batch: int = 2,
    max_seq: int = 64,
    max_new: int = 16,
    k_candidates: tuple[int, ...] = (2, 3, 4),
    plane_candidates: tuple[int, ...] = (2, 4, 6),
    mode: str = "pipelined",
    device=None,
) -> TunedPlan:
    """Search the speculative operating point (draft plane budget, depth
    ``k``) that maximizes *accepted tokens per modeled cycle*, and record
    it on an existing certified LM plan (schema v3: ``spec_planes`` /
    ``spec_k``).

    Each candidate runs the real
    :class:`~repro_torch.serve.specdecode.SpecEngine` on the calibration
    ``prompts`` on ``device`` (the CUDA card unless ``'cpu'``), with the
    impl ``cfg`` gives; every round is priced with
    :func:`repro_torch.core.cycle_model.lm_spec_step_cycles` (relation (2),
    wasted speculation included).  The verify schedule is the plan's
    certified ``planes``; the certificate is untouched.
    """
    from repro_torch.serve.engine import Request
    from repro_torch.serve.specdecode import SpecEngine

    if plan.workload != "lm":
        raise ValueError("tune_spec extends an LM plan")
    dev = resolve_device(device)
    qcfg = apply_plan_lm(cfg, plan)
    full_sched = tuple(plan.planes)
    kw = dict(
        n_heads=cfg.n_heads, head_dim=cfg.hd, n_kv_heads=cfg.n_kv_heads,
        context=max_seq, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
    )
    full_step = cm.lm_step_cycles(
        cfg.d_model, cfg.d_ff, cfg.n_layers, full_sched, mode=mode, **kw
    )
    prompts = [np.asarray(p, np.int32) for p in prompts]

    def run(draft_sched, k):
        eng = SpecEngine(
            qcfg, params, batch=batch, max_seq=max_seq,
            draft_schedule=draft_sched, k=k, device=dev,
        )
        pending = [
            Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)
        ]
        cycles = emitted = accepted = drafted = 0
        while pending or eng.ready_slots():
            while pending and eng.admit(pending[0]):
                pending.pop(0)
            slots = eng.ready_slots()
            if not slots:
                break
            _, rec = eng.spec_step()
            if rec is None:  # no speculation headroom: plain greedy round
                cycles += full_step * len(slots)
                emitted += len(slots)
                continue
            sc = cm.lm_spec_step_cycles(
                cfg.d_model, cfg.d_ff, cfg.n_layers,
                k=rec["k"], draft_schedule=draft_sched,
                schedule=full_sched, mode=mode, **kw,
            )
            cycles += sc["total_cycles"] * len(rec["slots"])
            emitted += rec["emitted"]
            accepted += rec["accepted"]
            drafted += rec["drafted"]
        return dict(
            cycles=int(cycles), emitted=int(emitted),
            accepted=int(accepted), drafted=int(drafted),
            tokens_per_cycle=emitted / cycles if cycles else 0.0,
        )

    grid = []
    for p in plane_candidates:
        draft_sched = (int(p),) * cfg.n_layers
        for k in k_candidates:
            r = run(draft_sched, int(k))
            grid.append(dict(planes=int(p), k=int(k), **r))
    best = max(grid, key=lambda r: r["tokens_per_cycle"])
    return dataclasses.replace(
        plan,
        spec_planes=(int(best["planes"]),) * cfg.n_layers,
        spec_k=int(best["k"]),
        modeled=dict(
            plan.modeled,
            spec=dict(
                grid=grid,
                best=dict(planes=best["planes"], k=best["k"]),
                # modeled decode speedup at the measured acceptance rate:
                # tokens-per-cycle relative to one full step per token
                speedup=best["tokens_per_cycle"] * full_step,
                mode=mode,
            ),
        ),
        version=max(int(plan.version), 3),
    )
