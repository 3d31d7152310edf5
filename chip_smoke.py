#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in one process; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel from the checkout's sources, with ``-Xptxas -v``.
2. Kernels vs plain versions: both CUDA MMA kernels (unscaled, on the
   tensor cores, int32 out; scaled, with the fused dequant epilogue, float32
   out: on the tensor cores at M <= 16, on the CUDA cores above) against
   their plain PyTorch versions on the card, bit for bit (``torch.equal``),
   on the reference's kernel sweep, every (planes, signed) variant, and the
   main paths' shapes (the U-Net's conv layers, Yi-6B's decode linears);
   for the unscaled kernel also its three staging paths (16-byte, 4-byte
   and byte copies, by K and N), operands whose base pointer is 1 or 4
   bytes off alignment, and ragged M on both block heights with every
   (planes, signed); for the scaled kernel at decode shapes, M 1-16 across
   K and N that give every staging path, every (planes, signed), the K
   split count forced to 1, 2 and ``max_splits``, views 1 and 4 bytes off
   alignment, and one call captured in a CUDA graph and replayed twice.
3. Forward: the full-width quantized U-Net (80x80x4, base 48, depth 3)
   under uniform 8 planes and a ``from_weights(0.05)`` schedule — the kernel
   path against the plain Horner path, every conv's int32 output equal; and
   the card against the CPU on a small input.
4. Segmentation serving (main path 1): ``SegEngine`` at full width with the
   ``from_weights`` schedule and content-adaptive budget classes serves four
   phantom images through ``run()`` and once through ``serve_stream()``.
   Unscaled-kernel launches must equal 7 per micro-batch; logits must match
   the same engine on the plain path.
5. LM serving (main path 2): Yi-6B at full width (32 layers, random int8
   weights drawn and quantized layer by layer on the card) under the
   ``from_weights(0.05)`` schedule of its ``w_up`` weights serves four
   requests through ``Engine.run``.  Scaled-kernel launches must equal 225
   per decode call (32 x 7 linears + the head); every scaled linear of one
   recorded decode call must equal the plain version bit for bit; that
   call's logits are held against the same call on the plain Horner path.
6. Times (both kernels and their library yardsticks from replays of a
   CUDA graph, so the host's launch rate is not what is timed; the plain
   versions by CUDA events): each kernel at each main-path shape and per
   unit of work (a 4-tile U-Net micro-batch; one LM decode call, the
   recorded call's 225 linears in one graph), at 8 planes and at fewer,
   its plain version, a ``torch._int_mm`` library yardstick (timed only;
   the port never calls it), the card's bound and, for the unscaled
   kernel, the plane-work floor (planes x 2MKN int8 operations at the
   tensor-core peak).  The scaled kernel's per-shape graphs rotate through
   copies of w that together exceed the 50 MB L2, so each call reads w
   from device memory as a decode call does.  Where the toolkit has
   ``cuobjdump``, the count of ``IMMA`` (integer tensor-core) instructions
   in the SASS of every tensor-core kernel's instantiations, none 0.
7. Certified tuning: ``tune_unet`` on the calibrated U-Net of phase 3 with
   two phantom calibration images at target 0.05, through the kernel (the
   calibration sweep runs every plane count 1-8) and again through the
   plain Horner path on the card: the two plans must be equal.  The plan
   then serves phase 4's four images through ``engine_from_plan``: 7
   launches per micro-batch, logits and accounting equal to the plain-path
   plan engine's, and each tile's seven int32 conv outputs equal whether
   its image is served alone or among the others (per-tile activation
   scales).  Last, the measured rows of the Table 1 twin
   (``repro_torch.bench.table1``).
8. The serving gateway (main path 3): ``traces/gateway_burst.json`` (35
   requests: 20 interactive and 12 batch LM, 3 seg) replayed open-loop
   through ``Gateway`` (fair, preemptive) with ``LMAdapter`` serving
   minitron_4b at full width and depth (random int8 weights drawn and
   quantized on the card, ``from_weights(0.05)`` schedule, ``impl='kernel'``,
   batch 20: every LM linear is a scaled-kernel launch at M = 20, the CUDA-
   core branch) and ``SegAdapter`` serving phase 3's U-Net under phase 7's
   plan.  The trace's clock is scaled by the served LM's relation-(2) step
   price over the smoke LM's (``repro_torch.bench.gateway``).  Checks: every
   request completes (LM requests with their token budget, in the
   vocabulary); 225 scaled launches per decode call, 7 unscaled per seg
   micro-batch and none on the LM; every scaled linear of one recorded
   decode call equals the plain version bit for bit; every seg request's
   logits equal its image served alone; the exec events' cycles sum to the
   round clock's worked cycles.  Times the recorded call's 225 linears at
   M = 20 and at M = 16 (the tensor-core decode kernel) against
   ``torch._int_mm`` + scale.

The line before the last is a JSON object naming every kernel with its
launches on its main path and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
TRACE = SRC.parent / "traces" / "gateway_burst.json"  # the gateway's canonical trace

# NVIDIA H100 SXM data sheet, dense: HBM rate and the int8 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

TILES_PER_BATCH = 4  # the engine's micro-batch
LM_BATCH, LM_MAX_SEQ, LM_MAX_NEW = 4, 64, 4  # the LM engine's slots and budgets
SWEEP = [(4, 32, 8), (32, 128, 32), (128, 512, 128), (37, 100, 65),
         (1, 7, 3), (256, 1024, 256), (64, 300, 90)]
# the unscaled kernel's staging: K and N that give each operand 16-byte,
# 4-byte or byte copies; ragged M on both block heights
STAGING_K = (7, 36, 129, 300, 5184)
STAGING_N = (3, 48, 70, 192)
RAGGED_M = (1, 15, 16, 17, 33)
SERVED_PLANES = (8, 5, 1)  # the U-Net path's budgets: uniform, class 0, class 6
SCALED_SWEEP = [(16, 96, 40), (64, 256, 128), (3, 50, 7)]  # the reference's epilogue test
# the scaled kernel at decode shapes: M on one and two n8 fragments, K and N
# that give 16-byte, 4-byte and byte staging, one or many K tiles
DECODE_M = (1, 3, 4, 8, 9, 15, 16)
DECODE_K = (7, 129, 4096, 11008)
DECODE_N = (3, 70, 512, 4096)
L2_BYTES = 50 * 2**20  # the H100's L2: per-shape timings read more w than this

# Logits of the kernel path and the plain path go through the same float
# head on bitwise-equal conv outputs: equal up to the card's reduction order.
LOGIT_ATOL = 1e-5
# The card against the CPU: same integers, float head summed in another order.
CPU_LOGIT_ATOL = 1e-4
# Scaled kernel vs the Horner path's epilogue on the same int32 product:
# (acc * xs) * ws against acc * (xs * ws), two roundings each — a few ulp.
EPILOGUE_RTOL = 5e-7
# LM logits, kernel path vs Horner path, relative to the largest logit.  The
# kernel path quantizes activations with one scale per tensor, the Horner
# path with one per batch row (as in the reference), so the two datapaths
# run on different int8 grids and truncate different digits: on Yi-shaped
# CPU models of 8 and 16 layers at 5 planes the gap was 0.31 and 0.36 of
# the largest logit.  0.6 still fails a path that has lost its signal (two
# unrelated logit vectors differ by more than 1).
LM_LOGIT_REL = 0.6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rand_i8(torch, g, shape, dev):
    return torch.randint(-128, 128, shape, dtype=torch.int8, generator=g).to(dev)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def imma_count(lib: Path, kernel: str):
    """IMMA instructions in each instantiation of ``kernel`` in the built
    library's SASS, or None where the toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import mma_matmul as mk

    tool = Path(mk._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if kernel in name:
                counts[name] = 0
        elif name in counts and "IMMA" in line:
            counts[name] += 1
    return counts


def decode_cases(torch, dev) -> int:
    """The scaled kernel at decode shapes (M <= 16, the tensor-core decode
    kernel) against its plain version, bit for bit; returns the number of
    cases.  Fails on the first that differs."""
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(2)
    n_cases = 0

    def operands(m, k, n, offset=0):
        x = torch.randint(-128, 128, (m * k + offset,), dtype=torch.int8, device=dev, generator=g)
        w = torch.randint(-128, 128, (k * n + offset,), dtype=torch.int8, device=dev, generator=g)
        xs = torch.rand(1, device=dev, generator=g) * 0.1 + 1e-3
        ws = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
        return x[offset:].view(m, k), w[offset:].view(k, n), xs, ws

    def case(x, w, xs, ws, planes=8, signed=True, splits=None, what=""):
        nonlocal n_cases
        got = mk._launch_scaled(x, w, xs, ws, planes, signed, splits=splits)
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes, signed=signed)
        torch.cuda.synchronize()
        n_cases += 1
        check(torch.equal(got, want), f"decode kernel != plain at M={x.shape[0]} K={w.shape[0]} "
              f"N={w.shape[1]} planes={planes} signed={signed} splits={splits} {what}")
        return got

    for k in DECODE_K:
        for n in DECODE_N:
            for m in DECODE_M:
                case(*operands(m, k, n))
    for k, n in ((129, 70), (4096, 512)):
        for m in (4, 9):
            args = operands(m, k, n)
            for planes in range(1, 9):
                for signed in (True, False):
                    case(*args, planes, signed)
    for k in (129, 4096, 11008):
        for n in (70, 4096):
            for m in (1, 4, 16):
                args = operands(m, k, n)
                for splits in sorted({1, min(2, -(-k // mk.DECODE_BK)), mk.max_splits(k)}):
                    case(*args, 5, True, splits)
    for offset in (1, 4):
        for m, k, n in ((4, 4096, 512), (9, 129, 70), (16, 11008, 4096)):
            x, w, xs, ws = operands(m, k, n, offset)
            check(x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0, "views are 16-byte aligned")
            case(x, w, xs, ws, 5, True, what=f"offset={offset}")
    # one call captured in a CUDA graph (its workspace zeroed inside it),
    # replayed twice: equal outputs, equal to the plain version
    for m, k, n in ((4, 4096, 512), (9, 11008, 4096)):
        x, w, xs, ws = operands(m, k, n)
        check(mk.split_k(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count) > 1,
              "the graph case takes no K split")
        want = case(x, w, xs, ws, 5)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)
        outs = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            outs.append(out.clone())
        n_cases += 1
        check(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want),
              f"graph replays of the decode kernel differ at M={m} K={k} N={n}")
    return n_cases


def certified_tuning(torch, np, card, cfg, params, images):
    """Phase 7: tune a plan through the kernel and through the plain path,
    serve it, check it, and time the Table 1 twin's measured rows.  Returns
    what the kernels line reports of this path, and the plan."""
    from repro_torch import autotune
    from repro_torch.bench import table1
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import unet
    from repro_torch.obs.events import RecordingSink
    from repro_torch.segserve.synth import phantom_image

    t_phase = time.perf_counter()
    calib = [phantom_image(160, 128, cfg.in_ch, seed=s) for s in (0, 1)]
    forward = unet.forward

    def tune(tcfg):
        """``tune_unet`` with its forwards counted; the plan, host wall and
        forward count."""
        n = [0]

        def counted(*a, **kw):
            n[0] += 1
            return forward(*a, **kw)

        unet.forward = counted
        try:
            t0 = time.perf_counter()
            plan = autotune.tune_unet(params, tcfg, calib, target_rel_err=0.05)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            unet.forward = forward
        return plan, wall_s, n[0]

    mk.launches = 0
    mk.variant_launches.clear()
    plan, tune_s, n_fwd = tune(cfg)
    tune_launches, variants = mk.launches, dict(sorted(mk.variant_launches.items()))
    cert = plan.certificate
    print(f"[tune] {plan.describe()}")
    print(f"[tune] certificate: measured {cert['measured_rel_err']:.6g} <= cert "
          f"{cert['cert']:.6g} <= target {plan.target_rel_err:g} (holds {cert['holds']}); sound "
          f"bound {cert['sound_bound']:.6g}; repairs {cert['repairs']}, measure calls "
          f"{cert['measure_calls']}; class planes {[list(c) for c in plan.class_planes]}")
    print(f"[tune] {card} | tune_unet through the kernel: {tune_s:.2f} s host wall, {n_fwd} "
          f"forwards, {tune_launches} kernel launches by (planes, signed): {variants}")
    check(cert["measured_rel_err"] <= cert["cert"] <= plan.target_rel_err and cert["holds"],
          f"certificate does not hold: {cert}")
    check(sorted(p for p, _ in variants) == list(range(1, 9)),
          f"tuning launched the kernel at planes {sorted(variants)}, expected every count 1-8")
    check(tune_launches == sum(variants.values()), "launch counts disagree")

    mk.launches = 0
    plain, plain_s, plain_fwd = tune(dataclasses.replace(cfg, impl="horner"))
    check(mk.launches == 0, f"the plain path launched the kernel {mk.launches} times")
    for field in ("planes", "class_planes", "tile", "halo", "class_thresholds"):
        check(getattr(plan, field) == getattr(plain, field),
              f"plans differ in {field}: kernel {getattr(plan, field)}, plain "
              f"{getattr(plain, field)}")
    for key in ("repairs", "measure_calls"):
        check(cert[key] == plain.certificate[key], f"plans differ in {key}")
    d_meas = abs(cert["measured_rel_err"] - plain.certificate["measured_rel_err"])
    check(d_meas <= 1e-6, f"measured_rel_err kernel vs plain differ by {d_meas}")
    check(n_fwd == plain_fwd, f"{n_fwd} forwards through the kernel, {plain_fwd} plain")
    print(f"[tune] tune_unet through the plain path on the card: the same plan (planes, class "
          f"planes, tile, halo, thresholds, repairs, measure calls; measured rel err differs by "
          f"{d_meas:.3g}), {plain_s:.2f} s host wall, {plain_fwd} forwards")

    # serve the plan: launches per micro-batch, against the plain path
    engine = autotune.engine_from_plan(cfg, params, plan)
    engine.obs = RecordingSink()
    mk.launches = 0
    t0 = time.perf_counter()
    results = engine.run(images)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches, batches = mk.launches, len(engine.obs)
    check(batches > 0 and serve_launches == 7 * batches,
          f"plan serving: {serve_launches} launches for {batches} micro-batches")
    ref = autotune.engine_from_plan(dataclasses.replace(cfg, impl="horner"), params, plan).run(images)
    for i, (r, p) in enumerate(zip(results, ref)):
        h, w = images[i].shape[:2]
        check(r.logits.shape == (h, w, cfg.n_classes) and bool(np.isfinite(r.logits).all()),
              f"plan image {i}: logits {r.logits.shape} not finite or of the wrong shape")
        diff = float(np.abs(r.logits - p.logits).max())
        check(diff <= LOGIT_ATOL, f"plan image {i}: logits kernel vs plain differ by {diff}")
        check((r.cycles, r.pj, r.class_counts) == (p.cycles, p.pj, p.class_counts),
              f"plan image {i}: accounting differs between datapaths")
        print(f"[plan] image {i} {h}x{w}: tiles {r.n_tiles} classes {r.class_counts} cycles "
              f"{r.cycles} pJ {r.pj} | paper's FPGA model: {r.time_ms:.3f} ms, "
              f"{r.gops_per_w:.2f} GOPS/W, metered {r.metered_gops_per_w:.2f} GOPS/W | logits vs "
              f"plain max diff {diff}")
    print(f"[plan] {card} | engine_from_plan run(): {len(images)} images, {batches} "
          f"micro-batches, {serve_launches} kernel launches (7 per micro-batch), {serve_ms:.1f} ms "
          f"host wall")

    # each tile's conv outputs alone and among the other images' tiles
    conv = ops.mma_conv2d

    def tiles(imgs):
        """Serve ``imgs``; every nonzero batch row's 7 int32 conv outputs,
        keyed by the row's input window, and each micro-batch's keys."""
        rows, batches, seen = {}, [], []

        def rec_conv(*a, **kw):
            out = conv(*a, **kw)
            seen.append(out)
            return out

        def rec_forward(p, x, fcfg, **kw):
            seen.clear()
            out = forward(p, x, fcfg, **kw)
            keys = []
            for b in range(x.shape[0]):
                if np.any(x[b]):
                    keys.append(x[b].tobytes())
                    rows[keys[-1]] = [c[b] for c in seen]
            batches.append(keys)
            return out

        unet.forward, ops.mma_conv2d = rec_forward, rec_conv
        try:
            autotune.engine_from_plan(cfg, params, plan).run(imgs)
            torch.cuda.synchronize()
        finally:
            unet.forward, ops.mma_conv2d = forward, conv
        return rows, batches

    together, together_batches = tiles(images)
    owner = {}
    for i, im in enumerate(images):
        alone, _ = tiles([im])
        for key, outs in alone.items():
            check(key in together and len(outs) == len(together[key]) == 7,
                  f"image {i}: a tile served alone has no counterpart among the others")
            for l, (a, b) in enumerate(zip(outs, together[key])):
                check(torch.equal(a, b),
                      f"image {i}: a tile's conv {l} int32 output depends on its batch mates")
            owner[key] = i
    check(len(owner) == len(together) == sum(r.n_tiles for r in results),
          f"{len(owner)} tiles served alone, {len(together)} among the others")
    mixed = sum(len({owner[k] for k in keys}) > 1 for keys in together_batches)
    check(mixed > 0, "no micro-batch mixed tiles of different images")
    print(f"[plan] per-tile scales: {len(owner)} tiles, each one's 7 int32 conv outputs equal "
          f"served alone and among the other images ({mixed} of {len(together_batches)} "
          f"micro-batches mixed images)")

    # the Table 1 twin's measured rows, the int8 row at the plan's planes
    rows = table1.measured_rows(planes=plan.planes)
    for name, us, derived in rows:
        check(us > 0, f"{name}: no time")
        print(f"[table1] {name},{us:.3f},{derived}")
    phase_s = time.perf_counter() - t_phase
    print(f"[tune] phase 7 took {phase_s:.1f} s")
    return dict(launches_tuning=tune_launches, launches_tuning_by_planes={
        f"{p}{'' if sg else 'u'}": n for (p, sg), n in variants.items()},
        launches_plan_serving=serve_launches, tune_s=tune_s, plan_serve_ms=serve_ms,
        phase7_s=phase_s), plan


def gateway_replay(torch, np, dev, card, ucfg, uparams, plan):
    """Phase 8: ``traces/gateway_burst.json`` replayed open-loop through the
    gateway at full width (minitron_4b at batch 20 and the calibrated U-Net
    under phase 7's plan), its checks, and the scaled kernel's times at the
    gateway's M = 20 against M = 16.  Returns what the kernels line
    reports of this path."""
    from repro_torch.autotune import engine_from_plan
    from repro_torch.bench import gateway as gwb
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.obs.events import RecordingSink
    from repro_torch.workload import Trace, replay_trace

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cfg, params, sched = gwb.minitron(device=dev)
    torch.cuda.synchronize()
    blocks = params["blocks"]
    linears = [blocks["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [blocks["mlp"][n] for n in ("w_gate", "w_up", "w_down")] + [params["head"]]
    check(all("w_q" in p and "w" not in p for p in linears),
          "a minitron_4b linear stayed in float after quantize_params_int8")
    n_weights = sum(p["w_q"].numel() for p in linears)
    print(f"[gateway] minitron_4b params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{n_weights / 1e9:.3f} G int8 weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated; {sched.describe()}")
    k = gwb.clock_scale(cfg)
    base = Trace.load(TRACE)
    trace = gwb.scaled_trace(base, k)
    print(f"[gateway] clock scale k = {k}: a token step of the served LM is "
          f"{gwb.lm_step_cycles(cfg, cfg.quant.plane_schedule)} modeled cycles, of the smoke LM "
          f"at 8 planes {gwb.lm_step_cycles(get_smoke_config(gwb.SMOKE_LM))} (relation (2), "
          f"the paper's FPGA model); arrivals and the round budget x{k}: round budget "
          f"{trace.meta['round_budget']}, span {trace.span_cycles} cycles, {len(trace)} requests")

    sink = RecordingSink()
    gw, mats = gwb.build(cfg, params, ucfg, uparams, plan, trace, device=dev, sink=sink)
    lm_ad, seg_ad = gw.adapters["lm"], gw.adapters["seg"]
    check(lm_ad._step_cycles == gwb.lm_step_cycles(cfg, cfg.quant.plane_schedule),
          "the adapter prices a token step differently from the clock scale")
    plan_fp, served_fp = seg_ad.verify_info()
    check(plan_fp == served_fp, f"the plan's fingerprint {plan_fp} != served {served_fp}")

    # Record the first decode step's call (M = 20 rows, whatever the step's
    # class): every scaled-kernel call it makes.  Recording adds no launch.
    engine = lm_ad.engine
    rec = {"n": 0, "calls": [], "armed": False}
    decode, step, scaled = engine.decode_fn, engine.step, ops.mma_matmul_scaled

    def recording_scaled(x, w, xs, ws, **kw):
        out = scaled(x, w, xs, ws, **kw)
        rec["calls"].append((x, w, xs, ws, kw["planes"], out))
        return out

    def counted_decode(*args):
        rec["n"] += 1
        if not rec["armed"]:
            return decode(*args)
        rec["armed"] = False
        ops.mma_matmul_scaled = recording_scaled
        try:
            return decode(*args)
        finally:
            ops.mma_matmul_scaled = scaled

    def recording_step(only=None):
        if not rec["calls"]:
            rec["armed"] = True
            rec["live_rows"] = len(engine.ready_slots())
        return step(only=only)

    engine.decode_fn, engine.step = counted_decode, recording_step
    mk.launches = mk.scaled_launches = 0
    t0 = time.perf_counter()
    try:
        summary = replay_trace(gw, trace, mats, max_rounds=10_000)
        torch.cuda.synchronize()
    finally:
        engine.decode_fn, engine.step = decode, step
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = rec["n"]
    seg_batches = sum(1 for e in sink.events if e.etype == "seg-batch")

    # 1. every request served
    reqs = gw.requests
    want_kinds = [r.kind for r in trace.requests]
    check([g.kind for g in reqs] == want_kinds and all(g.done for g in reqs),
          f"{sum(g.done for g in reqs)} of {len(trace)} requests completed")
    for g in reqs:
        if g.kind == "lm":
            out = g.handle.out
            check(len(out) == g.handle.max_new and all(0 <= t < cfg.vocab for t in out),
                  f"LM request {g.rid}: {len(out)} tokens of {g.handle.max_new}, or one outside "
                  f"the vocabulary")
        else:
            lg = g.handle.result.logits
            check(lg.shape == (*g.handle.image.shape[:2], ucfg.n_classes)
                  and bool(np.isfinite(lg).all()), f"seg request {g.rid}: logits {lg.shape}")
    st = gw.stats()
    counts = {c: (pc["n"], pc["completed"]) for c, pc in st["per_class"].items()}
    check(counts == {"interactive": (20, 20), "batch": (12, 12), "seg": (3, 3)},
          f"per-class counts {counts}")

    # 2. launches on this path
    per_call = 7 * cfg.n_layers + 1
    check(calls > 0 and launches == per_call * calls,
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(seg_batches > 0 and unscaled == 7 * seg_batches,
          f"{unscaled} unscaled-kernel launches for {seg_batches} seg micro-batches (7 each, "
          f"none on the LM)")

    # 3. the recorded decode call, per linear, bit for bit
    check(len(rec["calls"]) == per_call, f"{len(rec['calls'])} scaled calls recorded")
    rows = set()
    for x, w, xs, ws, planes, out in rec["calls"]:
        kk, n = w.shape
        x2 = x.reshape(-1, kk)
        rows.add(x2.shape[0])
        want = mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)
        check(torch.equal(out.reshape(-1, n), want),
              f"recorded M={x2.shape[0]} call: scaled linear K={kk} N={n} != plain")
    check(rows == {gwb.LM_BATCH}, f"recorded call rows {rows}, expected {gwb.LM_BATCH}")

    # 4. every seg request's logits equal its image served alone
    for i, (g, treq) in enumerate(zip(reqs, trace.requests)):
        if g.kind != "seg":
            continue
        image, _ = mats["seg"](treq, trace.seed, i)
        alone = engine_from_plan(ucfg, uparams, plan, batch=gwb.SEG_BATCH,
                                 device=dev).run([image])[0]
        check(np.array_equal(alone.logits, g.handle.result.logits),
              f"seg request {g.rid}: logits differ from the image served alone")
        check((alone.cycles, alone.pj) == (g.handle.result.cycles, g.handle.result.pj),
              f"seg request {g.rid}: accounting differs from the image served alone")

    # 5. the accounting closes
    exec_cycles = sum(e.data["cycles"] for e in sink.events if e.etype == "exec")
    worked = gw.round_clock.worked_total
    check(exec_cycles == worked, f"exec events sum to {exec_cycles} cycles, the round clock "
          f"worked {worked}")

    prefill_tokens = sum(e.data["tokens"] for e in sink.events if e.etype == "lm-prefill")
    steps = sum(1 for e in sink.events if e.etype == "lm-step")
    print(f"[gateway] {card} | replay of {base.name} (x{k}): {len(reqs)} requests, host wall "
          f"{wall_s:.2f} s; {calls} decode calls at M = {gwb.LM_BATCH} ({prefill_tokens} prefill "
          f"tokens, {steps} decode steps), {launches} scaled-kernel launches ({per_call} per "
          f"call); {seg_batches} seg micro-batches, {unscaled} unscaled launches (7 each); "
          f"{st['rounds']} rounds, {st['forced']} forced, {len(sink)} events")
    print(f"[gateway] recorded decode call (the first decode step, {rec['live_rows']} live rows "
          f"of {gwb.LM_BATCH}): {per_call} scaled linears bit-exact against the plain version; "
          f"3 seg requests' logits equal served alone; exec events {exec_cycles} cycles = round "
          f"clock worked {worked}")
    for c, pc in st["per_class"].items():
        print(f"[gateway] class {c}: {pc['completed']} of {pc['n']} done, modeled latency p50 "
              f"{pc['p50_ms']:.3f} ms p99 {pc['p99_ms']:.3f} ms (relation (2) clock, the "
              f"paper's FPGA model), deadline misses {pc['deadline_misses']}")
    print(f"[gateway] aggregate {st['gops_w']:.3f} GOPS/W over {st['total_ops']} ops "
          f"(the paper's FPGA model at its implied power, not the card)")

    # times: the recorded call's 225 linears at M = 20 (CUDA cores) and the
    # same shapes at M = 16 (the tensor-core decode kernel)
    times = {}
    for m in (gwb.LM_BATCH, 16):
        mcalls = [(x.reshape(-1, w.shape[0])[:m], w, xs, ws, p)
                  for x, w, xs, ws, p, _ in rec["calls"]]
        libs = [scaled_library(torch, *c) for c in mcalls]
        ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                      for x, w, xs, ws, p in mcalls], calls=1)
        lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
        plain_ms = time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                           for x, w, xs, ws, p in mcalls], reps=1, warmup=1)
        b_ms, b_by, nbytes, nops = scaled_bound([(m, *w.shape) for _, w, *_ in mcalls])
        branch = "mma_tc_decode_kernel" if m <= mk.DECODE_M else "mma_horner_kernel"
        times[m] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        branch=branch)
        print(f"[time] {card} | mma_matmul_scaled one minitron_4b decode call at M = {m} "
              f"({branch}; {len(mcalls)} linears at the schedule's planes, one CUDA graph, "
              f"{nbytes / 1e9:.3f} GB of distinct w: cold): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch._int_mm+scale {lib_ms:.4f} ms (M "
              f"{m if m > 16 else 32} rows), bound {b_ms:.4f} ms ({b_by}; {nops / 1e9:.1f} G int8 "
              f"ops), {nbytes / ms / 1e6:.0f} GB/s")
    phase_s = time.perf_counter() - t_phase
    print(f"[gateway] phase 8 took {phase_s:.1f} s")
    return dict(launches_gateway=launches, gateway_decode_calls=calls, gateway_wall_s=wall_s,
                gateway_clock_scale=k, gateway_seg_batches=seg_batches,
                gateway_m20=times[gwb.LM_BATCH], gateway_m16=times[16],
                gateway_forced=st["forced"], gateway_rounds=st["rounds"], phase8_s=phase_s), \
        dict(launches_gateway=unscaled)


def lm_decode_shapes(cfg):
    """(name, K, N) of every distinct linear of one LM decode call."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return [("wq/wo", d, q), ("wk/wv", d, kv), ("w_gate/w_up", d, cfg.d_ff),
            ("w_down", cfg.d_ff, d), ("head", d, cfg.vocab)]


def lm_serving(torch, np, dev, cfg):
    """Main path 2: Yi-6B at full width served through ``Engine.run``.

    Returns what the times need: the recorded decode call's scaled-kernel
    calls and the path's launch counts."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import bitplane
    from repro_torch.core.plane_schedule import PlaneSchedule
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.obs.events import RecordingSink
    from repro_torch.serve import Engine, Request

    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device=dev, int8_min_dim=256)
    torch.cuda.synchronize()
    blocks = params["blocks"]
    linears = [blocks["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [blocks["mlp"][n] for n in ("w_gate", "w_up", "w_down")] + [params["head"]]
    check(all("w_q" in p and "w" not in p for p in linears),
          "a Yi-6B linear stayed in float after quantize_params_int8")
    n_weights = sum(p["w_q"].numel() for p in linears)
    print(f"[lm] Yi-6B params on the card in {time.perf_counter() - t0:.1f} s: "
          f"{n_weights / 1e9:.3f} G int8 weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    up = blocks["mlp"]["w_up"]["w_q"]
    sched = PlaneSchedule.from_weights([up[l] for l in range(cfg.n_layers)], 0.05)
    print(f"[lm] {sched.describe()}")
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel",
                                         plane_schedule=sched.planes))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 9, LM_BATCH)]
    engine = Engine(kcfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ, device=dev)
    engine.obs = RecordingSink()

    # Record the first decode step (every slot active, all prompts in the
    # cache): its inputs, a copy of the cache before it, and every
    # scaled-kernel call it makes.  Recording adds no launch.
    record_at = sum(len(p) for p in prompts)
    rec = {"calls": []}
    decode, scaled = engine.decode_fn, ops.mma_matmul_scaled

    def recording_scaled(x, w, xs, ws, **kw):
        out = scaled(x, w, xs, ws, **kw)
        rec["calls"].append((x, w, xs, ws, kw["planes"], out))
        return out

    def counted_decode(p, toks, cache, idx, extras):
        n = rec.setdefault("n", 0)
        rec["n"] = n + 1
        if n != record_at:
            return decode(p, toks, cache, idx, extras)
        rec["args"] = (toks.copy(), {k: v.clone() for k, v in cache.items()}, idx.copy())
        ops.mma_matmul_scaled = recording_scaled
        try:
            logits, cache = decode(p, toks, cache, idx, extras)
        finally:
            ops.mma_matmul_scaled = scaled
        rec["logits"] = logits.clone()
        return logits, cache

    engine.decode_fn = counted_decode
    mk.launches = 0
    mk.scaled_launches = 0
    t0 = time.perf_counter()
    done = engine.run([Request(i, p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = rec["n"]
    per_call = 7 * cfg.n_layers + 1
    check(per_call == 225, f"{per_call} linears per decode call, expected 225")
    check(launches == per_call * calls,
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(unscaled == 0, f"{unscaled} unscaled-kernel launches: a linear missed quantization")
    check(len(done) == LM_BATCH and all(r.done and len(r.out) == LM_MAX_NEW for r in done),
          "not every request finished with its token budget")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "a token outside the vocabulary")
    steps = sum(1 for e in engine.obs.events if e.etype == "lm-step")
    print(f"[lm] Engine.run: {len(done)} requests, prompts {[len(p) for p in prompts]}, "
          f"{calls} decode calls ({record_at} prefill + {calls - record_at} step; "
          f"{steps} lm-step events), {launches} scaled-kernel launches "
          f"({launches // calls} per call), {wall_s:.2f} s host wall")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[lm] request {r.rid}: prompt {r.prompt.tolist()} -> tokens {r.out}")

    # the recorded call: every scaled linear bit for bit against the plain
    # version, and within a few ulp of the Horner path's epilogue
    check(len(rec["calls"]) == per_call, f"{len(rec['calls'])} scaled calls recorded")
    epi = 0.0
    for x, w, xs, ws, planes, out in rec["calls"]:
        k, n = w.shape
        x2, o2 = x.reshape(-1, k), out.reshape(-1, n)
        want = mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)
        check(torch.equal(o2, want), f"recorded call: scaled linear K={k} N={n} != plain")
        horner = bitplane.bitplane_matmul(x2, w, planes=planes).to(torch.float32) \
            * (xs.reshape(()) * ws.reshape(-1))
        epi = max(epi, float(((o2 - horner).abs() / horner.abs().clamp(min=1e-30)).max()))
    check(epi <= EPILOGUE_RTOL, f"recorded call: epilogue vs Horner order, rel {epi}")
    toks, cache, idx = rec["args"]
    hcfg = kcfg.replace(quant=dataclasses.replace(kcfg.quant, impl="horner"))
    lh, _ = transformer.decode_step(params, toks, cache, idx, hcfg, device=dev)
    lk = rec["logits"]
    check(lk.shape == (LM_BATCH, 1, cfg.vocab) and bool(torch.isfinite(lk).all()),
          f"recorded call: logits {tuple(lk.shape)} not finite or of the wrong shape")
    lkf, lhf = lk.to(torch.float32), lh.to(torch.float32)
    rel = float((lkf - lhf).abs().max() / lhf.abs().max())
    agree = float((lkf.argmax(-1) == lhf.argmax(-1)).to(torch.float32).mean())
    check(rel <= LM_LOGIT_REL, f"recorded call: logits kernel vs Horner differ by {rel} (rel)")
    print(f"[lm] recorded decode call: {per_call} scaled linears bit-exact against the plain "
          f"version, epilogue vs Horner order max rel {epi:.3g}; logits vs Horner path max rel "
          f"{rel:.4f} (limit {LM_LOGIT_REL}), top-1 agreement {agree:.2f}, "
          f"max |logit| {float(lhf.abs().max()):.3f}")
    return dict(calls=rec["calls"], launches=launches, unscaled=unscaled, wall_s=wall_s,
                decode_calls=calls)


def scaled_library(torch, x, w, xs, ws, planes):
    """The scaled kernel's library yardstick: ``torch._int_mm`` on the
    truncated operand, then the same epilogue.  ``_int_mm`` wants M > 16, so
    up to 16 rows x is padded to 32 (those rows are computed and dropped);
    above 16 it runs at M."""
    from repro_torch.core import bitplane

    m, k = x.shape
    xp = torch.zeros((m if m > 16 else 32, k), dtype=torch.int8, device=x.device)
    xp[:m] = bitplane.truncate_to_planes(x, planes)
    return lambda: torch._int_mm(xp, w)[:m].to(torch.float32) * xs.reshape(()) * ws.reshape(-1)


def scaled_bound(shapes):
    """The scaled kernel's bound over ``(M, K, N)`` calls: each input read
    once (x, w, the scales), the float32 output written once, at the HBM
    rate; 2MKN int8 operations at the int8 tensor-core peak.  ``(ms, what
    bounds it, bytes, operations)``."""
    nbytes = sum(m * k + k * n + 4 * n + 4 + 4 * m * n for m, k, n in shapes)
    nops = sum(2 * m * k * n for m, k, n in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes, nops


def lm_times(torch, dev, card, lm, decode_shapes):
    """The scaled kernel's times, from CUDA-graph replays: per decode shape
    at 8, 5 and 1 planes with w cold in L2, and per decode call, replaying
    the recorded call's 225 kernel calls."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    def rotating(fns):
        """One call per graph slot, cycling through ``fns``."""
        it = itertools.cycle(fns)
        return lambda: next(it)()

    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    for name, k, n in decode_shapes:
        m = LM_BATCH
        # enough copies of w that a graph of calls never finds one in L2
        copies = -(-2 * L2_BYTES // (k * n))
        calls = max(20, copies)
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
        ws_ = [torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
               for _ in range(copies)]
        xs = torch.full((1,), 0.01, device=dev)
        wsc = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
        libs = [scaled_library(torch, x, w, xs, wsc, 8) for w in ws_]
        check(torch.equal(libs[0](), mk.mma_matmul_scaled_kernel(x, ws_[0], xs, wsc)),
              f"{name}: library yardstick disagrees with the scaled kernel")
        ms_planes = {p: graph_ms(torch, rotating([
            lambda w=w, p=p: mk.mma_matmul_scaled_kernel(x, w, xs, wsc, planes=p) for w in ws_]),
            calls=calls) for p in (8, 5, 1)}
        ms = ms_planes[8]
        lib_ms = graph_ms(torch, rotating(libs), calls=calls)
        plain_ms = time_ms(torch, lambda: mk.mma_matmul_scaled_plain(x, ws_[0], xs, wsc), reps=3,
                           warmup=1)
        b_ms, b_by, nbytes, nops = scaled_bound([(m, k, n)])
        splits = mk.split_k(m, k, n, sms)
        per_shape.append(dict(name=name, M=m, K=k, N=n, ms=ms, ms_planes=ms_planes,
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              bytes=nbytes, ops=nops, splits=splits, w_copies=copies))
        print(f"[time] {card} | mma_matmul_scaled {name} M={m} K={k} N={n} ({splits} K splits; "
              f"graph of {calls} calls over {copies} copies of w, {calls * k * n / 2**20:.0f} MiB "
              f"of distinct w per replay, > the {L2_BYTES >> 20} MiB L2: cold) planes 8: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.4f} ms, torch._int_mm+scale {lib_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {nbytes / ms / 1e6:.0f} GB/s | planes 5: "
              f"{ms_planes[5]:.5f} ms, planes 1: {ms_planes[1]:.5f} ms")
        del ws_, libs

    calls = [(x.reshape(-1, w.shape[0]), w, xs, ws, planes) for x, w, xs, ws, planes, _ in lm["calls"]]
    libs = [scaled_library(torch, *c) for c in calls]
    ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                  for x, w, xs, ws, p in calls], calls=1)
    lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
    plain_ms = time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                       for x, w, xs, ws, p in calls], reps=1, warmup=1)
    b_ms, b_by, nbytes, nops = scaled_bound([(x.shape[0], w.shape[0], w.shape[1])
                                             for x, w, *_ in calls])
    print(f"[time] {card} | mma_matmul_scaled one decode call ({len(calls)} linears, the "
          f"schedule's planes, one CUDA graph; {nbytes / 1e9:.3f} GB of distinct w: cold): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch._int_mm+scale {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {nops / 1e9:.1f} G int8 ops), {nbytes / ms / 1e6:.0f} GB/s | "
          f"Engine.run host wall {lm['wall_s']:.2f} s for {lm['decode_calls']} decode calls")
    return dict(
        name="mma_matmul_scaled", route="cuda", source="src/repro_torch/csrc/mma_matmul.cu",
        replaces="src/repro/kernels/mma_matmul.py:163", launches=lm["launches"],
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
        work=f"one Yi-6B decode call at batch {LM_BATCH}: {len(calls)} linears at the "
             f"schedule's planes, replayed from the served run as one CUDA graph",
        lm_wall_s=lm["wall_s"], lm_decode_calls=lm["decode_calls"], per_shape=per_shape,
    )


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.bench.table1 import card_line, graph_ms
    from repro_torch.configs import get_config
    from repro_torch.core import bitplane
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import unet
    from repro_torch.obs.events import RecordingSink
    from repro_torch.segserve import SegEngine
    from repro_torch.segserve.synth import phantom_image

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---------------------------------------------------- 1. device, build
    print(card)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib, ptxas = mk.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    imma = {}
    for kernel in ("mma_tc_horner_kernel", "mma_tc_decode_kernel"):
        counts = imma_count(lib, kernel)
        if counts is None:
            print("[sass] no cuobjdump in the toolkit: IMMA count not taken")
            break
        check(len(counts) == 32 and min(counts.values()) > 0,
              f"{kernel}: IMMA instructions per instantiation: {sorted(counts.values())}")
        imma[kernel] = sum(counts.values())
        print(f"[sass] {kernel}: {len(counts)} instantiations, IMMA instructions "
              f"{imma[kernel]} in all, {min(counts.values())}..{max(counts.values())} each")

    # ------------------------------------------ 2. kernels vs plain versions
    cfg = unet.UNetConfig(quant_mode="mma_int8")  # calibrated width, kernel datapath
    # the KPB matmul of each 3x3 conv at one 80x80 window: (name, M, K, N)
    names = ([f"enc{d}" for d in range(cfg.depth)] + ["bottleneck"]
             + [f"dec{d}" for d in reversed(range(cfg.depth))])
    layers = [(nm, c.out_h * c.out_w, c.k * c.k * c.cin, c.cout)
              for nm, c in zip(names, cfg.conv_layers())]
    g = torch.Generator().manual_seed(0)
    max_err = 0
    n_cases = 0

    scaled_err = 0.0
    n_scaled = 0

    def compare(m, k, n, planes, signed=True, bm=None, offset=0):
        """``bm`` forces the block height; ``offset`` > 0 makes both
        operands views that many bytes into their storage."""
        nonlocal max_err, n_cases
        x = rand_i8(torch, g, (m * k + offset,), dev)[offset:].view(m, k)
        w = rand_i8(torch, g, (k * n + offset,), dev)[offset:].view(k, n)
        if offset:
            check(x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0, "views are 16-byte aligned")
        got = (mk.mma_matmul_kernel(x, w, planes=planes, signed=signed) if bm is None
               else mk._launch(x, w, planes, signed, bm=bm))
        want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_cases += 1
        check(torch.equal(got, want), f"kernel != plain at M={m} K={k} N={n} planes={planes} "
              f"signed={signed} bm={bm} offset={offset}")

    def compare_scaled(m, k, n, planes, signed=True):
        nonlocal scaled_err, n_scaled
        x, w = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        xs = (torch.rand(1, generator=g) * 0.1 + 1e-3).to(dev)
        ws = (torch.rand(n, generator=g) * 0.01 + 1e-4).to(dev)
        got = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=planes, signed=signed)
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes, signed=signed)
        torch.cuda.synchronize()
        scaled_err = max(scaled_err, float((got - want).abs().max()) if got.numel() else 0.0)
        n_scaled += 1
        check(torch.equal(got, want),
              f"scaled kernel != plain at M={m} K={k} N={n} planes={planes} signed={signed}")

    for cmp in (compare, compare_scaled):
        for m, k, n in SWEEP:
            for planes in (8, 5, 2):
                cmp(m, k, n, planes)
        for planes in range(1, 9):
            for signed in (True, False):
                cmp(67, 129, 70, planes, signed)
                cmp(3, 129, 70, planes, signed)  # small M: the scaled kernel's decode path
    for m, k, n in SCALED_SWEEP:
        for planes in (8, 5):
            compare_scaled(m, k, n, planes)
    for _, m, k, n in layers:
        compare(m * TILES_PER_BATCH, k, n, 8)
        compare(m * TILES_PER_BATCH, k, n, 5)
    for k in STAGING_K:
        for n in STAGING_N:
            compare(67, k, n, 8)
    for offset in (1, 4):
        compare(67, 300, 48, 8, offset=offset)
        compare(45, 5184, 192, 5, offset=offset)
    for bm in (32, 64):
        for m in RAGGED_M:
            compare(m, 256, 80, 8, bm=bm)
        for planes in range(1, 9):
            for signed in (True, False):
                compare(33, 256, 80, planes, signed, bm=bm)
    lm_cfg = get_config("yi_6b")
    decode_shapes = lm_decode_shapes(lm_cfg)
    for _, k, n in decode_shapes:
        compare_scaled(LM_BATCH, k, n, 8)
        compare_scaled(LM_BATCH, k, n, 5)
    n_decode = decode_cases(torch, dev)
    print(f"[kernel] mma_matmul: {n_cases} cases bit-exact against the plain version, "
          f"max_abs_err {max_err}")
    print(f"[kernel] mma_matmul_scaled: {n_scaled} cases plus {n_decode} decode cases "
          f"bit-exact against the plain version, max_abs_err {scaled_err}")

    # ------------------------------------------------------- 3. forward
    params = unet.init_params(0, cfg)
    sched = unet.schedule_from_params(params, 0.05)
    print(f"[forward] {sched.describe()}")
    x = np.random.default_rng(0).normal(size=(1, 80, 80, cfg.in_ch)).astype(np.float32)

    def conv_outputs(fcfg, xin, device=None):
        """Logits plus every conv's int32 output, recorded at the KPB conv."""
        seen = []
        inner = ops.mma_conv2d

        def recording(*a, **kw):
            out = inner(*a, **kw)
            seen.append(out)
            return out

        ops.mma_conv2d = recording
        try:
            logits = unet.forward(params, xin, fcfg, device=device)
        finally:
            ops.mma_conv2d = inner
        torch.cuda.synchronize()
        return logits, seen

    for name, fcfg in [("uniform-8", cfg),
                       ("from_weights(0.05)", dataclasses.replace(cfg, plane_schedule=sched.planes))]:
        lk, ck = conv_outputs(fcfg, x)
        lh, ch = conv_outputs(dataclasses.replace(fcfg, impl="horner"), x)
        check(len(ck) == len(ch) == 7, f"{len(ck)} convs recorded, expected 7")
        for i, (a, b) in enumerate(zip(ck, ch)):
            check(a.dtype == torch.int32 and torch.equal(a, b), f"{name}: conv {i} differs")
        diff = float((lk - lh).abs().max())
        check(lk.shape == (1, 80, 80, cfg.n_classes) and bool(torch.isfinite(lk).all()),
              f"{name}: logits {tuple(lk.shape)} not finite or of the wrong shape")
        check(diff <= LOGIT_ATOL, f"{name}: logits kernel vs plain differ by {diff}")
        print(f"[forward] {name}: 7 convs int32-equal kernel vs plain, logits max diff {diff}")
    xs = x[:, :16, :16]
    lg, cg = conv_outputs(dataclasses.replace(cfg, plane_schedule=sched.planes), xs)
    lc, cc = conv_outputs(dataclasses.replace(cfg, plane_schedule=sched.planes), xs, "cpu")
    for i, (a, b) in enumerate(zip(cg, cc)):
        check(torch.equal(a.cpu(), b), f"card vs CPU: conv {i} differs")
    diff = float((lg.cpu() - lc).abs().max())
    check(diff <= CPU_LOGIT_ATOL, f"card vs CPU logits differ by {diff}")
    print(f"[forward] 16x16 input, card vs CPU: 7 convs int32-equal, logits max diff {diff}")

    # ------------------------------- 4. segmentation serving (main path 1)
    scfg = dataclasses.replace(cfg, plane_schedule=sched.planes)
    images = [phantom_image(160, 128, cfg.in_ch, seed=0), phantom_image(160, 128, cfg.in_ch, seed=1),
              phantom_image(80, 80, cfg.in_ch), phantom_image(200, 152, cfg.in_ch)]
    engine = SegEngine(scfg, params, adaptive=True)
    engine.obs = RecordingSink()
    mk.launches = 0
    t0 = time.perf_counter()
    results = engine.run(images)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    run_batches, run_launches = len(engine.obs), mk.launches
    stream_engine = SegEngine(scfg, params, adaptive=True)
    stream_engine.obs = RecordingSink()
    done_ms = {}
    t0 = time.perf_counter()
    for ev in stream_engine.serve_stream(images):
        if ev.done:
            torch.cuda.synchronize()
            done_ms[ev.rid] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    stream_ms = (time.perf_counter() - t0) * 1e3
    launches = mk.launches
    batches = run_batches + len(stream_engine.obs)
    check(run_launches == 7 * run_batches,
          f"run(): {run_launches} launches for {run_batches} micro-batches")
    check(launches == 7 * batches, f"{launches} launches for {batches} micro-batches")
    print(f"[serve] run(): {run_batches} micro-batches, {run_launches} kernel launches, "
          f"{run_ms:.1f} ms host wall | serve_stream(): {len(stream_engine.obs)} micro-batches, "
          f"{launches - run_launches} launches, {stream_ms:.1f} ms host wall")

    plain = SegEngine(dataclasses.replace(scfg, impl="horner"), params, adaptive=True).run(images)
    for i, (r, p) in enumerate(zip(results, plain)):
        h, w = images[i].shape[:2]
        check(r.logits.shape == (h, w, cfg.n_classes) and bool(np.isfinite(r.logits).all()),
              f"image {i}: logits {r.logits.shape} not finite or of the wrong shape")
        diff = float(np.abs(r.logits - p.logits).max())
        check(diff <= LOGIT_ATOL, f"image {i}: served logits kernel vs plain differ by {diff}")
        check((r.cycles, r.pj, r.class_counts) == (p.cycles, p.pj, p.class_counts),
              f"image {i}: accounting differs between datapaths")
        print(f"[serve] image {i} {h}x{w}: tiles {r.n_tiles} classes {r.class_counts} "
              f"cycles {r.cycles} pJ {r.pj} modeled {r.time_ms:.3f} ms "
              f"{r.metered_gops_per_w:.2f} GOPS/W | host wall to done {done_ms[i]:.1f} ms "
              f"(serve_stream) | logits vs plain max diff {diff}")

    # ---------------------------------------- 5. LM serving (main path 2)
    lm = lm_serving(torch, np, dev, lm_cfg)

    # ---------------------------------------------------------- 6. times
    per_shape = []
    for name, m1, k, n in layers:
        m = m1 * TILES_PER_BATCH
        x8, w8 = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        ms_planes = {p: graph_ms(torch, lambda: mk.mma_matmul_kernel(x8, w8, planes=p))
                     for p in SERVED_PLANES}
        ms = ms_planes[8]
        plain_ms = time_ms(torch, lambda: mk.mma_matmul_plain(x8, w8, planes=8), reps=3, warmup=1)
        # the library yardstick on the truncate_to_planes operand (identity at
        # 8 planes); _int_mm wants K and N multiples of 8, so pad K with zero
        # columns of x and zero rows of w — the same function
        kp = -(-k // 8) * 8
        xl = torch.zeros((m, kp), dtype=torch.int8, device=dev)
        xl[:, :k] = bitplane.truncate_to_planes(x8, 8)
        wl = torch.zeros((kp, n), dtype=torch.int8, device=dev)
        wl[:k] = w8
        check(torch.equal(torch._int_mm(xl, wl), mk.mma_matmul_kernel(x8, w8)),
              f"{name}: library yardstick disagrees with the kernel")
        lib_ms = graph_ms(torch, lambda: torch._int_mm(xl, wl))
        nbytes = m * k + k * n + 4 * m * n
        nops = 2 * m * k * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
        row = dict(name=name, M=m, K=k, N=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   plane_floor_ms=8 * t_ops, ms_planes=ms_planes, bytes=nbytes, ops=nops,
                   block_rows=mk.tile_rows(m, n, torch.cuda.get_device_properties(0).multi_processor_count))
        per_shape.append(row)
        print(f"[time] {card} | mma_matmul {name} M={m} K={k} N={n} planes=8 (block rows "
              f"{row['block_rows']}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
              f"{lib_ms:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), plane-work "
              f"floor {row['plane_floor_ms']:.5f} ms, {nops / ms / 1e6:.1f} GOP/s | planes 5: "
              f"{ms_planes[5]:.4f} ms, planes 1: {ms_planes[1]:.4f} ms")

    tot_bytes = sum(r["bytes"] for r in per_shape)
    tot_ops = sum(r["ops"] for r in per_shape)
    t_bytes, t_ops = tot_bytes / HBM_BYTES_PER_S * 1e3, tot_ops / INT8_OPS_PER_S * 1e3
    summary = dict(
        name="mma_matmul", route="cuda", source="src/repro_torch/csrc/mma_matmul.cu",
        replaces="src/repro/kernels/mma_matmul.py:127", launches=launches, max_abs_err=max_err,
        ms=sum(r["ms"] for r in per_shape), plain_ms=sum(r["plain_ms"] for r in per_shape),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=sum(r["library_ms"] for r in per_shape),
        work="one 4-tile micro-batch: the 7 conv shapes of an 80x80 window, planes 8",
        ms_planes={p: sum(r["ms_planes"][p] for r in per_shape) for p in SERVED_PLANES},
        plane_floor_ms=8 * t_ops, imma=imma.get("mma_tc_horner_kernel"),
        launches_lm=lm["unscaled"], per_shape=per_shape,
    )
    print(f"[time] {card} | mma_matmul one 4-tile forward: kernel {summary['ms']:.4f} ms, "
          f"plain {summary['plain_ms']:.4f} ms, torch._int_mm {summary['library_ms']:.4f} ms, "
          f"bound {summary['bound_ms']:.5f} ms ({summary['bound_by']}), plane-work floor "
          f"{summary['plane_floor_ms']:.5f} ms | planes 5: {summary['ms_planes'][5]:.4f} ms, "
          f"planes 1: {summary['ms_planes'][1]:.4f} ms")
    scaled_summary = lm_times(torch, dev, card, lm, decode_shapes)
    scaled_summary["max_abs_err"] = scaled_err
    scaled_summary["imma"] = imma.get("mma_tc_decode_kernel")
    del lm  # the recorded calls hold Yi-6B's weights
    torch.cuda.empty_cache()

    # ------------------------------------------------ 7. certified tuning
    tuning, plan = certified_tuning(torch, np, card, cfg, params, images)
    summary.update(tuning)

    # ------------------------------------------------- 8. the gateway
    scaled_gw, unscaled_gw = gateway_replay(torch, np, dev, card, cfg, params, plan)
    scaled_summary.update(scaled_gw)
    summary.update(unscaled_gw)
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": [summary, scaled_summary]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
