#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in one process; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel from the checkout's sources, with ``-Xptxas -v``.
2. Kernels vs plain versions: both CUDA MMA kernels (unscaled, on the
   tensor cores, int32 out; scaled, with the fused dequant epilogue, float32
   out, on the tensor cores at every M) against
   their plain PyTorch versions on the card, bit for bit (``torch.equal``),
   on the reference's kernel sweep, every (planes, signed) variant, and the
   main paths' shapes (the U-Net's conv layers, Yi-6B's decode linears);
   for the unscaled kernel also its three staging paths (16-byte, 4-byte
   and byte copies, by K and N), operands whose base pointer is 1 or 4
   bytes off alignment, and ragged M on both block heights with every
   (planes, signed); for the scaled kernel, M 1-16 (one and two n8
   fragments) and M 17-512 (three and four n8 fragments, row tiles of 32)
   across K and N that give every staging path, every (planes, signed), the
   K split count forced to 1, 2 and ``max_splits``, views 1 and 4 bytes off
   alignment, and calls captured in a CUDA graph and replayed twice.
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
   in the SASS of every instantiation of both kernels (32 unscaled, 64
   scaled: NF 1-4), none 0; and no ``mma_horner_kernel`` (the CUDA-core
   scaled kernel this design replaced) in the library.
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
   batch 20: every LM linear is a scaled-kernel launch at M = 20, three
   n8 fragments in one pass) and ``SegAdapter`` serving phase 3's U-Net
   under phase 7's
   plan.  The trace's clock is scaled by the served LM's relation-(2) step
   price over the smoke LM's (``repro_torch.bench.gateway``).  Checks: every
   request completes (LM requests with their token budget, in the
   vocabulary); 225 scaled launches per decode call, 7 unscaled per seg
   micro-batch and none on the LM; every scaled linear of one recorded
   decode call equals the plain version bit for bit; every seg request's
   logits equal its image served alone; the exec events' cycles sum to the
   round clock's worked cycles.  Times the recorded call's 225 linears at
   M = 16, 20, 24, 32, 64 and (the layer linears only: the head's output
   alone is 262 MB) 256 against ``torch._int_mm`` + scale and the bound,
   its plain version at 16 and 20, and each distinct minitron_4b linear at
   M = 20 alone with w cold.

9. Precision-speculative decoding (main path 4) on phase 8's minitron_4b
   (full width and depth, ``impl='kernel'``): ``tune_lm`` at target 0.05 on
   one 16-token prompt (the Horner route, the repair loop capped at 8;
   re-measuring its planes gives its ``measured_rel_err`` to the last bit),
   ``tune_spec`` extending that plan on draft planes 2 and 4 x depth 2 and
   4, then four requests served through ``Gateway`` + ``SpecLMAdapter`` under
   the tuned v3 plan: every request completes, 225 scaled launches per
   decode call (draft calls at the draft budget, the others at the plan's
   planes, every head at 8), one recorded draft call and one verify call
   bit-exact against the plain version on all 225 linears, exec cycles
   equal to the round clock's, the draft/verify/accept events present, and
   the ``EnergyMeter`` armed beside the recording sink (verify work priced
   at the plan's planes, drafts at the draft budget: the paper's FPGA energy
   model) closes its spec account (useful + wasted pJ = draft + verify pJ,
   slot-level cycles = round-level cycles) and its whole ledger.
   The same requests through a greedy ``Engine`` and a ``SpecEngine`` on the
   kernel route: identical streams counted, not gated (one activation scale
   per tensor couples the slots); on the Horner route at 4 layers, gated:
   streams, lengths and live cache rows equal greedy's.  Times the recorded
   draft and verify calls' 225 linears (CUDA-graph replays, w cold) against
   ``torch._int_mm`` + scale and the bound.
10. The serving fabric (main path 5): ``traces/diurnal_smoke.json`` (51
   requests, each with a deadline: 35 interactive LM of 4+8 tokens, 11 batch
   of 24+4, 5 seg of 96x80) replayed open-loop through a ``Fabric`` of two
   phase-8 gateways (``deficit`` routing, work stealing, seed 0), the shards
   sharing phase 8's minitron_4b weights and phase 7's plan; the trace's
   stamps, deadlines and round budget, the interactive SLO's latency
   target and the monitor's burn windows all scaled by phase 8's k.  Armed:
   a ``RecordingSink``, an ``SloMonitor`` (the capacity bench's specs), an
   ``EnergyMeter`` (the served schedules' rates) and a ``CaptureSink``.
   Checks: every request completes (LM with its budget, in the vocabulary);
   the fleet ledger is additive; exec events reconcile with every shard's
   round clock and the fleet ledger; the monitor's misses and attribution
   equal the span-derived ones and ``stats()``'s; the meter's pJ ledger
   holds to the picojoule; every shard's ``stats()`` carries ``slo`` and
   ``energy`` blocks; the captured trace's requests equal the replayed
   trace's; 225 scaled launches per decode call and 7 unscaled per seg
   micro-batch; each shard's first decode-step call bit-exact against the
   plain version on all 225 linears; every seg request's logits equal its
   image served alone.  Prints the replay's host wall, decode calls and
   micro-batches per shard, routes and steals, per-class modeled
   latencies and misses, and metered and analytic GOPS/W (the FPGA model).

The line before the last is a JSON object naming every kernel with its
launches on its main path and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
TRACE = SRC.parent / "traces" / "gateway_burst.json"  # the gateway's canonical trace
DIURNAL = SRC.parent / "traces" / "diurnal_smoke.json"  # the fabric's: every request has a deadline

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
NARROW_M = (1, 3, 4, 8, 9, 15, 16)
NARROW_K = (7, 129, 4096, 11008)
NARROW_N = (3, 70, 512, 4096)
# the scaled kernel above 16 rows: three and four n8 fragments in one pass,
# row tiles of 32 (ragged at 33 and 100); minitron_4b's K and N among them
WIDE_M = (17, 20, 24, 25, 32, 33, 64, 100, 512)
WIDE_K = (7, 129, 3072, 9216)
WIDE_N = (3, 70, 1024, 4096)
GATEWAY_M = (16, 20, 24, 32, 64, 256)  # phase 8's decode-call sweep
# phase 9: tune_lm on one 16-token prompt, the repair loop capped; tune_spec
# on the reference bench's trimmed grid; four 4-token requests served
SPEC_TARGET, SPEC_MAX_REPAIR, SPEC_TUNE_TOKENS = 0.05, 8, 16
SPEC_PLANE_GRID, SPEC_K_GRID = (2, 4), (2, 4)
SPEC_BATCH, SPEC_MAX_SEQ, SPEC_MAX_NEW, SPEC_PROMPT = 4, 48, 8, 4
SPEC_HORNER_LAYERS = 4  # the plain Horner route's identity gate runs at this depth
HEAD_OUT_M = 64  # above this many rows the sweep drops the head (256 rows: 262 MB out)
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


def decode_cases(torch, dev) -> tuple[int, int]:
    """The scaled kernel at decode shapes (M <= 16: one and two n8
    fragments) and above 16 rows (three and four, row tiles of 32) against
    its plain version, bit for bit; returns the number of cases of each.
    Fails on the first that differs."""
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        check(torch.equal(got, want), f"scaled kernel != plain at M={x.shape[0]} K={w.shape[0]} "
              f"N={w.shape[1]} planes={planes} signed={signed} splits={splits} {what}")
        return got

    def graph_case(m, k, n):
        """One split call captured in a CUDA graph (its workspace zeroed
        inside it), replayed twice: equal outputs, equal to the plain
        version."""
        nonlocal n_cases
        x, w, xs, ws = operands(m, k, n)
        check(mk.split_k(m, k, n, sms) > 1, f"the graph case M={m} K={k} N={n} takes no K split")
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
              f"graph replays of the scaled kernel differ at M={m} K={k} N={n}")

    def sweep(ms, ks, ns, variant_shapes, variant_ms, split_ms, split_ks, split_ns,
              offset_shapes, graph_shapes):
        for k in ks:
            for n in ns:
                for m in ms:
                    case(*operands(m, k, n))
        for k, n in variant_shapes:
            for m in variant_ms:
                args = operands(m, k, n)
                for planes in range(1, 9):
                    for signed in (True, False):
                        case(*args, planes, signed)
        for k in split_ks:
            for n in split_ns:
                for m in split_ms:
                    args = operands(m, k, n)
                    for splits in sorted({1, min(2, -(-k // mk.SCALED_BK)), mk.max_splits(k)}):
                        case(*args, 5, True, splits)
        for offset in (1, 4):
            for m, k, n in offset_shapes:
                x, w, xs, ws = operands(m, k, n, offset)
                check(x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0,
                      "views are 16-byte aligned")
                case(x, w, xs, ws, 5, True, what=f"offset={offset}")
        for m, k, n in graph_shapes:
            graph_case(m, k, n)

    sweep(NARROW_M, NARROW_K, NARROW_N, ((129, 70), (4096, 512)), (4, 9), (1, 4, 16),
          (129, 4096, 11008), (70, 4096), ((4, 4096, 512), (9, 129, 70), (16, 11008, 4096)),
          ((4, 4096, 512), (9, 11008, 4096)))
    n_decode, n_cases = n_cases, 0
    sweep(WIDE_M, WIDE_K, WIDE_N, ((129, 70), (3072, 1024)), (20, 40), (17, 20, 33, 64),
          (129, 3072, 9216), (70, 1024), ((20, 3072, 1024), (25, 129, 70), (40, 9216, 3072)),
          ((20, 3072, 1024), (40, 9216, 3072)))
    return n_decode, n_cases


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
    under phase 7's plan), its checks, and the scaled kernel's times: one
    decode call's linears across M, and each distinct linear alone at the
    gateway's M = 20.  Returns what the kernels line reports of this
    path."""
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

    # times: the recorded call's linears across M (x past the recorded 20
    # rows drawn at random: the kernel's work does not depend on the
    # values), each with the branch it takes, and each distinct linear at
    # the gateway's M alone with w cold
    recorded = [(x.reshape(-1, w.shape[0]), w, xs, ws, p) for x, w, xs, ws, p, _ in rec["calls"]]
    g = torch.Generator(device=dev).manual_seed(5)
    extra = {kk: torch.randint(-128, 128, (max(GATEWAY_M), kk), dtype=torch.int8, device=dev,
                               generator=g) for kk in {w.shape[0] for _, w, *_ in recorded}}
    times = {}
    for m in GATEWAY_M:
        mcalls = [(x[:m] if m <= x.shape[0] else torch.cat([x, extra[w.shape[0]][:m - x.shape[0]]]),
                   w, xs, ws, p) for x, w, xs, ws, p in recorded
                  if m <= HEAD_OUT_M or w.shape[1] != cfg.vocab]
        libs = [scaled_library(torch, *c) for c in mcalls]
        ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                      for x, w, xs, ws, p in mcalls], calls=1)
        lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
        plain_ms = (time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                            for x, w, xs, ws, p in mcalls], reps=1, warmup=1)
                    if m in (16, gwb.LM_BATCH) else None)
        b_ms, b_by, nbytes, nops = scaled_bound([(m, *w.shape) for _, w, *_ in mcalls])
        branch = (f"mma_tc_scaled_kernel, {min(4, -(-m // 8))} n8 fragments per pass, "
                  f"{mk.row_tiles(m)} row tile{'s' if mk.row_tiles(m) > 1 else ''}")
        times[m] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        branch=branch, linears=len(mcalls))
        what = "" if len(mcalls) == len(recorded) else ", the layer linears only"
        print(f"[time] {card} | mma_matmul_scaled one minitron_4b decode call at M = {m} "
              f"({branch}; {len(mcalls)} linears at the schedule's planes{what}, one CUDA "
              f"graph, {nbytes / 1e9:.3f} GB of distinct w: cold): kernel {ms:.4f} ms, plain "
              + ("not timed" if plain_ms is None else f"{plain_ms:.3f} ms")
              + f", torch._int_mm+scale {lib_ms:.4f} ms (M {m if m > 16 else 32} rows), bound "
              f"{b_ms:.4f} ms ({b_by}; {nops / 1e9:.1f} G int8 ops), {nbytes / ms / 1e6:.0f} GB/s")
    planes_of = {tuple(w.shape): p for _, w, _, _, p in recorded}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    m = gwb.LM_BATCH
    for name, kk, n in lm_decode_shapes(cfg):
        p = planes_of[(kk, n)]
        ms_planes, lib_ms, plain_ms, copies, gcalls = cold_shape_times(torch, dev, g, m, kk, n,
                                                                       (p,))
        b_ms, b_by, nbytes, _ = scaled_bound([(m, kk, n)])
        splits = mk.split_k(m, kk, n, sms)
        per_shape.append(dict(name=name, M=m, K=kk, N=n, planes=p, ms=ms_planes[p],
                              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              splits=splits, w_copies=copies))
        print(f"[time] {card} | mma_matmul_scaled minitron_4b {name} M={m} K={kk} N={n} planes "
              f"{p} ({splits} K splits; graph of {gcalls} calls over {copies} copies of w: cold): "
              f"kernel {ms_planes[p]:.5f} ms, plain {plain_ms:.4f} ms, torch._int_mm+scale "
              f"{lib_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), {b_ms / ms_planes[p]:.3f} of the "
              f"bound, {nbytes / ms_planes[p] / 1e6:.0f} GB/s")
    phase_s = time.perf_counter() - t_phase
    print(f"[gateway] phase 8 took {phase_s:.1f} s")
    return dict(launches_gateway=launches, gateway_decode_calls=calls, gateway_wall_s=wall_s,
                gateway_clock_scale=k, gateway_seg_batches=seg_batches,
                gateway_m20=times[gwb.LM_BATCH], gateway_m16=times[16],
                gateway_m_sweep=times, gateway_m20_per_shape=per_shape,
                gateway_forced=st["forced"], gateway_rounds=st["rounds"], phase8_s=phase_s), \
        dict(launches_gateway=unscaled), (cfg, params)


def fabric_replay(torch, np, dev, card, ucfg, uparams, plan, cfg, params):
    """Phase 10: ``traces/diurnal_smoke.json`` replayed open-loop through a
    2-shard ``Fabric`` of phase 8's gateways at full width (one set of
    minitron_4b weights and the U-Net under phase 7's plan, shared by both
    shards), with a ``RecordingSink``, an ``SloMonitor``, an ``EnergyMeter``
    and a ``CaptureSink`` armed, and its checks.  Returns what the kernels
    line reports of this path."""
    from collections import Counter

    from repro_torch.autotune import engine_from_plan
    from repro_torch.bench import capacity as capb
    from repro_torch.bench import gateway as gwb
    from repro_torch.core import energy_model as em
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.obs import (CaptureSink, EnergyMeter, RecordingSink, SloMonitor, TeeSink,
                                 assemble, attach_joules, reconcile)
    from repro_torch.workload import Trace, replay_trace

    t_phase = time.perf_counter()
    k = gwb.clock_scale(cfg)
    base = Trace.load(DIURNAL)
    trace = gwb.scaled_trace(base, k)
    check(all(r.deadline_cycles is not None for r in trace.requests)
          and [r.deadline_cycles for r in trace.requests]
          == [r.deadline_cycles * k for r in base.requests], "deadlines not scaled by k")
    # every cycle quantity of the traffic scales with k: the interactive
    # latency target (modeled ms) and the monitor's burn windows too
    specs = [dataclasses.replace(sp, latency_target_ms=sp.latency_target_ms * k)
             if sp.latency_target_ms is not None else sp for sp in capb.slo_specs()]
    windows = tuple(w * k for w in capb.WINDOWS)
    # pJ per worked cycle at the served schedules' widest budgets (the LM's
    # from_weights schedule, the U-Net plan's), as benchmarks/energy.py
    # prices its plans: the paper's FPGA energy model, not a card reading
    lm_planes, seg_planes = max(cfg.quant.plane_schedule), max(plan.planes)
    rates = {"lm": em.active_rate_pj(lm_planes), "seg": em.active_rate_pj(seg_planes)}
    rec, mon, meter, cap = RecordingSink(), SloMonitor(specs, windows=windows), \
        EnergyMeter(rates), CaptureSink()
    fab, mats = gwb.fabric(cfg, params, ucfg, uparams, plan, trace, device=dev,
                           sink=TeeSink([rec, mon, meter]))
    n = len(fab.shards)
    print(f"[fabric] {n} shards, router {fab.router}, steal {fab.steal}, seed {fab.seed}; "
          f"{base.name} x{k}: {len(trace)} requests "
          f"{dict(Counter(r.qos for r in trace.requests))}, round budget {fab.round_budget}, "
          f"span {trace.span_cycles} cycles, deadlines and the interactive latency target "
          f"({specs[0].latency_target_ms:.1f} modeled ms) x{k}; energy rates lm "
          f"{rates['lm']} pJ/cycle ({lm_planes} planes), seg {rates['seg']} ({seg_planes} planes)")
    lm_ads = [g.adapters["lm"] for g in fab.shards]
    seg_ads = [g.adapters["seg"] for g in fab.shards]
    leaves = [p["w_q"] for a in lm_ads for p in (a.engine.params["head"],
                                                  a.engine.params["blocks"]["mlp"]["w_up"])]
    check(len({t.data_ptr() for t in leaves}) == 2,
          "the shards' engines do not share one set of minitron_4b weights")
    for a in seg_ads:
        plan_fp, served_fp = a.verify_info()
        check(plan_fp == served_fp, f"the plan's fingerprint {plan_fp} != served {served_fp}")

    # per shard: decode calls counted, the first decode step's call recorded
    # (every scaled-kernel call it makes; recording adds no launch)
    scaled = ops.mma_matmul_scaled
    recs, saved = [], []
    for a in lm_ads:
        engine, r = a.engine, {"n": 0, "calls": [], "armed": False}
        decode, step = engine.decode_fn, engine.step

        def counted_decode(*args, r=r, decode=decode):
            r["n"] += 1
            if not r["armed"]:
                return decode(*args)
            r["armed"] = False

            def recording(x, w, xs, ws, **kw):
                out = scaled(x, w, xs, ws, **kw)
                r["calls"].append((x, w, xs, ws, kw["planes"], out))
                return out

            ops.mma_matmul_scaled = recording
            try:
                return decode(*args)
            finally:
                ops.mma_matmul_scaled = scaled

        def recording_step(only=None, r=r, step=step, engine=engine):
            if not r["calls"]:
                r["armed"] = True
                r["live_rows"] = len(engine.ready_slots())
            return step(only=only)

        saved.append((engine, decode, step))
        engine.decode_fn, engine.step = counted_decode, recording_step
        recs.append(r)
    mk.launches = mk.scaled_launches = 0
    t0 = time.perf_counter()
    try:
        summary = replay_trace(fab, trace, mats, max_rounds=10_000, capture=cap)
        torch.cuda.synchronize()
    finally:
        for engine, decode, step in saved:
            engine.decode_fn, engine.step = decode, step
    wall_s = time.perf_counter() - t0
    launches, unscaled = mk.scaled_launches, mk.launches
    calls = [r["n"] for r in recs]
    seg_batches = [sum(1 for e in rec.events if e.etype == "seg-batch" and e.data["shard"] == s)
                   for s in range(n)]

    # 1. every request served
    reqs = fab.requests
    check(len(reqs) == len(trace) and all(g.done for g in reqs),
          f"{sum(g.done for g in reqs)} of {len(trace)} requests completed")
    check(Counter(g.kind for g in reqs) == Counter(r.kind for r in trace.requests),
          "served kinds differ from the trace's")
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
    st = fab.stats()
    counts = {c: (pc["n"], pc["completed"]) for c, pc in st["per_class"].items()}
    want = Counter(r.qos for r in trace.requests)
    check(counts == {c: (m, m) for c, m in want.items()}, f"per-class counts {counts}")

    # 2. the fleet ledger, spans, SLO and picojoule accounts close
    add = fab.additivity()
    check(add["holds"], f"fleet ledger additivity: {add}")
    recon = reconcile(rec.events, [g.round_clock for g in fab.shards], ledger=fab.ledger)
    check(recon["holds"], f"exec events {recon['total_exec']} != worked {recon['total_worked']} "
          f"(ledger {recon.get('ledger_worked')})")
    spans = attach_joules(assemble(rec.events), meter)
    slo_rec = mon.reconcile(spans)
    check(slo_rec["holds"], f"SLO online/offline misses: {slo_rec}")
    e_rec = meter.reconcile(spans)
    check(e_rec["holds"], f"energy ledger: {e_rec['checks']}")
    check(sum(sp.pj for sp in spans if sp.done) == e_rec["spans"]["online_pj"],
          "span joules differ from the meter's attribution")
    for s, g in enumerate(fab.shards):
        sst = g.stats()
        check("slo" in sst and "energy" in sst and sst["slo"]["scope"] == s
              and sst["energy"]["scope"] == s, f"shard {s} stats lack its slo/energy blocks")
    check("slo" in st and "energy" in st and summary["energy"] == st["energy"],
          "the fleet stats lack the slo/energy blocks")
    misses = {q: c["deadline_misses"] for q, c in st["per_class"].items() if c["deadline_misses"]}
    check(misses == mon.miss_counts(), f"stats() misses {misses} != monitor "
          f"{mon.miss_counts()}")

    # 3. the captured trace is the replayed one
    back = cap.to_trace("captured", seed=trace.seed, meta=dict(trace.meta))
    key = lambda r: (r.kind, r.qos, r.arrival_cycle, dict(r.payload), r.deadline_cycles)
    check([key(r) for r in back.requests] == [key(r) for r in trace.requests],
          "the captured trace's requests differ from the replayed trace's")

    # 4. launches on this path
    per_call = 7 * cfg.n_layers + 1
    check(min(calls) > 0 and launches == per_call * sum(calls),
          f"{launches} scaled-kernel launches for {calls} decode calls, expected {per_call} each")
    check(min(seg_batches) > 0 and unscaled == 7 * sum(seg_batches),
          f"{unscaled} unscaled-kernel launches for {seg_batches} seg micro-batches (7 each, "
          f"none on the LM)")

    # 5. each shard's recorded decode call, per linear, bit for bit
    for s, r in enumerate(recs):
        check(len(r["calls"]) == per_call, f"shard {s}: {len(r['calls'])} scaled calls recorded")
        for x, w, xs, ws, planes, out in r["calls"]:
            kk, nn = w.shape
            x2 = x.reshape(-1, kk)
            check(x2.shape[0] == gwb.LM_BATCH, f"shard {s}: recorded call of {x2.shape[0]} rows")
            check(torch.equal(out.reshape(-1, nn),
                              mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)),
                  f"shard {s} recorded call: scaled linear K={kk} N={nn} != plain")

    # 6. every seg request's logits equal its image served alone
    n_seg = sum(1 for g in reqs if g.kind == "seg")
    for i, treq in enumerate(trace.requests):
        if treq.kind != "seg":
            continue
        g = next(g for g in reqs if g.kind == "seg" and g.arrival == treq.arrival_cycle)
        image, _ = mats["seg"](treq, trace.seed, i)
        alone = engine_from_plan(ucfg, uparams, plan, batch=gwb.SEG_BATCH,
                                 device=dev).run([image])[0]
        check(np.array_equal(alone.logits, g.handle.result.logits),
              f"seg request {g.rid}: logits differ from the image served alone")
        check((alone.cycles, alone.pj) == (g.handle.result.cycles, g.handle.result.pj),
              f"seg request {g.rid}: accounting differs from the image served alone")

    print(f"[fabric] {card} | replay of {base.name} (x{k}) through {n} shards: {len(reqs)} "
          f"requests, host wall {wall_s:.2f} s; decode calls per shard {calls} at M = "
          f"{gwb.LM_BATCH} ({launches} scaled launches, {per_call} per call), seg micro-batches "
          f"per shard {seg_batches} ({unscaled} unscaled launches, 7 each); {st['rounds']} "
          f"rounds, {st['forced']} forced, {len(rec)} events")
    print(f"[fabric] routes: dispatched per shard {st['dispatched']}, router {st['router_stats']};"
          f" steals {st['stolen']} (from {st['stolen_from']}, to {st['stolen_to']})")
    print(f"[fabric] each shard's recorded decode call (the first decode step; live rows "
          f"{[r['live_rows'] for r in recs]} of {gwb.LM_BATCH}): {per_call} scaled linears "
          f"bit-exact against the plain version; {n_seg} seg requests' logits "
          f"equal served alone; fleet additivity holds; exec events "
          f"{recon['total_exec']} cycles = worked {recon['total_worked']} = ledger; SLO misses "
          f"online {slo_rec['online']} = span-derived; pJ ledger holds "
          f"({e_rec['spans']['online_pj']} pJ attributed to completed requests); the captured "
          f"trace equals the replayed one")
    for c, pc in st["per_class"].items():
        sl = st["slo"]["per_class"].get(c, {})
        print(f"[fabric] class {c}: {pc['completed']} of {pc['n']} done, modeled latency p50 "
              f"{pc['p50_ms']:.3f} ms p99 {pc['p99_ms']:.3f} ms, deadline misses "
              f"{pc['deadline_misses']}, attribution {sl.get('attribution')} (relation (2) "
              f"clock, the paper's FPGA model)")
    eb = st["energy"]
    print(f"[fabric] metered {eb['metered_gops_w']:.4f} GOPS/W ({eb['total_mj']:.3f} mJ: active "
          f"{eb['active_mj']:.3f}, idle {eb['idle_mj']:.3f}), analytic {eb['analytic_gops_w']:.4f}"
          f" GOPS/W (both the paper's FPGA model at its modeled power, not the card)")
    phase_s = time.perf_counter() - t_phase
    print(f"[fabric] phase 10 took {phase_s:.1f} s")
    return dict(launches_fabric=launches, fabric_decode_calls=calls, fabric_wall_s=wall_s,
                fabric_seg_batches=seg_batches, fabric_rounds=st["rounds"],
                fabric_dispatched=st["dispatched"], fabric_stolen=st["stolen"],
                fabric_misses=misses, fabric_metered_gops_w=eb["metered_gops_w"],
                fabric_analytic_gops_w=eb["analytic_gops_w"], phase10_s=phase_s), \
        dict(launches_fabric=unscaled)


def _first_layers(tree, n: int):
    """The parameter tree with every stacked block leaf cut to its first
    ``n`` layers (views)."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def spec_decoding(torch, np, dev, card, cfg, params):
    """Phase 9: precision-speculative decoding at full width on phase 8's
    minitron_4b — ``tune_lm``, ``tune_spec``, serving through ``Gateway`` +
    ``SpecLMAdapter``, kernel-route identity (measured), Horner-route
    identity at a cut depth (gated), and the recorded draft and verify
    calls timed.  Returns what the kernels line reports of this path."""
    from collections import Counter

    from repro_torch import autotune
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.configs.base import QuantConfig
    from repro_torch.kernels import mma_matmul as mk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.core import energy_model as em
    from repro_torch.obs import (EnergyMeter, RecordingSink, TeeSink, assemble, attach_joules,
                                 reconcile)
    from repro_torch.serve import Engine, Gateway, Request, SpecEngine, SpecLMAdapter

    t_phase = time.perf_counter()
    per_call = 7 * cfg.n_layers + 1
    n_lin = 7 * cfg.n_layers
    rng = np.random.default_rng(0)

    # ---- 1. tune_lm (the Horner route, as the reference builds it)
    tokens = rng.integers(0, cfg.vocab, (1, SPEC_TUNE_TOKENS)).astype(np.int32)
    forward, n_fwd = transformer.forward, [0]

    def counted(*a, **kw):
        n_fwd[0] += 1
        return forward(*a, **kw)

    transformer.forward = counted
    mk.scaled_launches = 0
    try:
        t0 = time.perf_counter()
        plan = autotune.tune_lm(params, cfg, tokens, target_rel_err=SPEC_TARGET,
                                max_repair=SPEC_MAX_REPAIR, device=dev)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        transformer.forward = forward
    check(mk.scaled_launches == 0, f"tune_lm (Horner route) launched the scaled kernel "
          f"{mk.scaled_launches} times")
    cert = plan.certificate
    print(f"[spec] {card} | tune_lm target {SPEC_TARGET} on {tokens.size} tokens (seed 0), "
          f"max_repair {SPEC_MAX_REPAIR}: {n_fwd[0]} forwards, {cert['repairs']} repairs, "
          f"planes {list(plan.planes)}, measured_rel_err {cert['measured_rel_err']!r}, cert "
          f"{cert['cert']!r}, holds {cert['holds']}; {tune_s:.2f} s host wall (the plan's "
          f"two fingerprints, one pass over the weights, included)")
    check(cert["holds"] == (cert["cert"] <= plan.target_rel_err), f"holds disagrees: {cert}")

    def logits(schedule):
        qcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", planes=8, plane_schedule=schedule))
        return transformer.forward(params, tokens, qcfg, device=dev).to(torch.float32)

    ref = logits(None)
    again = float((logits(tuple(plan.planes)) - ref).abs().max()) / max(float(ref.abs().max()),
                                                                         1e-8)
    check(again == cert["measured_rel_err"],
          f"re-measured rel err {again!r} != tune_lm's {cert['measured_rel_err']!r}")
    print(f"[spec] re-measured with the same forward on the same tokens: {again!r} (equal to the "
          f"last bit)")

    # ---- 2. tune_spec on the kernel route
    prompts2 = [rng.integers(0, cfg.vocab, SPEC_PROMPT).astype(np.int32) for _ in range(2)]
    mk.scaled_launches = 0
    mk.scaled_variant_launches.clear()
    t0 = time.perf_counter()
    splan = autotune.tune_spec(params, cfg, prompts2, plan=plan, batch=2, max_seq=SPEC_MAX_SEQ,
                               max_new=SPEC_MAX_NEW, k_candidates=SPEC_K_GRID,
                               plane_candidates=SPEC_PLANE_GRID, device=dev)
    torch.cuda.synchronize()
    tspec_s = time.perf_counter() - t0
    tspec_calls, tspec_launches = mk.scaled_launches // per_call, mk.scaled_launches
    check(tspec_launches == per_call * tspec_calls and tspec_calls > 0,
          f"tune_spec: {tspec_launches} scaled launches, not {per_call} per decode call")
    check(all((p, True) in mk.scaled_variant_launches for p in SPEC_PLANE_GRID),
          f"tune_spec launched the kernel at {sorted(mk.scaled_variant_launches)}")
    spec_rec = splan.modeled["spec"]
    for g in spec_rec["grid"]:
        print(f"[spec] tune_spec grid: draft planes {g['planes']} k {g['k']}: cycles {g['cycles']}"
              f" emitted {g['emitted']} accepted {g['accepted']} drafted {g['drafted']} "
              f"(relation (2), the paper's FPGA model)")
    print(f"[spec] {card} | tune_spec: best draft planes {spec_rec['best']['planes']} k "
          f"{spec_rec['best']['k']}, modeled speedup {spec_rec['speedup']:.4f} (relation (2), the "
          f"paper's FPGA model, not a card number); {tspec_s:.2f} s host wall, {tspec_calls} "
          f"decode calls ({tspec_launches} scaled launches)")

    # ---- 3. serve through the gateway: the spec main path
    prompts = [rng.integers(0, cfg.vocab, SPEC_PROMPT).astype(np.int32)
               for _ in range(SPEC_BATCH)]
    draft_planes = splan.spec_planes[0]
    sink = RecordingSink()
    # the meter prices verify work at the plan's widest budget and draft work
    # at the draft budget (the paper's FPGA energy model, not a card reading)
    meter = EnergyMeter({"lm": em.active_rate_pj(max(plan.planes))},
                        draft_rates={"lm": em.active_rate_pj(draft_planes)})
    adapter = SpecLMAdapter(cfg, params, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, plan=splan,
                            device=dev)
    budget = 2 * SPEC_BATCH * adapter._spec_slot_cycles(splan.spec_k)
    gw = Gateway([adapter], policy="fair", round_budget=budget, sink=TeeSink([sink, meter]))
    engine = adapter.engine
    rec = {"draft": [], "verify": [], "n_draft": 0, "n_decode": 0, "in_round": False}
    draft_fn, decode_fn, spec_step = engine.draft_fn, engine.decode_fn, engine.spec_step
    scaled = ops.mma_matmul_scaled

    def recorded(fn, into, *args):
        """``fn(*args)`` with every scaled-kernel call recorded into
        ``into``.  Recording adds no launch."""
        def recording(x, w, xs, ws, **kw):
            out = scaled(x, w, xs, ws, **kw)
            into.append((x, w, xs, ws, kw["planes"], out))
            return out

        ops.mma_matmul_scaled = recording
        try:
            return fn(*args)
        finally:
            ops.mma_matmul_scaled = scaled

    def counted_draft(*args):
        rec["n_draft"] += 1
        if rec["draft"]:
            return draft_fn(*args)
        return recorded(draft_fn, rec["draft"], *args)

    def counted_decode(*args):
        rec["n_decode"] += 1
        if rec["verify"] or not rec["in_round"]:
            return decode_fn(*args)
        return recorded(decode_fn, rec["verify"], *args)

    def marked_spec_step(only=None):
        rec["in_round"] = True
        try:
            return spec_step(only=only)
        finally:
            rec["in_round"] = False

    engine.draft_fn, engine.decode_fn, engine.spec_step = counted_draft, counted_decode, \
        marked_spec_step
    # the first submission hashes the served weights (params_fingerprint) and
    # refuses the plan unless they are the ones it was tuned on
    t0 = time.perf_counter()
    reqs = [gw.submit("lm", p, max_new=SPEC_MAX_NEW) for p in prompts]
    submit_s = time.perf_counter() - t0
    mk.scaled_launches = 0
    mk.scaled_variant_launches.clear()
    t0 = time.perf_counter()
    gw.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, by_planes = mk.scaled_launches, Counter(mk.scaled_variant_launches)
    check(all(r.done and len(r.handle.out) == SPEC_MAX_NEW
              and all(0 <= t < cfg.vocab for t in r.handle.out) for r in reqs),
          "a spec request did not complete with its budget in the vocabulary")
    n_draft, n_decode = rec["n_draft"], rec["n_decode"]
    check(launches == per_call * (n_draft + n_decode),
          f"{launches} scaled launches for {n_draft} draft and {n_decode} other decode calls, "
          f"expected {per_call} each")
    want = Counter({(draft_planes, True): n_lin * n_draft, (8, True): n_draft + n_decode})
    for p in plan.planes:
        want[(p, True)] += 7 * n_decode
    check(by_planes == want, f"launches by planes {dict(by_planes)}, expected {dict(want)}")
    for name, calls, planes in (("draft", rec["draft"], (draft_planes,) * cfg.n_layers),
                                ("verify", rec["verify"], tuple(plan.planes))):
        check(len(calls) == per_call, f"{len(calls)} scaled calls recorded in the {name} call")
        check([p for *_, p, _ in calls] == [p for p in planes for _ in range(7)] + [8],
              f"the {name} call's linears ran at planes {[p for *_, p, _ in calls]}")
        for x, w, xs, ws, p, out in calls:
            x2 = x.reshape(-1, w.shape[0])
            check(torch.equal(out.reshape(-1, w.shape[1]),
                              mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=p)),
                  f"recorded {name} call: scaled linear K={w.shape[0]} N={w.shape[1]} != plain")
    recon = reconcile(sink.events, [gw.round_clock])
    check(recon["holds"], f"exec events {recon['total_exec']} != worked {recon['total_worked']}")
    etypes = Counter(e.etype for e in sink.events)
    check(all(etypes[e] for e in ("draft", "verify", "accept")), f"spec events {dict(etypes)}")
    # the spec energy account closes: useful + wasted pJ = draft + verify pJ,
    # and the slot-level cycles re-derive the round-level ones
    e_rec = meter.reconcile(attach_joules(assemble(sink.events), meter))
    e_spec = meter.spec_summary()
    check(e_spec is not None and e_spec["useful_pj"] + e_spec["wasted_pj"]
          == e_spec["draft_pj"] + e_spec["verify_pj"], f"spec pJ account: {e_spec}")
    check(e_rec["holds"] and all(v["cycles_close"] and v["pj_close"]
                                 for v in e_rec["spec"].values()),
          f"energy ledger: {e_rec['checks']}, spec {e_rec['spec']}")
    check("energy" in gw.stats(), "the spec gateway's stats lack the energy block")
    rounds = [e.data for e in sink.events if e.etype == "lm-spec"]
    print(f"[spec] {card} | Gateway(fair) + SpecLMAdapter (draft planes {draft_planes}, k "
          f"{splan.spec_k}, verify planes {list(plan.planes)}): {len(reqs)} requests, "
          f"{gw.rounds} rounds, {len(rounds)} spec rounds; {n_draft} draft calls + {n_decode} "
          f"prefill/verify calls, {launches} scaled launches ({per_call} per call; by (planes, "
          f"signed) {dict(sorted(by_planes.items()))}); {serve_s:.2f} s host wall; submitting, "
          f"params_fingerprint of the served weights included: {submit_s:.2f} s")
    print(f"[spec] energy (the paper's FPGA model): draft {e_spec['draft_pj']} pJ over "
          f"{e_spec['draft_cycles']} cycles at {draft_planes} planes, verify {e_spec['verify_pj']} "
          f"pJ over {e_spec['verify_cycles']} cycles; useful {e_spec['useful_pj']} + wasted "
          f"{e_spec['wasted_pj']} = draft + verify; slot-level cycles = round-level; "
          f"{e_spec['accepted']} of {e_spec['drafted']} drafts accepted")
    print(f"[spec] recorded draft and verify calls: {per_call} scaled linears each bit-exact "
          f"against the plain version; exec cycles {recon['total_exec']} = worked "
          f"{recon['total_worked']}; events draft {etypes['draft']} verify {etypes['verify']} "
          f"accept {etypes['accept']} rollback {etypes['rollback']}")
    engine.draft_fn, engine.decode_fn, engine.spec_step = draft_fn, decode_fn, spec_step
    del gw, adapter, engine

    # ---- 4. identity on the kernel route, measured and not gated
    qcfg = autotune.apply_plan_lm(cfg, splan)

    def serve(qc, prm, spec, k, draft):
        eng = (SpecEngine(qc, prm, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, draft_schedule=draft,
                          k=k, device=dev) if spec
               else Engine(qc, prm, batch=SPEC_BATCH, max_seq=SPEC_MAX_SEQ, device=dev))
        reqs = [Request(i, p, max_new=SPEC_MAX_NEW) for i, p in enumerate(prompts)]
        mk.scaled_launches = 0
        t0 = time.perf_counter()
        for r in reqs:
            check(eng.admit(r), "a slot was refused")
        while eng.ready_slots():
            eng.spec_step() if spec else eng.step()
        torch.cuda.synchronize()
        return eng, [list(r.out) for r in reqs], time.perf_counter() - t0, mk.scaled_launches

    _, gstreams, g_s, g_l = serve(qcfg, params, False, splan.spec_k, splan.spec_planes)
    emitted = SPEC_BATCH * SPEC_MAX_NEW
    print(f"[spec] {card} | greedy Engine: {g_s:.2f} s host wall, {g_l // per_call} decode "
          f"calls, {g_s / emitted * 1e3:.1f} ms per emitted token")
    tuned = splan.spec_planes[0]
    identity = {}
    # the tuned draft budget first, then the grid's others: a budget whose
    # drafts are accepted by some slots and not others is where one
    # activation scale per tensor can couple the slots
    for dp in [tuned] + [p for p in SPEC_PLANE_GRID if p != tuned]:
        seng, sstreams, s_s, s_l = serve(qcfg, params, True, splan.spec_k,
                                         (dp,) * cfg.n_layers)
        same = sum(a == b for a, b in zip(gstreams, sstreams))
        parts = [next(j for j, (a, b) in enumerate(zip(g, s)) if a != b)
                 for g, s in zip(gstreams, sstreams) if g != s]
        drafted = sum(r["drafted"] for r in seng.spec_trace)
        accepted = [sum(sl["accepted"] for r in seng.spec_trace for sl in r["slots"]
                        if sl["rid"] == i) for i in range(SPEC_BATCH)]
        identity[dp] = dict(identical=same, parts=parts, accepted=sum(accepted),
                            drafted=drafted, wall_s=s_s, calls=s_l // per_call)
        print(f"[spec] {card} | kernel route identity at draft planes {dp}, k {splan.spec_k} "
              f"(measured, not gated): {same} of {SPEC_BATCH} streams identical to greedy; the "
              f"others part at positions {parts}; accepted {sum(accepted)} of {drafted} drafts "
              f"(by request {accepted}) | SpecEngine: {s_s:.2f} s host wall, {s_l // per_call} "
              f"decode calls, {s_s / emitted * 1e3:.1f} ms per emitted token")
    same, parts = identity[tuned]["identical"], identity[tuned]["parts"]
    drafted, s_s = identity[tuned]["drafted"], identity[tuned]["wall_s"]
    accept = identity[tuned]["accepted"] / drafted if drafted else 0.0

    # ---- 5. identity on the Horner route (per-row scales), gated, at a cut depth
    hl = SPEC_HORNER_LAYERS
    hparams = dict(params, blocks=_first_layers(params["blocks"], hl))
    hcfg = cfg.replace(n_layers=hl, quant=QuantConfig(mode="mma_int8", impl="horner",
                                                      plane_schedule=tuple(plan.planes[:hl])))
    t0 = time.perf_counter()
    (geng, gh, _, gl), (heng, sh, _, sl) = [serve(hcfg, hparams, spec, 2, (2,) * hl)
                                            for spec in (False, True)]
    horner_s = time.perf_counter() - t0
    check(gl == sl == 0, "the Horner route launched the scaled kernel")
    check(sh == gh, f"Horner route: spec streams {sh} != greedy {gh}")
    check(np.array_equal(heng.lengths, geng.lengths), "Horner route: lengths differ")
    for i, n in enumerate(geng.lengths):
        for key in ("k", "v"):
            check(torch.equal(heng.cache[key][:, i, :n], geng.cache[key][:, i, :n]),
                  f"Horner route: slot {i}'s live {key} cache rows differ from greedy's")
    hdrafted = sum(r["drafted"] for r in heng.spec_trace)
    haccepted = sum(r["accepted"] for r in heng.spec_trace)
    print(f"[spec] {card} | Horner route identity at {hl} of {cfg.n_layers} layers (full width; "
          f"draft 2 planes, k 2): {SPEC_BATCH} streams equal greedy token for token, lengths "
          f"and live cache rows bit for bit; accepted {haccepted} of {hdrafted}; "
          f"{horner_s:.2f} s host wall")
    del geng, heng, hparams

    # ---- 6. the recorded draft and verify calls timed (CUDA-graph replays, w cold)
    times = {}
    for name in ("draft", "verify"):
        calls = [(x.reshape(-1, w.shape[0]), w, xs, ws, p) for x, w, xs, ws, p, _ in rec[name]]
        ms = graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                      for x, w, xs, ws, p in calls], calls=1)
        libs = [scaled_library(torch, *c) for c in calls]
        lib_ms = graph_ms(torch, lambda: [f() for f in libs], calls=1)
        plain_ms = time_ms(torch, lambda: [mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=p)
                                           for x, w, xs, ws, p in calls], reps=1, warmup=1)
        m = calls[0][0].shape[0]
        b_ms, b_by, nbytes, nops = scaled_bound([(x.shape[0], *w.shape) for x, w, *_ in calls])
        times[name] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, M=m)
        print(f"[time] {card} | mma_matmul_scaled one minitron_4b {name} call at M = {m} "
              f"({len(calls)} linears at planes {sorted(set(p for *_, p in calls))}, one CUDA "
              f"graph, {nbytes / 1e9:.3f} GB of distinct w: cold): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch._int_mm+scale {lib_ms:.4f} ms (32 rows), bound "
              f"{b_ms:.4f} ms ({b_by}), {nbytes / ms / 1e6:.0f} GB/s")
    phase_s = time.perf_counter() - t_phase
    print(f"[spec] phase 9 took {phase_s:.1f} s")
    return dict(
        launches_spec=launches,
        launches_spec_by_planes={f"{p}{'' if sg else 'u'}": n for (p, sg), n in
                                 sorted(by_planes.items())},
        spec_draft_calls=n_draft, spec_other_calls=n_decode, spec_serve_wall_s=serve_s,
        spec_submit_s=submit_s, spec_tune_lm_s=tune_s, spec_tune_lm_planes=list(plan.planes),
        spec_tune_lm_holds=cert["holds"], spec_tune_spec_s=tspec_s,
        spec_tune_spec_calls=tspec_calls, spec_best=spec_rec["best"],
        spec_kernel_identical=same, spec_kernel_parts=parts, spec_accept_rate=accept,
        spec_kernel_identity_by_draft_planes=identity,
        spec_greedy_wall_s=g_s, spec_wall_s=s_s, spec_draft_call=times["draft"],
        spec_verify_call=times["verify"], spec_energy=e_spec, phase9_s=phase_s,
    )


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


def cold_shape_times(torch, dev, g, m, k, n, planes):
    """The scaled kernel on one (m, k) @ (k, n) shape with w cold in L2, from
    CUDA-graph replays: a graph of calls cycling through enough copies of w
    that it never finds one in L2.  Returns the kernel's ms at each of
    ``planes``, ``torch._int_mm`` + scale's ms (at ``planes[0]``, checked
    equal to the kernel's output first), the plain version's ms, and the
    copies and calls per graph."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    def rotating(fns):
        """One call per graph slot, cycling through ``fns``."""
        it = itertools.cycle(fns)
        return lambda: next(it)()

    copies = -(-2 * L2_BYTES // (k * n))
    calls = max(20, copies)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
    ws_ = [torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
           for _ in range(copies)]
    xs = torch.full((1,), 0.01, device=dev)
    wsc = torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4
    libs = [scaled_library(torch, x, w, xs, wsc, planes[0]) for w in ws_]
    check(torch.equal(libs[0](), mk.mma_matmul_scaled_kernel(x, ws_[0], xs, wsc,
                                                            planes=planes[0])),
          f"M={m} K={k} N={n}: library yardstick disagrees with the scaled kernel")
    ms_planes = {p: graph_ms(torch, rotating([
        lambda w=w, p=p: mk.mma_matmul_scaled_kernel(x, w, xs, wsc, planes=p) for w in ws_]),
        calls=calls) for p in planes}
    lib_ms = graph_ms(torch, rotating(libs), calls=calls)
    plain_ms = time_ms(torch, lambda: mk.mma_matmul_scaled_plain(x, ws_[0], xs, wsc,
                                                                 planes=planes[0]),
                       reps=3, warmup=1)
    return ms_planes, lib_ms, plain_ms, copies, calls


def lm_times(torch, dev, card, lm, decode_shapes):
    """The scaled kernel's times, from CUDA-graph replays: per decode shape
    at 8, 5 and 1 planes with w cold in L2, and per decode call, replaying
    the recorded call's 225 kernel calls."""
    from repro_torch.bench.table1 import graph_ms
    from repro_torch.kernels import mma_matmul as mk

    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    for name, k, n in decode_shapes:
        m = LM_BATCH
        ms_planes, lib_ms, plain_ms, copies, calls = cold_shape_times(torch, dev, g, m, k, n,
                                                                      (8, 5, 1))
        ms = ms_planes[8]
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
    # the CUDA-core scaled kernel that the scaled kernel's rows above 16
    # ran on before it covered every M: gone from the library
    check(b"mma_horner_kernel" not in lib.read_bytes(), "mma_horner_kernel is in the library")
    imma = {}
    # (kernel, instantiations): the unscaled kernel's (planes, signed, block
    # rows) and the scaled kernel's (planes, signed, NF 1-4)
    for kernel, n_inst in (("mma_tc_horner_kernel", 32), ("mma_tc_scaled_kernel", 64)):
        counts = imma_count(lib, kernel)
        if counts is None:
            print("[sass] no cuobjdump in the toolkit: IMMA count not taken")
            break
        check(len(counts) == n_inst and min(counts.values()) > 0,
              f"{kernel}: IMMA instructions per instantiation: {sorted(counts.values())}")
        imma[kernel] = sum(counts.values())
        print(f"[sass] {kernel}: {len(counts)} instantiations, IMMA instructions "
              f"{imma[kernel]} in all, {min(counts.values())}..{max(counts.values())} each")
        if kernel == "mma_tc_scaled_kernel":
            # NF, the last template argument, in the mangled or the demangled name
            nf_of = {name: re.search(r"mma_tc_scaled_kernel(?:ILi\d+ELb[01]ELi(\d)E|"
                                     r"<\d+, (?:true|false), (\d)>)", name) for name in counts}
            by_nf = {nf: sorted(c for name, c in counts.items()
                                if nf_of[name] and str(nf) in nf_of[name].groups())
                     for nf in range(1, 5)}
            check(all(len(c) == 16 for c in by_nf.values()), f"instantiations by NF: {by_nf}")
            print("[sass] mma_tc_scaled_kernel IMMA by NF (16 instantiations each): " + ", ".join(
                f"NF {nf} {c[0]}..{c[-1]}" for nf, c in by_nf.items()))

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
    n_decode, n_wide = decode_cases(torch, dev)
    print(f"[kernel] mma_matmul: {n_cases} cases bit-exact against the plain version, "
          f"max_abs_err {max_err}")
    print(f"[kernel] mma_matmul_scaled: {n_scaled} cases plus {n_decode} decode cases (M <= 16) "
          f"and {n_wide} above 16 rows bit-exact against the plain version, max_abs_err "
          f"{scaled_err}")

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
    scaled_summary["imma"] = imma.get("mma_tc_scaled_kernel")
    del lm  # the recorded calls hold Yi-6B's weights
    torch.cuda.empty_cache()

    # ------------------------------------------------ 7. certified tuning
    tuning, plan = certified_tuning(torch, np, card, cfg, params, images)
    summary.update(tuning)

    # ------------------------------------------------- 8. the gateway
    scaled_gw, unscaled_gw, (lm_cfg, lm_params) = gateway_replay(torch, np, dev, card, cfg,
                                                                  params, plan)
    scaled_summary.update(scaled_gw)
    summary.update(unscaled_gw)

    # --------------------------------------- 9. speculative decoding
    mk.launches = 0
    scaled_summary.update(spec_decoding(torch, np, dev, card, lm_cfg, lm_params))
    check(mk.launches == 0, f"phase 9 launched the unscaled kernel {mk.launches} times")

    # -------------------------------------------- 10. the serving fabric
    scaled_fab, unscaled_fab = fabric_replay(torch, np, dev, card, cfg, params, plan, lm_cfg,
                                             lm_params)
    scaled_summary.update(scaled_fab)
    summary.update(unscaled_fab)
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": [summary, scaled_summary]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
