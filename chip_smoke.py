#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in one process; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel from the checkout's sources, with ``-Xptxas -v``.
2. Kernel vs plain version: the CUDA MMA kernel against its plain PyTorch
   version on the card, bit for bit (``torch.equal``), on the reference's
   kernel sweep, every (planes, signed) variant, and the main path's layer
   shapes.
3. Forward: the full-width quantized U-Net (80x80x4, base 48, depth 3)
   under uniform 8 planes and a ``from_weights(0.05)`` schedule — the kernel
   path against the plain Horner path, every conv's int32 output equal; and
   the card against the CPU on a small input.
4. Serving (the main path): ``SegEngine`` at full width with the
   ``from_weights`` schedule and content-adaptive budget classes serves four
   phantom images through ``run()`` and once through ``serve_stream()``.
   Kernel launches must equal 7 per micro-batch; logits must match the same
   engine on the plain path.
5. Times: the kernel at each layer shape of a 4-tile micro-batch (CUDA
   events), its plain version, ``torch._int_mm`` as a library yardstick
   (timed only; the port never calls it), and the card's bound.

The line before the last is a JSON object naming every kernel with its
launches on the main path and its times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet, dense: HBM rate and the int8 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

TILES_PER_BATCH = 4  # the engine's micro-batch
SWEEP = [(4, 32, 8), (32, 128, 32), (128, 512, 128), (37, 100, 65),
         (1, 7, 3), (256, 1024, 256), (64, 300, 90)]

# Logits of the kernel path and the plain path go through the same float
# head on bitwise-equal conv outputs: equal up to the card's reduction order.
LOGIT_ATOL = 1e-5
# The card against the CPU: same integers, float head summed in another order.
CPU_LOGIT_ATOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def main() -> int:
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

    # ------------------------------------------- 2. kernel vs plain version
    cfg = unet.UNetConfig(quant_mode="mma_int8")  # calibrated width, kernel datapath
    # the KPB matmul of each 3x3 conv at one 80x80 window: (name, M, K, N)
    names = ([f"enc{d}" for d in range(cfg.depth)] + ["bottleneck"]
             + [f"dec{d}" for d in reversed(range(cfg.depth))])
    layers = [(nm, c.out_h * c.out_w, c.k * c.k * c.cin, c.cout)
              for nm, c in zip(names, cfg.conv_layers())]
    g = torch.Generator().manual_seed(0)
    max_err = 0
    n_cases = 0

    def compare(m, k, n, planes, signed=True):
        nonlocal max_err, n_cases
        x, w = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        got = mk.mma_matmul_kernel(x, w, planes=planes, signed=signed)
        want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_cases += 1
        check(torch.equal(got, want),
              f"kernel != plain at M={m} K={k} N={n} planes={planes} signed={signed}")

    for m, k, n in SWEEP:
        for planes in (8, 5, 2):
            compare(m, k, n, planes)
    for planes in range(1, 9):
        for signed in (True, False):
            compare(67, 129, 70, planes, signed)
    for _, m, k, n in layers:
        compare(m * TILES_PER_BATCH, k, n, 8)
        compare(m * TILES_PER_BATCH, k, n, 5)
    print(f"[kernel] {n_cases} cases bit-exact against the plain version, max_abs_err {max_err}")

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

    # ---------------------------------------------- 4. serving (main path)
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

    # ---------------------------------------------------------- 5. times
    per_shape = []
    for name, m1, k, n in layers:
        m = m1 * TILES_PER_BATCH
        x8, w8 = rand_i8(torch, g, (m, k), dev), rand_i8(torch, g, (k, n), dev)
        ms = time_ms(torch, lambda: mk.mma_matmul_kernel(x8, w8, planes=8), reps=20)
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
        lib_ms = time_ms(torch, lambda: torch._int_mm(xl, wl), reps=20)
        nbytes = m * k + k * n + 4 * m * n
        nops = 2 * m * k * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_OPS_PER_S * 1e3
        row = dict(name=name, M=m, K=k, N=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, ops=nops)
        per_shape.append(row)
        print(f"[time] {card} | mma_matmul {name} M={m} K={k} N={n} planes=8: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), {nops / ms / 1e9:.1f} GOP/s")

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
        per_shape=per_shape,
    )
    print(f"[time] {card} | mma_matmul one 4-tile forward: kernel {summary['ms']:.4f} ms, "
          f"plain {summary['plain_ms']:.4f} ms, torch._int_mm {summary['library_ms']:.4f} ms, "
          f"bound {summary['bound_ms']:.5f} ms ({summary['bound_by']})")
    print(json.dumps({"kernels": [summary]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
