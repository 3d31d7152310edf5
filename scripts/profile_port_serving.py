#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 scripts/profile_port_serving.py          # segmentation (U-Net)
    python3 scripts/profile_port_serving.py --plan   # segmentation, tuned plan
    python3 scripts/profile_port_serving.py --lm     # LM decode (Yi-6B)
    python3 scripts/profile_port_serving.py --gateway  # the gateway replay
    python3 scripts/profile_port_serving.py --fabric   # the 2-shard fabric replay
    python3 scripts/profile_port_serving.py --moe      # MoE decode (OLMoE-1B-7B)
    python3 scripts/profile_port_serving.py --rwkv6    # recurrent decode (RWKV6-3B)
    python3 scripts/profile_port_serving.py --zamba2   # hybrid decode (Zamba2-7B)
    python3 scripts/profile_port_serving.py --whisper  # encoder-decoder (Whisper-large-v3)

Default: serves the four phantom images of ``chip_smoke.py`` through the
full-width ``SegEngine`` (calibrated U-Net, ``from_weights(0.05)``
schedule, adaptive budget classes).  ``--plan``: first tunes a plan as
``chip_smoke.py`` phase 7 does (``tune_unet`` at target 0.05 on two
phantom calibration images, not profiled), then serves the same four
images through ``engine_from_plan`` (per-tile activation scales).
``--lm``: serves ``chip_smoke.py``'s four requests through ``Engine.run``
on Yi-6B at full width (random int8 weights from seed 0,
``lm_schedule_from_params(0.05)``: the ``w_up`` weights, batch 4).
``--gateway``: tunes the plan as ``--plan`` does, then replays
``traces/gateway_burst.json`` through the gateway as ``chip_smoke.py``
phase 8 does (minitron_4b at full width, batch 20; the U-Net under the
plan; the trace's clock scaled, ``repro_torch.bench.gateway``); its warm-up
replays the trace's first LM and first seg request only, and it records
device activity only (a replay issues millions of host ops).  ``--fabric``:
the same, for ``chip_smoke.py`` phase 10: ``traces/diurnal_smoke.json``
(clock and deadlines scaled) through a 2-shard ``Fabric`` of those gateways
(``deficit`` routing, stealing on, one set of weights shared), with a
``RecordingSink``, ``SloMonitor`` and ``EnergyMeter`` teed.  ``--moe``:
``chip_smoke.py`` phase 11's four requests through ``Engine.run`` on
OLMoE-1B-7B at full width (random weights from seed 0, attention and head
int8, experts bf16, ``lm_schedule_from_params(0.05)``, batch 4), each MoE
block inside a ``moe_ffn`` profiler range, whose device time (the kernels
its ops launch) is reported beside the scaled kernel's.  ``--rwkv6`` and
``--zamba2``: ``chip_smoke.py`` phases 12 and 13, the same four requests
through ``Engine.run`` on RWKV6-3B and Zamba2-7B at full width (random int8
weights from seed 0, 5 planes, batch 4), the recurrence's stock ops inside
profiler ranges (``wkv``: the WKV loop; ``ssd_step``: the SSD state
update; ``_short_conv``: the short conv), whose device time is reported
beside the kernels'.  ``--whisper``: ``chip_smoke.py`` phase 14, Whisper-large-v3
at full width (random int8 weights from seed 0, 5 planes): the encoder over
four rows of 1500 frames, an ``Engine`` (batch 4) that projects the cross
K/V once, and the four requests through ``Engine.run``; ``encode``,
``precompute_cross_kv``, ``Engine.run`` and each cross-attention
(``_cross_attend``: its q/o projections and the attention over 1500 keys)
in profiler ranges, each range's host wall and device time reported.
Each other
mode runs its serving pass once to warm up.  Then the pass runs once under
``torch.profiler``, and the script prints: host wall time, device busy time
(the union of kernel and copy intervals on the card) and idle share, device
time by kernel name, and the MMA kernels' launches.  The last line is a
JSON summary.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _unet_run():
    """The segmentation serving pass: a callable and its description."""
    from repro_torch.models import unet
    from repro_torch.segserve import SegEngine
    from repro_torch.segserve.synth import phantom_image

    cfg = unet.UNetConfig(quant_mode="mma_int8")
    params = unet.init_params(0, cfg)
    sched = unet.schedule_from_params(params, 0.05)
    scfg = dataclasses.replace(cfg, plane_schedule=sched.planes)
    images = [phantom_image(160, 128, cfg.in_ch, seed=0), phantom_image(160, 128, cfg.in_ch, seed=1),
              phantom_image(80, 80, cfg.in_ch), phantom_image(200, 152, cfg.in_ch)]
    return (lambda: SegEngine(scfg, params).run(images)), "SegEngine.run() of 4 images"


def _plan_run():
    """Serving a tuned plan: a callable and its description."""
    from repro_torch import autotune
    from repro_torch.models import unet
    from repro_torch.segserve.synth import phantom_image

    cfg = unet.UNetConfig(quant_mode="mma_int8")
    params = unet.init_params(0, cfg)
    calib = [phantom_image(160, 128, cfg.in_ch, seed=s) for s in (0, 1)]
    plan = autotune.tune_unet(params, cfg, calib, target_rel_err=0.05)
    images = [phantom_image(160, 128, cfg.in_ch, seed=0), phantom_image(160, 128, cfg.in_ch, seed=1),
              phantom_image(80, 80, cfg.in_ch), phantom_image(200, 152, cfg.in_ch)]
    return ((lambda: autotune.engine_from_plan(cfg, params, plan).run(images)),
            f"engine_from_plan run() of 4 images, {plan.describe()}")


def _lm_run(name="yi_6b", label="Yi-6B"):
    """LM decode serving (``chip_smoke.py``'s requests, phase 5 on Yi-6B or
    phase 11 on OLMoE-1B-7B): a callable and its description."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import transformer
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.engine import lm_schedule_from_params

    cfg = get_config(name)
    params = transformer.init_params(0, cfg, int8_min_dim=256)
    sched = lm_schedule_from_params(params, cfg, 0.05)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", plane_schedule=sched.planes))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(4, 9, 4)]

    def serve():
        reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
        return Engine(kcfg, params, batch=4, max_seq=64).run(reqs)

    calls = sum(len(p) for p in prompts) + 4
    return serve, f"Engine.run() of 4 {label} requests ({calls} decode calls)"


def _recurrent_run(name, label):
    """Recurrent decode serving (``chip_smoke.py`` phases 12-13): a callable
    and its description."""
    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.serve import Engine, Request

    cfg = get_config(name)
    params = models.build(cfg).init_params(0, cfg, int8_min_dim=256)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=5))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(4, 9, 4)]

    def serve():
        reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
        return Engine(kcfg, params, batch=4, max_seq=64).run(reqs)

    calls = sum(len(p) for p in prompts) + 4
    return serve, f"Engine.run() of 4 {label} requests ({calls} decode calls)"


def _whisper_run():
    """Encoder-decoder serving (``chip_smoke.py`` phase 14): a callable and
    its description."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.models import whisper
    from repro_torch.serve import Engine, Request

    cfg = get_config("whisper_large_v3")
    params = whisper.init_params(0, cfg, int8_min_dim=256)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=5))
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, cfg.enc_seq, cfg.d_model)).astype(np.float32)).cuda().to(torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(4, 9, 4)]

    def serve():
        memory = whisper.encode(params, frames, kcfg)
        engine = Engine(kcfg, params, batch=4, max_seq=64, extras={"memory": memory})
        with torch.profiler.record_function("Engine.run"):
            return engine.run([Request(i, p, max_new=4) for i, p in enumerate(prompts)])

    calls = sum(len(p) for p in prompts) + 4
    return serve, (f"Whisper-large-v3: encode 4 x {cfg.enc_seq} frames, project the cross K/V, "
                   f"Engine.run() of 4 requests ({calls} decode calls)")


#: The profiler ranges of each mode: (module, function) pairs.
RANGES = {"moe": [("moe", "moe_ffn")], "rwkv6": [("rwkv6", "wkv")],
          "zamba2": [("mamba2", "ssd_step"), ("mamba2", "_short_conv")],
          "whisper": [("whisper", "encode"), ("whisper", "precompute_cross_kv"),
                      ("whisper", "_cross_attend")]}
#: Ranges a mode's serving callable opens itself.
OWN_RANGES = {"whisper": ["Engine.run"]}


def _ranged(module, name: str) -> None:
    """Wrap ``module.name`` in a profiler range of that name."""
    import torch

    inner = getattr(module, name)

    def ranged(*a, **kw):
        with torch.profiler.record_function(name):
            return inner(*a, **kw)

    setattr(module, name, ranged)


def _range_kernels(events, name: str) -> tuple[dict[str, list[float]], float]:
    """Device kernels launched inside every ``name`` range: (count, ms) by
    kernel name, and the ranges' host wall in ms."""
    from torch.autograd import DeviceType

    out: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])

    def walk(evt):
        for k in evt.kernels:
            out[k.name][0] += 1
            out[k.name][1] += k.duration / 1e3
        for ch in evt.cpu_children:
            walk(ch)

    wall_ms = 0.0
    for evt in events:
        if evt.name == name and evt.device_type == DeviceType.CPU:
            walk(evt)
            wall_ms += (evt.time_range.end - evt.time_range.start) / 1e3
    return out, wall_ms


def _gateway_run():
    """The gateway replay of ``chip_smoke.py`` phase 8: a callable, its
    description and a short warm-up."""
    from repro_torch import autotune
    from repro_torch.bench import gateway as gwb
    from repro_torch.models import unet
    from repro_torch.segserve.synth import phantom_image
    from repro_torch.workload import Trace, replay_trace

    cfg = unet.UNetConfig(quant_mode="mma_int8")
    params = unet.init_params(0, cfg)
    calib = [phantom_image(160, 128, cfg.in_ch, seed=s) for s in (0, 1)]
    plan = autotune.tune_unet(params, cfg, calib, target_rel_err=0.05)
    lm_cfg, lm_params, _ = gwb.minitron()
    k = gwb.clock_scale(lm_cfg)
    trace = gwb.scaled_trace(Trace.load(Path(__file__).resolve().parents[1] / "traces"
                                        / "gateway_burst.json"), k)
    first = [next(r for r in trace.requests if r.kind == kind) for kind in ("lm", "seg")]
    warm_trace = dataclasses.replace(trace, requests=tuple(first))

    def serve(t=trace):
        gw, mats = gwb.build(lm_cfg, lm_params, cfg, params, plan, t)
        return replay_trace(gw, t, mats, max_rounds=10_000)

    return serve, (f"Gateway replay of {trace.name} ({len(trace)} requests; minitron_4b batch "
                   f"{gwb.LM_BATCH}, U-Net under {plan.describe()})"), \
        lambda: serve(warm_trace)


def _fabric_run():
    """The fabric replay of ``chip_smoke.py`` phase 10: a callable, its
    description and a short warm-up."""
    from repro_torch import autotune
    from repro_torch.bench import capacity as capb
    from repro_torch.bench import gateway as gwb
    from repro_torch.core import energy_model as em
    from repro_torch.models import unet
    from repro_torch.obs import EnergyMeter, RecordingSink, SloMonitor, TeeSink
    from repro_torch.segserve.synth import phantom_image
    from repro_torch.workload import Trace, replay_trace

    cfg = unet.UNetConfig(quant_mode="mma_int8")
    params = unet.init_params(0, cfg)
    calib = [phantom_image(160, 128, cfg.in_ch, seed=s) for s in (0, 1)]
    plan = autotune.tune_unet(params, cfg, calib, target_rel_err=0.05)
    lm_cfg, lm_params, _ = gwb.minitron()
    k = gwb.clock_scale(lm_cfg)
    trace = gwb.scaled_trace(Trace.load(Path(__file__).resolve().parents[1] / "traces"
                                        / "diurnal_smoke.json"), k)
    first = [next(r for r in trace.requests if r.kind == kind) for kind in ("lm", "seg")]
    warm_trace = dataclasses.replace(trace, requests=tuple(first))
    specs = [dataclasses.replace(s, latency_target_ms=s.latency_target_ms * k)
             if s.latency_target_ms is not None else s for s in capb.slo_specs()]
    rates = {"lm": em.active_rate_pj(max(lm_cfg.quant.plane_schedule)),
             "seg": em.active_rate_pj(max(plan.planes))}

    def serve(t=trace):
        sink = TeeSink([RecordingSink(), SloMonitor(specs, windows=[w * k for w in capb.WINDOWS]),
                        EnergyMeter(rates)])
        fab, mats = gwb.fabric(lm_cfg, lm_params, cfg, params, plan, t, sink=sink)
        return replay_trace(fab, t, mats, max_rounds=10_000)

    return serve, (f"Fabric replay of {trace.name} ({len(trace)} requests; "
                   f"{gwb.FABRIC_SHARDS} shards, {gwb.FABRIC_ROUTER} routing; minitron_4b batch "
                   f"{gwb.LM_BATCH}, U-Net under {plan.describe()})"), \
        lambda: serve(warm_trace)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_serving: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.bench.table1 import busy_us, card_line
    from repro_torch.kernels import mma_matmul as mk

    card = card_line()
    args = sys.argv[1:]
    mode = next((m for m in ("lm", "plan", "gateway", "fabric", "moe", "rwkv6", "zamba2",
                             "whisper") if f"--{m}" in args), "unet")
    serve, what, *warm = {"lm": _lm_run, "plan": _plan_run, "unet": _unet_run,
                          "gateway": _gateway_run, "fabric": _fabric_run,
                          "moe": lambda: _lm_run("olmoe_1b_7b", "OLMoE-1B-7B"),
                          "rwkv6": lambda: _recurrent_run("rwkv6_3b", "RWKV6-3B"),
                          "zamba2": lambda: _recurrent_run("zamba2_7b", "Zamba2-7B"),
                          "whisper": _whisper_run}[mode]()
    ranges = [r for _, r in RANGES.get(mode, [])] + OWN_RANGES.get(mode, [])
    for mod_name, fn in RANGES.get(mode, []):
        _ranged(importlib.import_module(f"repro_torch.models.{mod_name}"), fn)
    (warm[0] if warm else serve)()  # warm-up: build, allocator, cuBLAS handles
    torch.cuda.synchronize()

    activities = [ProfilerActivity.CUDA] if mode in ("gateway", "fabric") else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mk.launches = mk.scaled_launches = 0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"mma_matmul": mk.launches, "mma_matmul_scaled": mk.scaled_launches}

    by_name: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    intervals = []
    for evt in prof.events():
        # device kernels and copies only, not the ranges' device spans
        if evt.device_type != DeviceType.CUDA or evt.name in ranges:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += (e - s) / 1e3
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = busy_us(intervals) / 1e3
    # the unscaled kernel and the scaled one, both on the tensor cores
    kernel_ms = {k: sum(ms for name, (_, ms) in by_name.items() if k in name)
                 for k in ("mma_tc_horner_kernel", "mma_tc_scaled_kernel")}
    mma_ms = sum(kernel_ms.values())
    print(f"{card}")
    print(f"[profile] {card} | {what}: host wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, MMA kernels {mma_ms:.2f} ms "
          f"over {launches} launches (unscaled {kernel_ms['mma_tc_horner_kernel']:.2f} ms, scaled "
          f"{kernel_ms['mma_tc_scaled_kernel']:.2f} ms: "
          f"{kernel_ms['mma_tc_scaled_kernel'] / busy_ms:.3f} of device busy)")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile] {ms:9.3f} ms {n:6d}x  {name[:110]}")
    extra = {}
    for rng_name in ranges:
        inside, r_wall = _range_kernels(prof.events(), rng_name)
        r_ms = sum(ms for _, ms in inside.values())
        print(f"[profile] {card} | kernels inside {rng_name} ranges: {r_ms:.2f} ms over "
              f"{sum(n for n, _ in inside.values())} kernels, {r_ms / busy_ms:.3f} of device busy; "
              f"the ranges' host wall {r_wall:.2f} ms")
        top = sorted(inside.items(), key=lambda kv: -kv[1][1])[:10]
        for name, (n, ms) in top:
            print(f"[profile] {rng_name} {ms:9.3f} ms {n:6d}x  {name[:100]}")
        extra[rng_name] = dict(ms=r_ms, share=r_ms / busy_ms, wall_ms=r_wall, top=dict(top))
    print(json.dumps(dict(card=card, mode=mode, wall_ms=wall_ms, busy_ms=busy_ms,
                          idle_share=1 - busy_ms / wall_ms, mma_kernel_ms=mma_ms,
                          mma_kernel_ms_by_name=kernel_ms, scaled_share=kernel_ms[
                              "mma_tc_scaled_kernel"] / busy_ms,
                          mma_launches=launches, device_events=len(intervals), **extra)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
