#!/usr/bin/env python3
"""Where the port's serving time goes on the card.

    python3 scripts/profile_port_serving.py          # segmentation (U-Net)
    python3 scripts/profile_port_serving.py --plan   # segmentation, tuned plan
    python3 scripts/profile_port_serving.py --lm     # LM decode (Yi-6B)
    python3 scripts/profile_port_serving.py --gateway  # the gateway replay
    python3 scripts/profile_port_serving.py --fabric   # the 2-shard fabric replay

Default: serves the four phantom images of ``chip_smoke.py`` through the
full-width ``SegEngine`` (calibrated U-Net, ``from_weights(0.05)``
schedule, adaptive budget classes).  ``--plan``: first tunes a plan as
``chip_smoke.py`` phase 7 does (``tune_unet`` at target 0.05 on two
phantom calibration images, not profiled), then serves the same four
images through ``engine_from_plan`` (per-tile activation scales).
``--lm``: serves ``chip_smoke.py``'s four requests through ``Engine.run``
on Yi-6B at full width (random int8 weights from seed 0,
``from_weights(0.05)`` schedule of the ``w_up`` weights, batch 4).
``--gateway``: tunes the plan as ``--plan`` does, then replays
``traces/gateway_burst.json`` through the gateway as ``chip_smoke.py``
phase 8 does (minitron_4b at full width, batch 20; the U-Net under the
plan; the trace's clock scaled, ``repro_torch.bench.gateway``); its warm-up
replays the trace's first LM and first seg request only, and it records
device activity only (a replay issues millions of host ops).  ``--fabric``:
the same, for ``chip_smoke.py`` phase 10: ``traces/diurnal_smoke.json``
(clock and deadlines scaled) through a 2-shard ``Fabric`` of those gateways
(``deficit`` routing, stealing on, one set of weights shared), with a
``RecordingSink``, ``SloMonitor`` and ``EnergyMeter`` teed.  Each other
mode runs its serving pass once to warm up.  Then the pass runs once under
``torch.profiler``, and the script prints: host wall time, device busy time
(the union of kernel and copy intervals on the card) and idle share, device
time by kernel name, and the MMA kernels' launches.  The last line is a
JSON summary.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


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


def _lm_run():
    """The LM serving pass (``chip_smoke.py``'s requests): a callable and
    its description."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.plane_schedule import PlaneSchedule
    from repro_torch.models import transformer
    from repro_torch.serve import Engine, Request

    cfg = get_config("yi_6b")
    params = transformer.init_params(0, cfg, int8_min_dim=256)
    up = params["blocks"]["mlp"]["w_up"]["w_q"]
    sched = PlaneSchedule.from_weights([up[l] for l in range(cfg.n_layers)], 0.05)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", plane_schedule=sched.planes))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(4, 9, 4)]

    def serve():
        reqs = [Request(i, p, max_new=4) for i, p in enumerate(prompts)]
        return Engine(kcfg, params, batch=4, max_seq=64).run(reqs)

    calls = sum(len(p) for p in prompts) + 4
    return serve, f"Engine.run() of 4 Yi-6B requests ({calls} decode calls)"


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
    from repro_torch.bench.table1 import card_line
    from repro_torch.kernels import mma_matmul as mk

    card = card_line()
    args = sys.argv[1:]
    mode = next((m for m in ("lm", "plan", "gateway", "fabric") if f"--{m}" in args), "unet")
    serve, what, *warm = {"lm": _lm_run, "plan": _plan_run, "unet": _unet_run,
                          "gateway": _gateway_run, "fabric": _fabric_run}[mode]()
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
        if evt.device_type != DeviceType.CUDA:
            continue
        s, e = evt.time_range.start, evt.time_range.end
        intervals.append((s, e))
        by_name[evt.name][0] += 1
        by_name[evt.name][1] += (e - s) / 1e3
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _busy_us(intervals) / 1e3
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
    print(json.dumps(dict(card=card, mode=mode, wall_ms=wall_ms, busy_ms=busy_ms,
                          idle_share=1 - busy_ms / wall_ms, mma_kernel_ms=mma_ms,
                          mma_kernel_ms_by_name=kernel_ms,
                          mma_launches=launches, device_events=len(intervals))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
