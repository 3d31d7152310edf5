"""SLO-driven fleet capacity planner of the port: the twin of
``benchmarks/capacity.py``, returning the dict that bench writes to
``BENCH_capacity.json``.

It sweeps shard count x router x policy x plan over modeled adapters
(:mod:`repro_torch.serve.modeled`: priced by the relation-(2) cycle model,
the paper's FPGA model, never executed) under one day-shaped streaming
workload — :mod:`repro_torch.workload.diurnal` generators streamed through
:func:`repro_torch.workload.replay.replay_stream` (:func:`mk_feed`) — with
an online :class:`~repro_torch.obs.slo.SloMonitor` on every run
(:func:`slo_specs`).  Per (router, policy, plan) the payload's frontier is
the fewest shards meeting every SLO.

Gates (each raises): online/offline miss reconciliation on the instrumented
point (the monitor's counts and attribution equal the span-derived ones and
``stats()``'s ``deadline_misses``); the queued-miss share never grows with
added shards at fixed load; the frontier is not empty; the tuned plan never
needs more shards than the uniform one.

    PYTHONPATH=src python -m repro_torch.bench.capacity [--json PATH]
"""
from __future__ import annotations

import dataclasses
import json

ROUND_BUDGET = 800_000
SEED = 20260809
PERIOD = 38_400_000  # one modeled "day": 48 rounds of 800k cycles
SPAN = PERIOD  # simulate one full period
SHARD_COUNTS = (2, 4, 8)
ROUTERS = ("p2c", "deficit")
POLICIES = ("fair", "edf")
PLANS = ("uniform8", "tuned4")
LM_BATCH = 20
LM_MAX_SEQ = 96
SHARES = dict(interactive=0.4, batch=0.3, seg=0.3)
WINDOWS = (3_200_000, 16_000_000)  # 4-round fast / 20-round slow burn
# the instrumented point the reconciliation gate rides
RECONCILE_POINT = ("uniform8", "deficit", "fair", 4)

WORKLOAD = dict(
    generator="diurnal",
    seed=SEED,
    period=PERIOD,
    span=SPAN,
    floor=0.15,
    interactive=dict(peak_interval=55_000, deadline_cycles=400_000,
                     payload=dict(prompt_len=4, max_new=8)),
    batch=dict(burst_interval=200_000, on_mean=2_000_000,
               off_mean=4_000_000, deadline_cycles=8_000_000,
               payload=dict(prompt_len=24, max_new=4)),
    seg=dict(mean_interval=3_000_000, deadline_cycles=4_000_000,
             payload=dict(h=96, w=80)),
)


def slo_specs():
    from repro_torch.obs.slo import SloSpec

    return [
        SloSpec("interactive", pct=99, latency_target_ms=6.0,
                miss_budget=0.05),
        SloSpec("batch", pct=99, miss_budget=0.15),
        SloSpec("seg", pct=99, miss_budget=0.25),
    ]


def mk_feed(workload=WORKLOAD):
    """The day-shaped streaming feed — a fresh lazy generator each call,
    identical arrivals every time (pure counter-PRNG)."""
    from repro_torch.workload import diurnal

    w = workload
    seed, period, floor = w["seed"], w["period"], w["floor"]
    inter, batch, seg = w["interactive"], w["batch"], w["seg"]
    return diurnal.stream_requests(
        [
            dict(kind="lm", qos="interactive",
                 arrivals=diurnal.diurnal(
                     seed=seed, peak_interval=inter["peak_interval"],
                     period=period, floor=floor, start=50_000),
                 payload=dict(inter["payload"]),
                 deadline_cycles=inter["deadline_cycles"]),
            dict(kind="lm", qos="batch",
                 arrivals=diurnal.modulate(
                     diurnal.iter_on_off(
                         seed=seed + 1,
                         burst_interval=batch["burst_interval"],
                         on_mean=batch["on_mean"],
                         off_mean=batch["off_mean"], start=150_000),
                     seed=seed + 1, period=period, floor=floor),
                 payload=dict(batch["payload"]),
                 deadline_cycles=batch["deadline_cycles"]),
            dict(kind="seg", qos="seg",
                 arrivals=diurnal.iter_poisson(
                     seed=seed + 2,
                     mean_interval=seg["mean_interval"], start=600_000),
                 payload=dict(seg["payload"]),
                 deadline_cycles=seg["deadline_cycles"]),
        ],
        until=w["span"],
    )


def _mk_gateway(plan: str, policy: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.modeled import ModeledLMAdapter, ModeledSegAdapter

    cfg = get_smoke_config("minitron_4b")
    if plan == "tuned4":
        # price the tuned operating point: a uniform 4-plane schedule,
        # the shape the autotune bench certifies at the smoke target
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, plane_schedule=(4,))
        )
        seg_planes = 4
    elif plan == "uniform8":
        seg_planes = 8
    else:
        raise ValueError(f"unknown plan {plan!r}; one of {PLANS}")
    return Gateway(
        [
            ModeledLMAdapter.from_config(cfg, batch=LM_BATCH,
                                         max_seq=LM_MAX_SEQ),
            ModeledSegAdapter.from_geometry(planes=seg_planes),
        ],
        policy=policy,
        round_budget=ROUND_BUDGET,
        shares=dict(SHARES),
    )


def _run_point(plan, router, policy, n_shards, *, workload=WORKLOAD,
               record=False, max_rounds=400_000):
    """One grid point: fabric + armed SloMonitor, streamed feed.
    Returns (summary, fabric, monitor, recording-sink-or-None)."""
    from repro_torch.obs import RecordingSink, TeeSink
    from repro_torch.obs.slo import SloMonitor
    from repro_torch.serve.fabric import Fabric
    from repro_torch.workload.replay import replay_stream

    mon = SloMonitor(slo_specs(), windows=WINDOWS)
    rec = RecordingSink() if record else None
    sink = TeeSink([rec, mon]) if record else mon
    fab = Fabric(
        [_mk_gateway(plan, policy) for _ in range(n_shards)],
        router=router, seed=7, sink=sink,
    )
    label = f"{plan}/{router}-{policy}/s{n_shards}"
    summary = replay_stream(fab, mk_feed(workload), label=label,
                            max_rounds=max_rounds)
    return summary, fab, mon, rec


def _slo_met(summary, specs) -> bool:
    """Every class meets its objective: miss rate within budget, and the
    exact-order-statistic percentile within the latency target."""
    pc = summary["per_class"]
    for spec in specs:
        c = pc.get(spec.qos)
        if c is None or not c["completed"]:
            continue
        if c["deadline_misses"] / c["completed"] > spec.miss_budget:
            return False
        if spec.latency_target_ms is not None:
            p = c.get(f"p{int(spec.pct)}_ms")
            if p is not None and p > spec.latency_target_ms:
                return False
    return True


def _check_reconcile(summary, fab, mon, rec, label):
    """Gate 1: online == offline == stats(), to the integer."""
    from repro_torch.obs import assemble
    from repro_torch.obs.slo import FLEET

    spans = assemble(rec.events)
    r = mon.reconcile(spans)
    if not r["holds"]:
        raise RuntimeError(
            f"online/offline SLO miss reconciliation failed on {label}: "
            f"online {r['online']} vs span-derived {r['offline']} "
            f"(attribution {r['online_attribution']} vs "
            f"{r['offline_attribution']})"
        )
    stats_misses = {
        q: c["deadline_misses"]
        for q, c in summary["per_class"].items() if c["deadline_misses"]
    }
    if stats_misses != mon.miss_counts(FLEET):
        raise RuntimeError(
            f"stats() deadline_misses diverge from the SloMonitor on "
            f"{label}: {stats_misses} vs {mon.miss_counts(FLEET)}"
        )
    return r


def run(*, shard_counts=SHARD_COUNTS, routers=ROUTERS, policies=POLICIES,
        plans=PLANS, workload=WORKLOAD):
    """Run the bench over the grid; returns the ``BENCH_capacity.json``
    payload (raises on a failed gate)."""
    from repro_torch.obs.attrib import ATTRIB_CLASSES
    from repro_torch.obs.slo import FLEET
    from repro_torch.workload.trace import TRACE_VERSION

    specs = slo_specs()
    key = (
        f"{workload['generator']}:{workload['seed']}"
        f":p{workload['period']}:u{workload['span']}@v{TRACE_VERSION}"
        f";grid=s{list(shard_counts)}xr{list(routers)}"
        f"xp{list(policies)}xpl{list(plans)}"
    )

    payload_rows = []
    n_offered = None
    reconcile_out = None
    for plan in plans:
        for router in routers:
            for policy in policies:
                for n in shard_counts:
                    record = (plan, router, policy, n) == RECONCILE_POINT
                    summary, fab, mon, rec = _run_point(
                        plan, router, policy, n, workload=workload,
                        record=record,
                    )
                    label = f"{plan}/{router}-{policy}/s{n}"
                    fed = summary["stream"]["n_requests"]
                    if n_offered is None:
                        n_offered = fed
                    elif fed != n_offered:
                        raise RuntimeError(
                            f"feed diverged across grid points: {label} "
                            f"fed {fed} vs {n_offered} — the generators "
                            f"are not pure"
                        )
                    if record:
                        reconcile_out = _check_reconcile(
                            summary, fab, mon, rec, label
                        )
                    fleet = mon.summary(scope=FLEET)
                    queued_misses = sum(
                        c["attribution"]["queued"]
                        for c in fleet["per_class"].values()
                    )
                    total_misses = summary["deadline_misses"]
                    met = _slo_met(summary, specs)
                    payload_rows.append(dict(
                        label=label, plan=plan, router=router,
                        policy=policy, shards=n,
                        rounds=summary["rounds"],
                        clock_cycles=summary["clock_cycles"],
                        gops=summary["gops"],
                        gops_w=summary["gops_w"],
                        per_class=summary["per_class"],
                        deadline_misses=total_misses,
                        queued_misses=queued_misses,
                        # fixed-load share: offered count is the shared
                        # denominator, so monotonicity is integer-exact
                        queue_share=queued_misses / n_offered,
                        slo=dict(
                            met=met,
                            per_class={
                                q: dict(
                                    miss_rate=c["miss_rate"],
                                    burn=c["burn"],
                                    attribution=c["attribution"],
                                    attribution_shares=c[
                                        "attribution_shares"],
                                )
                                for q, c in fleet["per_class"].items()
                            },
                        ),
                        router_stats=fab.stats()["router_stats"],
                        stolen=fab.stolen,
                    ))

    # Gate 2: queueing share never worsens with added shards
    for plan in plans:
        for router in routers:
            for policy in policies:
                series = [
                    r for r in payload_rows
                    if (r["plan"], r["router"], r["policy"])
                    == (plan, router, policy)
                ]
                series.sort(key=lambda r: r["shards"])
                for a, b in zip(series, series[1:]):
                    if b["queue_share"] > a["queue_share"]:
                        raise RuntimeError(
                            f"queueing share worsened with more shards: "
                            f"{a['label']} {a['queue_share']:.4f} -> "
                            f"{b['label']} {b['queue_share']:.4f} at "
                            f"fixed load"
                        )

    # Frontier: per (router, policy, plan), min shards meeting every SLO
    frontier = []
    for plan in plans:
        for router in routers:
            for policy in policies:
                meeting = sorted(
                    r["shards"] for r in payload_rows
                    if (r["plan"], r["router"], r["policy"])
                    == (plan, router, policy) and r["slo"]["met"]
                )
                point = None
                if meeting:
                    point = next(
                        r for r in payload_rows
                        if (r["plan"], r["router"], r["policy"],
                            r["shards"])
                        == (plan, router, policy, meeting[0])
                    )
                frontier.append(dict(
                    plan=plan, router=router, policy=policy,
                    min_shards=meeting[0] if meeting else None,
                    gops_w=point["gops_w"] if point else None,
                    attribution_shares={
                        q: c["attribution_shares"]
                        for q, c in point["slo"]["per_class"].items()
                    } if point else None,
                ))

    # Gate 3: the frontier exists
    if not any(f["min_shards"] is not None for f in frontier):
        raise RuntimeError(
            "no grid point meets every SLO — the capacity frontier is "
            "empty; the workload or grid is mis-sized"
        )

    # Gate 4: the tuned plan never needs more shards than uniform
    tuned_wins = []
    if "tuned4" in plans and "uniform8" in plans:
        for router in routers:
            for policy in policies:
                by_plan = {
                    f["plan"]: f["min_shards"] for f in frontier
                    if (f["router"], f["policy"]) == (router, policy)
                }
                u, t = by_plan.get("uniform8"), by_plan.get("tuned4")
                if u is not None and (t is None or t > u):
                    raise RuntimeError(
                        f"tuned plan costs more fleet than uniform at "
                        f"({router}, {policy}): tuned min_shards {t} vs "
                        f"uniform {u}"
                    )
                tuned_wins.append(dict(router=router, policy=policy,
                                       uniform=u, tuned=t))

    payload = dict(
        bench="capacity",
        key=key,
        grid=dict(shards=list(shard_counts), routers=list(routers),
                  policies=list(policies), plans=list(plans)),
        workload=dict(workload, n_offered=n_offered,
                      trace_schema=TRACE_VERSION),
        slo=[s.to_dict() for s in specs],
        windows=list(WINDOWS),
        attrib_classes=list(ATTRIB_CLASSES),
        rows=payload_rows,
        frontier=frontier,
        gate=dict(
            holds=True,  # every sub-gate raised above otherwise
            reconcile=reconcile_out,
            queue_share_monotone=True,
            frontier_nonempty=True,
            tuned_never_costlier=tuned_wins,
        ),
    )
    return payload


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="BENCH_capacity.json")
    args = ap.parse_args()
    with open(args.json, "w") as f:
        json.dump(run(), f, indent=2)
        f.write("\n")
