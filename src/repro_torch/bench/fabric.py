"""Sharded-fabric scale-out benchmark of the port: the twin of
``benchmarks/fabric.py``, returning the dict that bench writes to
``BENCH_fabric.json``.

Replays the scaled canonical traces (``traces/gateway_burst_x10.json`` /
``_x100.json`` — same traffic shape as ``gateway_burst``, 10x/100x the
arrival rate over the same span) through a single modeled gateway and
through an N-shard :class:`repro_torch.serve.Fabric`, open-loop via
``repro_torch.workload.replay``.  All engines here are *modeled*
(:mod:`repro_torch.serve.modeled`): work is priced with the relation-(2)
cycle model (the paper's FPGA model) but never executed, so nothing runs on
a device.

Gates (each raises): the single gateway's seg p99 grows more than 10x from
x1 to x10 (saturation); the 16-shard ``deficit`` fabric's grows less than
10x (sub-linear scale-out); every fabric run's fleet ledger is exactly
additive; every run completes every request.  The headline run (``deficit``
at x10) carries a ``RecordingSink`` whose exec attribution must reconcile
integer-exactly with every shard's ``RoundClock.worked_total`` and the
``FleetLedger`` totals; its spans give the payload's ``spans`` block.

    PYTHONPATH=src python -m repro_torch.bench.fabric [--json PATH]
"""
from __future__ import annotations

import json
import os
import time

# the repo root (src/repro_torch/bench/ -> three levels up)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
TRACES = {
    "x1": os.path.join(_ROOT, "traces", "gateway_burst.json"),
    "x10": os.path.join(_ROOT, "traces", "gateway_burst_x10.json"),
    "x100": os.path.join(_ROOT, "traces", "gateway_burst_x100.json"),
}

ROUND_BUDGET = 800_000
N_SHARDS = 16
LM_BATCH = 20
LM_MAX_SEQ = 96
MINORITY = "seg"
FABRIC_SEED = 7


def _mk_gateway(shares, *, policy="fair"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.modeled import ModeledLMAdapter, ModeledSegAdapter

    cfg = get_smoke_config("minitron_4b")
    return Gateway(
        [
            ModeledLMAdapter.from_config(cfg, batch=LM_BATCH,
                                         max_seq=LM_MAX_SEQ),
            ModeledSegAdapter.from_geometry(),
        ],
        policy=policy,
        round_budget=ROUND_BUDGET,
        shares=shares,
    )


def _replay(target, trace):
    from repro_torch.serve.modeled import modeled_materializer
    from repro_torch.workload import replay as replay_mod

    mats = {k: modeled_materializer() for k in trace.kinds}
    t0 = time.perf_counter()
    summary = replay_mod.replay(target, trace, mats, max_rounds=100_000)
    summary["wall_us"] = (time.perf_counter() - t0) * 1e6
    return summary


def _run_one(trace, shares, *, n_shards, router=None, record_spans=False):
    """One replay: single gateway (``n_shards=1``, ``router=None``) or an
    N-shard fabric.  Returns (summary, fabric-or-gateway)."""
    from repro_torch.serve.fabric import Fabric

    if n_shards == 1 and router is None:
        gw = _mk_gateway(shares)
        return _replay(gw, trace), gw
    sink = None
    if record_spans:
        from repro_torch.obs import RecordingSink

        sink = RecordingSink()
    fab = Fabric(
        [_mk_gateway(shares) for _ in range(n_shards)],
        router=router, seed=FABRIC_SEED, sink=sink,
    )
    summary = _replay(fab, trace)
    if record_spans:
        from repro_torch.obs import assemble, breakdown, reconcile

        rec = reconcile(
            sink.events, [g.round_clock for g in fab.shards],
            ledger=fab.ledger,
        )
        if not rec["holds"]:
            raise RuntimeError(
                f"fleet span attribution does not reconcile: "
                f"{rec['total_exec']} exec-event cycles vs "
                f"{rec['total_worked']} worked cycles (ledger "
                f"{sum(rec.get('ledger_worked', []))})"
            )
        summary["spans"] = dict(
            per_class=breakdown(assemble(sink.events)),
            reconcile=rec,
            events=len(sink.events),
        )
    return summary, fab


def _check_completion(summary, trace, label):
    for qos, pc in summary["per_class"].items():
        if pc["n"] != pc["completed"]:
            raise RuntimeError(
                f"{label} dropped work: class {qos} completed "
                f"{pc['completed']}/{pc['n']} on {trace.name}"
            )


def _check_additivity(fab, label):
    add = fab.additivity()
    if not add["holds"]:
        raise RuntimeError(
            f"fleet ledger additivity violated on {label}: ledger "
            f"ops/worked {add['ledger_total_ops']}/"
            f"{add['ledger_total_worked']} vs direct "
            f"{add['direct_total_ops']}/{add['direct_total_worked']}"
        )
    return add


def run():
    """Run the bench; returns the ``BENCH_fabric.json`` payload (raises on
    a failed gate)."""
    from repro_torch.workload import Trace

    traces = {k: Trace.load(p) for k, p in TRACES.items()}
    shares = dict(traces["x1"].meta["shares"])

    summaries: dict[str, dict] = {}
    payload_rows = []

    plan = [
        # label, trace key, shards, router
        ("single/x1", "x1", 1, None),
        ("single/x10", "x10", 1, None),
        (f"fabric{N_SHARDS}-deficit/x1", "x1", N_SHARDS, "deficit"),
        (f"fabric{N_SHARDS}-deficit/x10", "x10", N_SHARDS, "deficit"),
        (f"fabric{N_SHARDS}-class/x10", "x10", N_SHARDS, "class"),
        (f"fabric{N_SHARDS}-p2c/x10", "x10", N_SHARDS, "p2c"),
        # informational scale point: 16 shards at x100 is itself ~9x
        # oversubscribed — the next capacity-planning datapoint
        (f"fabric{N_SHARDS}-deficit/x100", "x100", N_SHARDS, "deficit"),
    ]
    headline = f"fabric{N_SHARDS}-deficit/x10"
    for label, tkey, n_shards, router in plan:
        trace = traces[tkey]
        summary, target = _run_one(
            trace, shares, n_shards=n_shards, router=router,
            # telemetry rides the headline configuration only; the in-run
            # reconcile raise gates exec attribution == per-shard
            # RoundClock totals == FleetLedger totals, to the integer
            record_spans=label == headline,
        )
        _check_completion(summary, trace, label)
        extra = dict(label=label, trace=tkey, n_shards=n_shards,
                     router=router)
        if n_shards > 1:
            add = _check_additivity(target, label)
            extra.update(
                additivity_holds=add["holds"],
                stolen=target.stolen,
                dispatched=list(target.dispatched),
            )
        summaries[label] = summary
        payload_rows.append(
            dict(
                **extra,
                rounds=summary["rounds"],
                clock_cycles=summary["clock_cycles"],
                time_ms=summary["time_ms"],
                total_ops=summary["total_ops"],
                gops=summary["gops"],
                gops_w=summary["gops_w"],
                forced=summary["forced"],
                per_class=summary["per_class"],
                # wall_us deliberately not persisted (machine noise)
            )
        )

    def seg_p99(label):
        return summaries[label]["per_class"][MINORITY]["p99_ms"]

    # Gate 1: the single gateway saturates — superlinear p99 growth
    single_ratio = seg_p99("single/x10") / seg_p99("single/x1")
    if not single_ratio > 10.0:
        raise RuntimeError(
            f"single gateway did not saturate on the x10 trace: "
            f"{MINORITY} p99 grew only {single_ratio:.1f}x (expected "
            f"superlinear, > 10x) — the fabric bench's premise is gone"
        )

    # Gate 2: the fabric absorbs the same load sub-linearly
    fab1 = f"fabric{N_SHARDS}-deficit/x1"
    fab10 = f"fabric{N_SHARDS}-deficit/x10"
    fabric_ratio = seg_p99(fab10) / seg_p99(fab1)
    if not fabric_ratio < 10.0:
        raise RuntimeError(
            f"{N_SHARDS}-shard fabric scaled superlinearly on the x10 "
            f"trace: {MINORITY} p99 grew {fabric_ratio:.1f}x (gate: "
            f"< 10x, sub-linear in the load factor)"
        )

    payload = dict(
        bench="fabric",
        traces={
            k: dict(name=t.name, version=t.version, seed=t.seed,
                    n_requests=len(t), span_cycles=t.span_cycles)
            for k, t in traces.items()
        },
        round_budget=ROUND_BUDGET,
        n_shards=N_SHARDS,
        shares=shares,
        spans=summaries[fab10]["spans"],
        rows=payload_rows,
        gate=dict(
            holds=True,  # every sub-gate raised above otherwise
            saturation=dict(
                minority=MINORITY,
                single_x1_p99_ms=seg_p99("single/x1"),
                single_x10_p99_ms=seg_p99("single/x10"),
                ratio=single_ratio,
                holds=bool(single_ratio > 10.0),
            ),
            sublinear=dict(
                minority=MINORITY,
                fabric_x1_p99_ms=seg_p99(fab1),
                fabric_x10_p99_ms=seg_p99(fab10),
                ratio=fabric_ratio,
                holds=bool(fabric_ratio < 10.0),
            ),
            additivity=dict(
                holds=True,  # raised above otherwise, every fabric run
                checked_runs=[
                    r["label"] for r in payload_rows
                    if r.get("additivity_holds")
                ],
            ),
        ),
    )
    return payload


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="BENCH_fabric.json")
    args = ap.parse_args()
    with open(args.json, "w") as f:
        json.dump(run(), f, indent=2)
        f.write("\n")
