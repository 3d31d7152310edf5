"""Metered fleet energy frontier of the port: the twin of
``benchmarks/energy.py``, returning the dict that bench writes to
``BENCH_energy.json``.

It replays the capacity planner's day-shaped streaming workload
(:mod:`repro_torch.bench.capacity`'s generators, half the span) over a
plan x policy x shard grid of modeled fabrics with an armed
:class:`~repro_torch.obs.energy.EnergyMeter`, and reports **metered**
GOPS/W and energy per request beside ``stats()``'s analytic figure, for
``uniform8`` (8-plane schedules), ``tuned4`` (the certified 4-plane point)
and ``spec2`` (2-plane speculative drafts verified at full digits,
:class:`~repro_torch.serve.modeled.ModeledSpecLMAdapter`).  The picojoules
and GOPS/W are the paper's FPGA energy model, not a card reading.

Gates (each raises): the meter's integer-pJ ledger reconciles on the
instrumented point (and the span-attached joules equal the online
attribution); ``tuned4`` and ``spec2`` strictly cut metered energy per
request against ``uniform8`` at every (policy, shards), overall and for the
``interactive`` class; metered GOPS/W is at least the analytic one on
``uniform8``; every point replays the identical feed.

    PYTHONPATH=src python -m repro_torch.bench.energy [--json PATH]
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.bench import capacity as cap

ROUND_BUDGET = cap.ROUND_BUDGET
SPAN = cap.PERIOD // 2  # half a modeled day: energy trends saturate fast
SHARD_COUNTS = (2, 4)
ROUTER = "p2c"
POLICIES = ("fair", "edf")
PLANS = ("uniform8", "tuned4", "spec2")
DRAFT_PLANES = 2
SPEC_K = 4
# per-shard rolling power cap: just under the modeled full-width chip
# power (~3.50 W), so saturated uniform8 shards graze it — the cap
# telemetry has something to show without drowning the run in events
POWER_WATTS = 3.2
# the instrumented point the reconciliation gate rides (plan, policy, n)
RECONCILE_POINT = ("spec2", "fair", 4)

WORKLOAD = dict(cap.WORKLOAD, span=SPAN)

# QoS classes gate 2 additionally holds *strictly* per class.  The
# batch class is deliberately absent: its short decodes (max_new=4 vs
# k=4 drafts) make speculation roughly break-even there — over-drafted
# tokens past the request's end are wasted draft work — which the per-
# class rows report rather than gate.
GATE_CLASSES = ("interactive",)


def _power_spec():
    from repro_torch.obs.energy import PowerSpec

    return PowerSpec(watts=POWER_WATTS)


def _plan_setup(plan: str):
    """(gateway factory kwargs, meter rates, meter draft rates)."""
    from repro_torch.core import energy_model as em

    if plan == "uniform8":
        return dict(lm_planes=8, seg_planes=8, spec=False), {
            "lm": em.active_rate_pj(8), "seg": em.active_rate_pj(8),
        }, None
    if plan == "tuned4":
        return dict(lm_planes=4, seg_planes=4, spec=False), {
            "lm": em.active_rate_pj(4), "seg": em.active_rate_pj(4),
        }, None
    if plan == "spec2":
        return dict(lm_planes=8, seg_planes=8, spec=True), {
            "lm": em.active_rate_pj(8), "seg": em.active_rate_pj(8),
        }, {"lm": em.active_rate_pj(DRAFT_PLANES)}
    raise ValueError(f"unknown plan {plan!r}; one of {PLANS}")


def _mk_gateway(plan: str, policy: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.modeled import (
        ModeledLMAdapter,
        ModeledSegAdapter,
        ModeledSpecLMAdapter,
    )

    setup, _, _ = _plan_setup(plan)
    cfg = get_smoke_config("minitron_4b")
    if setup["lm_planes"] != 8:
        cfg = dataclasses.replace(
            cfg, quant=dataclasses.replace(
                cfg.quant, plane_schedule=(setup["lm_planes"],)
            )
        )
    if setup["spec"]:
        lm = ModeledSpecLMAdapter.from_config(
            cfg, batch=cap.LM_BATCH, max_seq=cap.LM_MAX_SEQ,
            draft_schedule=(DRAFT_PLANES,), k=SPEC_K,
        )
    else:
        lm = ModeledLMAdapter.from_config(
            cfg, batch=cap.LM_BATCH, max_seq=cap.LM_MAX_SEQ
        )
    return Gateway(
        [lm, ModeledSegAdapter.from_geometry(planes=setup["seg_planes"])],
        policy=policy,
        round_budget=ROUND_BUDGET,
        shares=dict(cap.SHARES),
    )


def _run_point(plan, policy, n_shards, *, workload=WORKLOAD,
               record=False, max_rounds=400_000):
    """One grid point: fabric + armed EnergyMeter, streamed feed.
    Returns (summary, fabric, meter, recording-sink-or-None)."""
    from repro_torch.obs import RecordingSink, TeeSink
    from repro_torch.obs.energy import EnergyMeter
    from repro_torch.serve.fabric import Fabric
    from repro_torch.workload.replay import replay_stream

    _, rates, draft_rates = _plan_setup(plan)
    meter = EnergyMeter(rates, draft_rates=draft_rates,
                        power=_power_spec())
    rec = RecordingSink() if record else None
    sink = TeeSink([rec, meter]) if record else meter
    fab = Fabric(
        [_mk_gateway(plan, policy) for _ in range(n_shards)],
        router=ROUTER, seed=7, sink=sink,
    )
    label = f"{plan}/{policy}/s{n_shards}"
    summary = replay_stream(fab, cap.mk_feed(workload), label=label,
                            max_rounds=max_rounds)
    return summary, fab, meter, rec


def _check_reconcile(meter, rec, label):
    """Gate 1: the integer-pJ ledger closes, online == offline."""
    from repro_torch.obs import assemble
    from repro_torch.obs.energy import attach_joules

    spans = attach_joules(assemble(rec.events), meter)
    r = meter.reconcile(spans)
    if not r["holds"]:
        raise RuntimeError(
            f"energy ledger reconciliation failed on {label}: "
            f"{r['checks']} (additivity {r['additivity']}, "
            f"spans {r.get('spans')})"
        )
    # the span-attached joules are the same attribution, re-keyed
    span_pj = sum(sp.pj for sp in spans if sp.done)
    if span_pj != r["spans"]["online_pj"]:
        raise RuntimeError(
            f"attach_joules diverges from the online attribution on "
            f"{label}: {span_pj} vs {r['spans']['online_pj']}"
        )
    return r


def run(*, shard_counts=SHARD_COUNTS, policies=POLICIES, plans=PLANS,
        workload=WORKLOAD):
    """Run the bench over the grid; returns the ``BENCH_energy.json``
    payload (raises on a failed gate)."""
    from repro_torch.workload.trace import TRACE_VERSION

    key = (
        f"{workload['generator']}:{workload['seed']}"
        f":p{workload['period']}:u{workload['span']}@v{TRACE_VERSION}"
        f";grid=s{list(shard_counts)}xp{list(policies)}"
        f"xpl{list(plans)};r={ROUTER}"
        f";dp{DRAFT_PLANES}k{SPEC_K};w{POWER_WATTS}"
    )

    # the instrumented point: the default when the grid covers it, else
    # the last-shard point of the first plan so reduced grids (tests,
    # ad-hoc sweeps) still exercise the reconciliation gate
    rpoint = RECONCILE_POINT
    if not (rpoint[0] in plans and rpoint[1] in policies
            and rpoint[2] in shard_counts):
        rpoint = (
            ("spec2" if "spec2" in plans else list(plans)[0]),
            list(policies)[0], list(shard_counts)[-1],
        )

    payload_rows = []
    n_offered = None
    reconcile_out = None
    for plan in plans:
        for policy in policies:
            for n in shard_counts:
                record = (plan, policy, n) == rpoint
                summary, fab, meter, rec = _run_point(
                    plan, policy, n, workload=workload, record=record,
                )
                label = f"{plan}/{policy}/s{n}"
                fed = summary["stream"]["n_requests"]
                if n_offered is None:
                    n_offered = fed
                elif fed != n_offered:
                    raise RuntimeError(
                        f"feed diverged across grid points: {label} fed "
                        f"{fed} vs {n_offered} — the generators are not "
                        f"pure"
                    )
                if record:
                    reconcile_out = _check_reconcile(meter, rec, label)
                e = summary["energy"]
                if e["completions"] == 0:
                    raise RuntimeError(f"no completions on {label}")
                epr = e["total_pj"] / e["completions"]
                payload_rows.append(dict(
                    label=label, plan=plan, policy=policy, shards=n,
                    rounds=summary["rounds"],
                    clock_cycles=summary["clock_cycles"],
                    gops=summary["gops"],
                    analytic_gops_w=e["analytic_gops_w"],
                    metered_gops_w=e["metered_gops_w"],
                    total_mj=e["total_mj"],
                    active_mj=e["active_mj"],
                    idle_mj=e["idle_mj"],
                    completions=e["completions"],
                    energy_per_request_pj=epr,
                    per_class={
                        q: dict(
                            mj=c["mj"],
                            requests=c["requests"],
                            mean_request_pj=c["mean_request_pj"],
                            p50_request_pj=c["p50_request_pj"],
                            p99_request_pj=c["p99_request_pj"],
                        )
                        for q, c in e["per_class"].items()
                    },
                    spec=e["spec"],
                    power=e["power"],
                ))

    by_point = {
        (r["plan"], r["policy"], r["shards"]): r for r in payload_rows
    }

    # Gate 2: tuned/spec strictly reduce metered energy per request vs
    # uniform8, per LM class and overall, at every (policy, shards)
    wins = []
    for policy in policies:
        for n in shard_counts:
            base = by_point.get(("uniform8", policy, n))
            if base is None:
                continue
            for plan in plans:
                if plan == "uniform8":
                    continue
                r = by_point[(plan, policy, n)]
                if r["energy_per_request_pj"] >= \
                        base["energy_per_request_pj"]:
                    raise RuntimeError(
                        f"{plan} does not reduce metered energy per "
                        f"request vs uniform8 at ({policy}, s{n}): "
                        f"{r['energy_per_request_pj']:.0f} vs "
                        f"{base['energy_per_request_pj']:.0f} pJ"
                    )
                for q in GATE_CLASSES:
                    a = r["per_class"][q]["mean_request_pj"]
                    b = base["per_class"][q]["mean_request_pj"]
                    if a is None or b is None or a >= b:
                        raise RuntimeError(
                            f"{plan} does not reduce {q} mean request "
                            f"energy vs uniform8 at ({policy}, s{n}): "
                            f"{a} vs {b} pJ"
                        )
                wins.append(dict(
                    plan=plan, policy=policy, shards=n,
                    epr_pj=r["energy_per_request_pj"],
                    uniform_epr_pj=base["energy_per_request_pj"],
                ))

    # Gate 3: metered >= analytic on uniform8 (idle is static-only)
    for r in payload_rows:
        if r["plan"] == "uniform8" and \
                r["metered_gops_w"] < r["analytic_gops_w"]:
            raise RuntimeError(
                f"metered GOPS/W below analytic on {r['label']}: "
                f"{r['metered_gops_w']:.3f} < "
                f"{r['analytic_gops_w']:.3f} — idle pricing is broken"
            )

    if reconcile_out is None:
        raise RuntimeError(
            f"instrumented point {rpoint} never ran — the "
            f"reconciliation gate did not fire"
        )

    from repro_torch.core import energy_model as em

    payload = dict(
        bench="energy",
        key=key,
        grid=dict(shards=list(shard_counts), router=ROUTER,
                  policies=list(policies), plans=list(plans)),
        workload=dict(workload, n_offered=n_offered,
                      trace_schema=TRACE_VERSION),
        power=_power_spec().to_dict(),
        rates=dict(
            pj_plane_cycle=em.PJ_PLANE_CYCLE,
            pj_static_cycle=em.PJ_STATIC_CYCLE,
            pj_full_cycle=em.PJ_FULL_CYCLE,
            draft_planes=DRAFT_PLANES,
        ),
        calibration=em.calibration(),
        rows=payload_rows,
        gate=dict(
            holds=True,  # every sub-gate raised above otherwise
            reconcile=reconcile_out,
            equal_error_energy_wins=wins,
            metered_ge_analytic=True,
        ),
    )
    return payload


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="BENCH_energy.json")
    args = ap.parse_args()
    with open(args.json, "w") as f:
        json.dump(run(), f, indent=2)
        f.write("\n")
