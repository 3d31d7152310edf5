"""Ledger report generator: trend + breakdown tables from committed
artifacts, no re-running of benches (a copy of the reference's
``obs/report.py``: its markdown and JSON equal the reference's, string for
string, the JSON's ``schema`` name included).

Inputs are the repo's own committed CI artifacts:

``BENCH_LEDGER.jsonl``
    one datapoint per revision (``scripts/bench_diff.py --ledger``):
    each bench's headline GOPS/W, certificate and extra headline metrics
    keyed by revision + committer date.  The report renders one trend
    table per bench — GOPS/W with per-revision deltas, and the latency
    headline (p99) where the bench carries one.

``BENCH_*.json``
    the per-bench payloads.  The gateway payload (and, when present,
    the fabric payload) carries a ``spans`` block — per-class
    exact-order-statistic latency breakdowns assembled from the event
    bus (:mod:`repro_torch.obs.spans`) — rendered as "the p99 request spent X
    queued / Y executing / Z preempted" tables, plus the integer
    reconciliation verdict against the cycle ledgers.  The capacity
    payload (``BENCH_capacity.json``) additionally yields the
    cost-per-SLO frontier table and per-grid-point SLO burn +
    miss-attribution tables (:func:`frontier_table` /
    :func:`slo_tables`); the energy payload (``BENCH_energy.json``)
    yields the metered-joules frontier and per-class joule-breakdown
    tables (:func:`energy_tables`).

Output is markdown (the CI artifact) and a JSON twin for programmatic
consumers.  ``scripts/report.py`` is the CLI.
"""
from __future__ import annotations

import json
import os


def read_ledger(path) -> list[dict]:
    """Parse a ``BENCH_LEDGER.jsonl`` (newest entry last, as appended)."""
    entries: list[dict] = []
    if not os.path.exists(path):
        return entries
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def read_benches(paths) -> dict[str, dict]:
    """Load BENCH payloads present on disk, keyed by their bench name."""
    out: dict[str, dict] = {}
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as fh:
            payload = json.load(fh)
        out[str(payload.get("bench", os.path.basename(p)))] = payload
    return out


def trend(entries) -> dict[str, list[dict]]:
    """Pivot ledger entries into per-bench revision series (entry order
    preserved — the ledger is append-ordered, oldest first)."""
    series: dict[str, list[dict]] = {}
    for e in entries:
        for bench, h in e.get("benches", {}).items():
            row = dict(
                revision=str(e.get("revision", "?"))[:12],
                date=str(e.get("date", ""))[:10],
            )
            row.update(h)
            series.setdefault(bench, []).append(row)
    return series


_LATENCY_KEYS = ("interactive_p99_ms", "seg_p99_ms", "min_shards",
                 "speedup", "accept_rate", "epr_pj")


def _fmt(v, nd=3) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def trend_tables(series: dict[str, list[dict]]) -> list[str]:
    """One markdown trend table per bench, GOPS/W deltas vs the previous
    ledger entry for the same bench."""
    out: list[str] = []
    for bench in sorted(series):
        rows = series[bench]
        lat_keys = [
            k for k in _LATENCY_KEYS if any(k in r for r in rows)
        ]
        head = ["revision", "date", "gops_w", "Δ%"]
        head += [k for k in lat_keys] + ["cert", "target"]
        lines = [
            f"### {bench}",
            "",
            "| " + " | ".join(head) + " |",
            "|" + "|".join("---" for _ in head) + "|",
        ]
        prev = None
        for r in rows:
            gw = r.get("gops_w")
            if prev not in (None, 0) and gw is not None:
                delta = f"{(gw - prev) / prev * 100:+.2f}"
            else:
                delta = "—"
            cells = [
                r["revision"], r["date"], _fmt(gw), delta,
                *[_fmt(r.get(k)) for k in lat_keys],
                _fmt(r.get("cert"), 4), _fmt(r.get("target")),
            ]
            lines.append("| " + " | ".join(cells) + " |")
            prev = gw if gw is not None else prev
        out.append("\n".join(lines))
    return out


def span_tables(payload: dict) -> str | None:
    """Render a BENCH payload's ``spans`` block (if any): per-class p50 /
    p99 queued-vs-executing-vs-preempted decompositions plus the ledger
    reconciliation verdict."""
    spans = payload.get("spans")
    if not spans:
        return None
    per_class = spans.get("per_class", {})
    head = ["class", "n", "pct", "total_ms",
            "queued_ms", "exec_ms", "preempted_ms", "rid"]
    lines = [
        "| " + " | ".join(head) + " |",
        "|" + "|".join("---" for _ in head) + "|",
    ]
    for qos in sorted(per_class):
        entry = per_class[qos]
        for key in sorted(k for k in entry if k.startswith("p")
                          and isinstance(entry[k], dict)):
            d = entry[key]
            lines.append(
                "| " + " | ".join([
                    qos, str(entry.get("n", "—")), key,
                    _fmt(d.get("total_ms")), _fmt(d.get("queued_ms")),
                    _fmt(d.get("exec_ms")), _fmt(d.get("preempted_ms")),
                    str(d.get("rid", "—")),
                ]) + " |"
            )
    rec = spans.get("reconcile")
    if rec is not None:
        verdict = "holds" if rec.get("holds") else "**VIOLATED**"
        lines.append("")
        lines.append(
            f"Ledger reconciliation: {verdict} — "
            f"Σ exec-attribution = {rec.get('total_exec')} cycles vs "
            f"worked_total = {rec.get('total_worked')} cycles."
        )
    return "\n".join(lines)


def frontier_table(payload: dict) -> str | None:
    """Render the capacity payload's cost-per-SLO frontier: per (plan,
    router, policy), the minimum shard count meeting every SLO and that
    fleet's GOPS/W."""
    if payload.get("bench") != "capacity":
        return None
    frontier = payload.get("frontier")
    if not frontier:
        return None
    head = ["plan", "router", "policy", "min shards", "gops_w",
            "miss attribution at frontier"]
    lines = [
        "| " + " | ".join(head) + " |",
        "|" + "|".join("---" for _ in head) + "|",
    ]
    for f in frontier:
        shares = f.get("attribution_shares") or {}
        # summarize per-class shares into the classes that actually
        # carry weight at this point ("clean" when nothing misses)
        parts = []
        for qos in sorted(shares):
            top = {k: v for k, v in shares[qos].items() if v}
            if top:
                parts.append(
                    qos + ": " + ", ".join(
                        f"{k} {v:.0%}" for k, v in sorted(
                            top.items(), key=lambda kv: -kv[1])
                    )
                )
        lines.append(
            "| " + " | ".join([
                str(f.get("plan")), str(f.get("router")),
                str(f.get("policy")),
                _fmt(f.get("min_shards")), _fmt(f.get("gops_w")),
                "; ".join(parts) or "clean",
            ]) + " |"
        )
    return "\n".join(lines)


def slo_tables(payload: dict) -> str | None:
    """Render per-grid-point SLO burn + miss-attribution rows from the
    capacity payload: one line per point — met verdict, fleet deadline
    misses, the interactive class's cumulative burn (miss rate over
    budget), and the queued / preempted / service / overdraft split of
    every miss."""
    if payload.get("bench") != "capacity":
        return None
    rows = payload.get("rows")
    if not rows:
        return None
    classes = payload.get("attrib_classes") or [
        "queued", "preempted", "service", "overdraft"
    ]
    head = ["point", "SLO", "misses", "interactive burn"] + list(classes)
    lines = [
        "| " + " | ".join(head) + " |",
        "|" + "|".join("---" for _ in head) + "|",
    ]
    for r in rows:
        per_class = r.get("slo", {}).get("per_class", {})
        burn = per_class.get("interactive", {}).get("burn", {})
        totals = {c: 0 for c in classes}
        for c in per_class.values():
            for k, v in (c.get("attribution") or {}).items():
                totals[k] = totals.get(k, 0) + v
        lines.append(
            "| " + " | ".join([
                str(r.get("label")),
                "met" if r.get("slo", {}).get("met") else "**miss**",
                str(r.get("deadline_misses")),
                _fmt(burn.get("cumulative"), 2),
                *[str(totals.get(c, 0)) for c in classes],
            ]) + " |"
        )
    return "\n".join(lines)


def specdecode_table(payload: dict) -> str | None:
    """Render the speculative-decode payload's headline: the tuned
    operating point, its modeled speedup over non-speculative decode,
    the measured acceptance, and the honest waste accounting."""
    if payload.get("bench") != "specdecode":
        return None
    gate = payload.get("gate")
    plan = payload.get("plan")
    if not gate or not plan:
        return None
    head = ["draft planes", "k", "speedup", "gate", "accept rate",
            "spec cycles", "baseline cycles", "wasted cycles"]
    sp = plan.get("spec_planes") or ["?"]
    lines = [
        "| " + " | ".join(head) + " |",
        "|" + "|".join("---" for _ in head) + "|",
        "| " + " | ".join([
            str(sp[0]), str(plan.get("spec_k")),
            _fmt(gate.get("speedup")) + "x",
            f">={_fmt(gate.get('min_speedup'), 1)}x "
            + ("holds" if gate.get("holds") else "**VIOLATED**"),
            _fmt(gate.get("accept_rate")),
            str(gate.get("spec_cycles")), str(gate.get("baseline_cycles")),
            str(gate.get("wasted_cycles")),
        ]) + " |",
    ]
    ev = payload.get("gateway", {}).get("spec_events")
    if ev:
        lines.append("")
        lines.append(
            "Gateway lifecycle events: " + ", ".join(
                f"{k}={ev.get(k)}" for k in
                ("draft", "verify", "accept", "rollback")
            ) + "."
        )
    return "\n".join(lines)


def energy_tables(payload: dict) -> tuple[str, str] | None:
    """Render the energy payload (``BENCH_energy.json``) as two tables:
    the metered frontier (metered vs analytic GOPS/W, total/idle
    millijoules, energy per request, power-cap violations per grid
    point) and the per-class joule breakdown (mean per-request
    microjoules per QoS class plus the speculative draft/verify energy
    split where the plan speculates)."""
    if payload.get("bench") != "energy":
        return None
    rows = payload.get("rows")
    if not rows:
        return None
    head = ["point", "metered gops_w", "analytic gops_w", "total mJ",
            "idle mJ", "uJ/request", "cap violations"]
    frontier = [
        "| " + " | ".join(head) + " |",
        "|" + "|".join("---" for _ in head) + "|",
    ]
    for r in rows:
        epr = r.get("energy_per_request_pj")
        frontier.append(
            "| " + " | ".join([
                str(r.get("label")),
                _fmt(r.get("metered_gops_w")),
                _fmt(r.get("analytic_gops_w")),
                _fmt(r.get("total_mj"), 1),
                _fmt(r.get("idle_mj"), 1),
                _fmt(None if epr is None else epr * 1e-6, 1),
                str((r.get("power") or {}).get("violations", "—")),
            ]) + " |"
        )
    classes = sorted({
        q for r in rows for q in (r.get("per_class") or {})
    })
    head2 = (["point"] + [f"{q} uJ/req" for q in classes]
             + ["draft mJ", "verify mJ", "wasted mJ", "accept rate"])
    breakdown = [
        "| " + " | ".join(head2) + " |",
        "|" + "|".join("---" for _ in head2) + "|",
    ]
    for r in rows:
        pc = r.get("per_class") or {}
        cells = [str(r.get("label"))]
        for q in classes:
            m = (pc.get(q) or {}).get("mean_request_pj")
            cells.append(_fmt(None if m is None else m * 1e-6, 1))
        sp = r.get("spec")
        if sp:
            cells += [
                _fmt(sp.get("draft_pj", 0) * 1e-9, 1),
                _fmt(sp.get("verify_pj", 0) * 1e-9, 1),
                _fmt(sp.get("wasted_pj", 0) * 1e-9, 1),
                _fmt(sp.get("accept_rate")),
            ]
        else:
            cells += ["—", "—", "—", "—"]
        breakdown.append("| " + " | ".join(cells) + " |")
    return "\n".join(frontier), "\n".join(breakdown)


def build_report(ledger_path, bench_paths) -> tuple[str, dict]:
    """Assemble the full report; returns ``(markdown, json_payload)``."""
    entries = read_ledger(ledger_path)
    series = trend(entries)
    benches = read_benches(bench_paths)

    md: list[str] = ["# Bench ledger report", ""]
    md.append(
        f"Regenerated from committed artifacts: {len(entries)} ledger "
        f"entries ({os.path.basename(str(ledger_path))}), "
        f"{len(benches)} bench payloads. No benches were re-run."
    )
    md.append("")
    if series:
        md.append("## Trends (GOPS/W + latency headlines per revision)")
        md.append("")
        for table in trend_tables(series):
            md.append(table)
            md.append("")
    else:
        md.append("_No ledger entries found — trend section empty._")
        md.append("")

    span_sections = {}
    for bench in sorted(benches):
        table = span_tables(benches[bench])
        if table is None:
            continue
        span_sections[bench] = benches[bench].get("spans")
        md.append(f"## Span breakdown — {bench}")
        md.append("")
        md.append(
            "Exact-order-statistic requests (the actual p50/p99 request, "
            "not an interpolation), decomposed into queued / executing / "
            "preempted modeled cycles:"
        )
        md.append("")
        md.append(table)
        md.append("")

    spec = benches.get("specdecode")
    spec_md = specdecode_table(spec) if spec else None
    if spec_md:
        md.append("## Speculative decode — precision drafts, "
                  "full-digit verify")
        md.append("")
        md.append(
            "Truncated-plane drafts verified by the certified full-digit "
            "schedule (`BENCH_specdecode.json`): modeled decode speedup "
            "at bit-identical token streams, with every wasted "
            "speculation cycle charged:"
        )
        md.append("")
        md.append(spec_md)
        md.append("")

    capacity = benches.get("capacity")
    frontier_md = frontier_table(capacity) if capacity else None
    if frontier_md:
        md.append("## Capacity frontier — cost per SLO")
        md.append("")
        md.append(
            "Minimum shard count meeting every declared SLO per (plan, "
            "router, policy), under the shared diurnal workload "
            "(`BENCH_capacity.json`); attribution shows where the "
            "frontier fleet's residual misses come from:"
        )
        md.append("")
        md.append(frontier_md)
        md.append("")
    energy = benches.get("energy")
    energy_md = energy_tables(energy) if energy else None
    if energy_md:
        frontier_t, breakdown_t = energy_md
        md.append("## Energy frontier — metered joules")
        md.append("")
        md.append(
            "Joule-exact metering (`BENCH_energy.json`): worked cycles "
            "priced at each plan's plane-proportional pJ/cycle rate, "
            "idle cycles at static power, speculative drafts at the "
            "truncated draft-plane rate — vs the analytic figure that "
            "prices every elapsed cycle at full chip power:"
        )
        md.append("")
        md.append(frontier_t)
        md.append("")
        md.append("### Per-class joule breakdown")
        md.append("")
        md.append(
            "Mean metered energy per completed request by QoS class, "
            "with the speculative draft/verify/wasted energy split "
            "(integer-pJ ledger, reconciled online == offline):"
        )
        md.append("")
        md.append(breakdown_t)
        md.append("")

    slo_md = slo_tables(capacity) if capacity else None
    if slo_md:
        md.append("## SLO burn + miss attribution per grid point")
        md.append("")
        md.append(
            "Online `SloMonitor` verdicts (reconciled integer-exactly "
            "with offline span-derived misses): cumulative burn is the "
            "miss rate over the class budget (>1 = objective blown); "
            "misses split by dominant span segment:"
        )
        md.append("")
        md.append(slo_md)
        md.append("")

    payload = dict(
        schema="repro.obs.report",
        version=1,
        ledger_entries=len(entries),
        trends=series,
        capacity=dict(
            frontier=capacity.get("frontier"),
            gate_holds=_gate_holds(capacity),
        ) if capacity else None,
        benches={
            b: dict(
                bench=b,
                gate_holds=_gate_holds(p),
                spans=span_sections.get(b),
            )
            for b, p in sorted(benches.items())
        },
    )
    return "\n".join(md) + "\n", payload


def _gate_holds(payload: dict):
    gate = payload.get("gate")
    if not isinstance(gate, dict):
        return None
    holds = gate.get("holds")
    return bool(holds) if holds is not None else None
