"""Per-request span assembly + exact latency breakdowns (a copy of the
reference's ``obs/spans.py``: host code on Python ints, no tensors).

A *span* is one request's life on the modeled clock, decomposed into
three integer cycle segments:

``queued``
    arrival → effective admission.  The gateway stamps admission at the
    round-start clock, which for a mid-round arrival can precede the
    arrival itself (admission happens at the next admission pass but is
    stamped at the round's start) — so the effective admission is
    ``max(admitted, arrival)`` and queueing is never negative.

``executing``
    the sum of the request's ``exec`` attribution events — the cycles
    its own micro-steps actually consumed.

``preempted``
    everything else between effective admission and completion: cycles
    the request sat admitted but not running (other classes' quanta,
    its own class's other requests, idle flow to segment boundaries).
    Defined as the residual ``total - queued - executing``, so the three
    segments sum to the request's latency *by construction* — exactness
    is an identity here; what the tests pin is that ``executing`` also
    reconciles with the :class:`~repro_torch.serve.clock.RoundClock` /
    :class:`~repro_torch.serve.clock.FleetLedger` worked totals
    (:func:`reconcile`).  The one case where the residual can go
    negative is a forced-progress overdraft (a single step bigger than
    the round budget clamps its completion stamp to the round end);
    such spans carry ``overdrafted=True``.

Spans are keyed ``(shard, rid)`` — rids are shard-local.  A stolen
request's donor-side ``submit`` is superseded by the thief-side
``import`` event (which carries the original arrival), so its span is
assembled where it completed, with latency measured from the true
arrival; the abandoned donor span is simply never completed and drops
out of the breakdowns.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import cycle_model as cm


@dataclass
class Span:
    """One request's assembled life on the modeled clock (cycles)."""

    rid: int
    qos: str | None
    kind: str | None
    shard: int | None
    arrival: int | None = None
    admitted: int | None = None
    finished: int | None = None
    deadline: int | None = None
    exec_cycles: int = 0
    n_exec: int = 0
    #: attributed energy in integer picojoules, populated by the
    #: reference's ``obs.energy.attach_joules`` from an armed
    #: ``EnergyMeter`` (not ported yet; None: no meter rode the run —
    #: latency-only span)
    pj: int | None = None

    @property
    def joules(self) -> float | None:
        return None if self.pj is None else self.pj * 1e-12

    @property
    def done(self) -> bool:
        return self.arrival is not None and self.finished is not None

    @property
    def missed_deadline(self) -> bool:
        """Completed past the absolute deadline its submit/import event
        carried (the offline truth the reference's ``obs.attrib`` and its
        online ``SloMonitor`` are reconciled on)."""
        return (
            self.done
            and self.deadline is not None
            and self.finished > self.deadline
        )

    @property
    def admitted_eff(self) -> int | None:
        """Effective admission: never before the arrival (see module
        docstring on round-start admission stamps)."""
        if self.arrival is None:
            return self.admitted
        if self.admitted is None:
            return None
        return max(self.admitted, self.arrival)

    @property
    def total(self) -> int | None:
        if not self.done:
            return None
        return self.finished - self.arrival

    @property
    def queued(self) -> int | None:
        if self.arrival is None or self.admitted_eff is None:
            return None
        return self.admitted_eff - self.arrival

    @property
    def executing(self) -> int:
        return self.exec_cycles

    @property
    def preempted(self) -> int | None:
        """Residual: total - queued - executing (may be negative only on
        forced overdrafts — see module docstring)."""
        if not self.done or self.queued is None:
            return None
        return self.total - self.queued - self.exec_cycles

    @property
    def overdrafted(self) -> bool:
        p = self.preempted
        return p is not None and p < 0


def _key(e) -> tuple:
    return (e.data.get("shard"), e.data["rid"])


def assemble(events) -> list[Span]:
    """Fold an event stream into per-request spans.

    Consumes ``submit`` / ``import`` / ``admit`` / ``exec`` / ``complete``
    events (others pass through untouched).  Returns every span seen —
    completed or not; breakdowns filter on :attr:`Span.done`.
    """
    spans: dict[tuple, Span] = {}
    for e in events:
        et = e.etype
        if et not in ("submit", "import", "admit", "exec", "complete"):
            continue
        d = e.data
        k = _key(e)
        sp = spans.get(k)
        if sp is None:
            sp = spans[k] = Span(
                rid=int(d["rid"]), qos=d.get("qos"), kind=d.get("kind"),
                shard=d.get("shard"),
            )
        if et in ("submit", "import"):
            # import re-keys a stolen request: its arrival travels with it
            sp.arrival = int(d.get("arrival", e.cycle))
            if d.get("deadline") is not None:
                sp.deadline = int(d["deadline"])
            sp.qos = d.get("qos", sp.qos)
            sp.kind = d.get("kind", sp.kind)
        elif et == "admit":
            sp.admitted = e.cycle
            sp.qos = d.get("qos", sp.qos)
            sp.kind = d.get("kind", sp.kind)
        elif et == "exec":
            sp.exec_cycles += int(d["cycles"])
            sp.n_exec += 1
            if sp.qos is None:
                sp.qos = d.get("qos")
        else:  # complete
            sp.finished = e.cycle
            sp.qos = d.get("qos", sp.qos)
            sp.kind = d.get("kind", sp.kind)
    return list(spans.values())


def _ms(cycles: int) -> float:
    return cycles / cm.FREQ_HZ * 1e3


def breakdown(spans, pcts=(50, 99)) -> dict:
    """Exact-order-statistic latency breakdowns, per class.

    For each class and percentile ``p``, the breakdown names the *actual
    request* at that order statistic (the same
    :func:`~repro_torch.serve.clock.exact_percentile` semantics ``stats()``
    uses) and decomposes its latency into queued / executing / preempted
    cycles — so "the p99 is 11 ms" comes with "of which 7 ms was
    queueing behind the batch class's quantum".
    """
    from repro_torch.serve.clock import exact_percentile

    done = [s for s in spans if s.done and s.queued is not None]
    per_class: dict[str, dict] = {}
    for s in done:
        per_class.setdefault(s.qos, []).append(s)
    out: dict[str, dict] = {}
    for qos in sorted(per_class, key=str):
        group = sorted(per_class[qos], key=lambda s: s.total)
        totals = [s.total for s in group]
        entry: dict = dict(
            n=len(group),
            queued_cycles=sum(s.queued for s in group),
            exec_cycles=sum(s.exec_cycles for s in group),
            preempted_cycles=sum(s.preempted for s in group),
            overdrafted=sum(1 for s in group if s.overdrafted),
        )
        for p in pcts:
            t = exact_percentile(totals, p)
            s = group[totals.index(t)]  # the order-statistic request
            entry[f"p{p}"] = dict(
                rid=s.rid,
                shard=s.shard,
                total_cycles=s.total,
                queued_cycles=s.queued,
                exec_cycles=s.exec_cycles,
                preempted_cycles=s.preempted,
                total_ms=_ms(s.total),
                queued_ms=_ms(s.queued),
                exec_ms=_ms(s.exec_cycles),
                preempted_ms=_ms(s.preempted),
            )
        out[qos] = entry
    return out


def reconcile(events, clocks, ledger=None) -> dict:
    """Integer-exact reconciliation of the event stream's execution
    attribution against the authoritative cycle ledgers.

    Sums every ``exec`` event's cycles (all requests, finished or not)
    per shard and compares with each shard's
    :attr:`~repro_torch.serve.clock.RoundClock.worked_total`; with ``ledger``
    (a :class:`~repro_torch.serve.clock.FleetLedger`) also against the
    incrementally-accumulated per-shard worked totals.  ``holds`` is the
    gate — equality to the integer, no tolerance.
    """
    clocks = list(clocks)
    per_shard = [0] * len(clocks)
    for e in events:
        if e.etype != "exec":
            continue
        s = e.data.get("shard")
        per_shard[0 if s is None else int(s)] += int(e.data["cycles"])
    worked = [c.worked_total for c in clocks]
    holds = per_shard == worked
    out = dict(
        holds=bool(holds),
        exec_cycles=per_shard,
        worked_total=worked,
        total_exec=sum(per_shard),
        total_worked=sum(worked),
    )
    if ledger is not None:
        out["ledger_worked"] = list(ledger.worked)
        out["holds"] = bool(holds and per_shard == list(ledger.worked))
    return out
