"""Shared cycle-clock + per-round ledger primitives (a copy of the
reference's ``serve/clock.py``; no tensor is touched here).

Every scheduler advances the same currency — relation-(2) modeled cycles
(``core.cycle_model``) — in discrete rounds.  Three consumers share this
bookkeeping: the single :class:`~repro_torch.serve.gateway.Gateway` (one
modeled chip), each shard of a :class:`~repro_torch.serve.fabric.Fabric`
(N chips on independent clocks), and the fleet
ledger that must aggregate them *exactly*.  The accounting is written once,
so a fabric of N gateways cannot drift from N copies of the single
gateway's arithmetic.

Two layers:

:class:`RoundClock`
    One scheduler's modeled clock and per-round work ledger: the absolute
    cycle counter, the round counter, intra-round spent/worked split
    (*spent* includes admission charges and idle flow to segment
    boundaries; *worked* is cycles actually consumed by micro-steps), the
    per-class worked account the fair policy's starvation escape watches,
    and cumulative totals the fleet ledger aggregates.  All integers, no
    floats — exactness is the point.

:class:`FleetLedger`
    Cross-shard aggregate accounting, accumulated **incrementally** from
    per-round deltas rather than recomputed from totals.  MINT's lesson
    (PAPERS.md) is that per-unit accounting errors compound silently when
    parallel instances are summed after the fact; here the incremental
    path and the direct sum are both kept, and
    :meth:`FleetLedger.additivity` verifies they agree to the integer —
    the fabric bench gates on it.
"""
from __future__ import annotations

import math


def exact_percentile(values, pct: float):
    """Exact order statistic: the smallest observed value with at least
    ``ceil(pct/100 * n)`` observations at or below it.

    The stack's single percentile semantics (gateway ``stats()``, fabric
    ``stats()``, replay summaries, span breakdowns): a p99 is always an
    *actual observed latency* — never ``np.percentile``'s interpolation
    between two observations, which on the small per-class samples the
    bench gates compare can manufacture values nobody experienced.
    Returns ``None`` on an empty sample.
    """
    vals = sorted(values)
    if not vals:
        return None
    k = math.ceil(pct / 100.0 * len(vals))
    return vals[min(max(k, 1), len(vals)) - 1]


class RoundClock:
    """Modeled cycle clock + per-round ledger for one scheduler.

    Lifecycle per scheduling round::

        clk.begin_round()
        clk.record_spent(charge)          # admission charges (atomic mode)
        clk.record_work(consumed, qos)    # each micro-step batch
        clk.idle_to(limit)                # time flows to a segment boundary
        clk.end_round(round_budget)       # clock advances one round

    ``cycles`` is the *round-start* absolute clock while a round is in
    flight (``end_round`` advances it), matching the gateway's historical
    ``Gateway.clock`` semantics exactly.
    """

    __slots__ = (
        "cycles", "rounds", "forced",
        "worked_total", "class_worked_total",
        "round_spent", "round_worked", "round_class_worked",
        "obs",
    )

    def __init__(self) -> None:
        self.cycles = 0  # absolute modeled clock (round start)
        self.rounds = 0
        self.forced = 0  # forced-progress overdraft steps (liveness)
        self.worked_total = 0  # cumulative cycles consumed by micro-steps
        self.class_worked_total: dict[str, int] = {}
        self.round_spent = 0  # intra-round modeled time (work + idle)
        self.round_worked = 0  # cycles actually consumed this round
        self.round_class_worked: dict[str, int] = {}
        # optional telemetry sink (repro_torch.obs.events); None keeps this
        # module dependency-free and the hot path a single None check
        self.obs = None

    # ------------------------------------------------------------- rounds

    def begin_round(self) -> None:
        self.round_spent = 0
        self.round_worked = 0
        self.round_class_worked = {}

    def record_spent(self, cycles: int) -> None:
        """Charge intra-round modeled time that is *not* micro-step work
        (atomic-mode admission charges): it eats the round but does not
        count as class progress for the starvation escape."""
        self.round_spent += int(cycles)

    def record_work(self, consumed: int, qos: str | None = None) -> None:
        """Charge ``consumed`` cycles of real micro-step work, attributed
        to scheduling class ``qos`` when given."""
        consumed = int(consumed)
        self.round_spent += consumed
        self.round_worked += consumed
        self.worked_total += consumed
        if qos is not None:
            self.round_class_worked[qos] = (
                self.round_class_worked.get(qos, 0) + consumed
            )
            self.class_worked_total[qos] = (
                self.class_worked_total.get(qos, 0) + consumed
            )

    def idle_to(self, limit: int) -> None:
        """Modeled time flows to an intra-round boundary: capacity nobody
        could use is spent as idle, never banked."""
        self.round_spent = max(self.round_spent, int(limit))

    def end_round(self, round_budget: int) -> None:
        if self.obs is not None:
            from repro_torch.obs.events import Event

            self.obs.emit(Event(
                self.cycles + int(round_budget), "round",
                dict(round=self.rounds, spent=self.round_spent,
                     worked=self.round_worked),
            ))
        self.cycles += int(round_budget)
        self.rounds += 1

    # -------------------------------------------------------------- views

    def snapshot(self) -> dict:
        """The cumulative counters a fleet ledger aggregates."""
        return dict(
            cycles=self.cycles,
            rounds=self.rounds,
            forced=self.forced,
            worked_total=self.worked_total,
            class_worked_total=dict(self.class_worked_total),
        )


class FleetLedger:
    """Exact aggregate accounting over N shard clocks.

    The fabric calls :meth:`record_round` once per shard per fabric round
    with that round's integer deltas (ops emitted, cycles worked, per-
    class worked).  Totals are therefore accumulated along the same path
    the work happened on; :meth:`additivity` re-derives the same totals
    directly from the shards' own cumulative counters and reports whether
    the two agree exactly — the compounding-error gate.
    """

    def __init__(self, n_shards: int) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards {n_shards} < 1")
        self.n_shards = int(n_shards)
        self.ops = [0] * self.n_shards  # accumulated per-round ops deltas
        self.worked = [0] * self.n_shards  # accumulated worked-cycle deltas
        self.class_worked: list[dict[str, int]] = [
            {} for _ in range(self.n_shards)
        ]
        self.rounds = 0

    def record_round(self, shard: int, *, d_ops: int, d_worked: int,
                     d_class_worked: dict[str, int] | None = None) -> None:
        if d_ops < 0 or d_worked < 0:
            raise ValueError(
                f"negative per-round delta on shard {shard}: "
                f"ops={d_ops} worked={d_worked}"
            )
        self.ops[shard] += int(d_ops)
        self.worked[shard] += int(d_worked)
        if d_class_worked:
            cw = self.class_worked[shard]
            for c, d in d_class_worked.items():
                cw[c] = cw.get(c, 0) + int(d)

    @property
    def total_ops(self) -> int:
        return sum(self.ops)

    @property
    def total_worked(self) -> int:
        return sum(self.worked)

    def additivity(self, shard_ops, shard_clocks) -> dict:
        """Verify the incrementally-accumulated aggregates equal the
        direct per-shard sums *exactly* (integer equality, no tolerance).

        ``shard_ops`` is each shard's own cumulative useful-op counter;
        ``shard_clocks`` its :class:`RoundClock`.  Returns the comparison
        (both sides of each total) with ``holds`` — the fabric bench and
        the property tests gate on it.
        """
        direct_ops = [int(o) for o in shard_ops]
        direct_worked = [c.worked_total for c in shard_clocks]
        holds = (
            self.ops == direct_ops
            and self.worked == direct_worked
            and all(
                self.class_worked[s] == shard_clocks[s].class_worked_total
                for s in range(self.n_shards)
            )
        )
        return dict(
            holds=bool(holds),
            ledger_total_ops=self.total_ops,
            direct_total_ops=sum(direct_ops),
            ledger_total_worked=self.total_worked,
            direct_total_worked=sum(direct_worked),
            per_shard_ops=list(self.ops),
            per_shard_worked=list(self.worked),
        )
