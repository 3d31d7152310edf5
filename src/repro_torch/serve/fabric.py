"""Sharded serving fabric: N gateways behind a router, one fleet ledger (a
copy of the reference's ``serve/fabric.py``; host code on Python ints —
the shards' adapters may be real engines on a device or modeled ones).

One :class:`~repro_torch.serve.gateway.Gateway` is one modeled chip; the ROADMAP
north star (millions of users) needs a fleet.  The fabric runs N gateway
shards — each on its own :class:`~repro_torch.serve.clock.RoundClock`, advanced
in lock-step rounds of the shared ``round_budget`` — behind an arrival
router, with optional work stealing for idle capacity and a
:class:`~repro_torch.serve.clock.FleetLedger` accumulating per-round integer
deltas so aggregate ops/cycles equal the per-shard sums *exactly*
(MINT's compounding-error lesson, PAPERS.md).

Routers (all deterministic under a fixed ``seed``):

``'class'``
    Per-class sharding: each declared QoS class is pinned to one shard
    (sorted classes round-robin over shards).  Strongest isolation; load
    balance is whatever the class mix gives.
``'p2c'``
    Power-of-two-choices: two shards drawn from the counter-PRNG
    (:func:`repro_torch.workload.arrivals.counter_uniform` keyed on the
    dispatch counter), the less loaded one (queue depth, then
    outstanding estimated cycles) wins.  Classic near-optimal balance
    at O(1) state.
``'deficit'``
    Deficit-aware: the shard with the least outstanding *estimated*
    cycles (admission estimates added at dispatch, drained by actual
    worked cycles each round) gets the request — balances modeled work,
    not request counts.

Work stealing moves only **queued** (never admitted) requests — admitted
work owns engine slot state that cannot migrate — from the most
backlogged shard's queue tail to an idle shard, so the donor's own FIFO
order and per-class quanta are untouched.

The fabric duck-types the surface :func:`repro_torch.workload.replay.replay`
drives (``adapters``/``shares``/``clock``/``round_budget``/``rounds``/
``step_round``/``pending``/``stats``/``policy``), so the open-loop replay
harness serves a fabric unchanged: routing happens at arrival injection,
and each shard sees the same open-loop contract a single gateway does.

Shards are assumed homogeneous (same kinds, same pricing, same
``round_budget``) — shard 0's adapters price the routing estimates.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core import cycle_model as cm
from repro_torch.obs.events import NULL_SINK, Event, ShardSink
from repro_torch.workload.arrivals import counter_uniform

from .clock import FleetLedger, exact_percentile

ROUTERS = ("class", "p2c", "deficit")


class Fabric:
    """N gateway shards behind a deterministic router + fleet ledger.

    Args:
      shards: the gateway instances (homogeneous: identical kinds,
        shares and ``round_budget``; independent clocks).
      router: ``'class' | 'p2c' | 'deficit'`` (module docstring).
      seed: PRNG seed for the p2c router's counter-keyed draws.
      steal: move queued requests from backlogged to idle shards at
        round boundaries.
      steal_batch: max requests moved per thief per round.
      sink: optional telemetry sink (:mod:`repro_torch.obs.events`).  The
        fabric emits its own routing/steal events and arms every shard
        through a :class:`~repro_torch.obs.events.ShardSink`, so the combined
        stream carries a ``shard`` tag on every shard-side event.
        Default: the null sink (no events, no behavior change).
    """

    def __init__(self, shards, *, router: str = "p2c", seed: int = 0,
                 steal: bool = True, steal_batch: int = 4, sink=None):
        shards = list(shards)
        if not shards:
            raise ValueError("fabric needs at least one shard")
        if router not in ROUTERS:
            raise ValueError(f"unknown router {router!r}; one of {ROUTERS}")
        budgets = {g.round_budget for g in shards}
        if len(budgets) > 1:
            raise ValueError(
                f"shards must share one round_budget (lock-step rounds), "
                f"got {sorted(budgets)}"
            )
        kinds0 = set(shards[0].adapters)
        shares0 = set(shards[0].shares)
        for i, g in enumerate(shards[1:], start=1):
            if set(g.adapters) != kinds0 or set(g.shares) != shares0:
                raise ValueError(
                    f"shard {i} serves kinds {sorted(g.adapters)} / classes "
                    f"{sorted(g.shares)} but shard 0 serves "
                    f"{sorted(kinds0)} / {sorted(shares0)} — fabric shards "
                    f"must be homogeneous"
                )
        if any(g.clock != shards[0].clock for g in shards):
            raise ValueError("shards must start on equal clocks (lock-step)")
        self.shards = shards
        self.router = router
        self.seed = int(seed)
        self.steal = bool(steal)
        self.steal_batch = int(steal_batch)
        n = len(shards)
        self.ledger = FleetLedger(n)
        # per-class pinning for the 'class' router: sorted declared
        # classes round-robin over shards — deterministic by construction
        classes = sorted(shards[0].shares)
        self.class_map = {c: i % n for i, c in enumerate(classes)}
        self._dispatch_counter = 0
        self._outstanding = [0] * n  # routed-but-undrained estimated cycles
        self._prev = [g.ledger_snapshot() for g in shards]
        self.dispatched = [0] * n  # arrivals routed per shard
        # router-decision quality counters (always maintained — integer
        # bumps, independent of any armed sink, so instrumented and
        # uninstrumented runs report identical stats):
        #   decided          routing decisions with a real alternative
        #   chose_shallower  chosen queue strictly shallower than the alt
        #   tie              chosen and alternative depths equal
        #   depth_gap_sum    Σ (alt depth - chosen depth) over decisions
        self.route_quality = dict(
            decided=0, chose_shallower=0, tie=0, depth_gap_sum=0,
        )
        self.stolen = 0  # requests moved by work stealing (lifetime)
        self.stolen_from = [0] * n
        self.stolen_to = [0] * n
        self._obs = NULL_SINK
        self._obs_on = False
        self.set_sink(sink)

    # ---------------------------------------------------------- telemetry

    @property
    def sink(self):
        return self._obs

    def set_sink(self, sink) -> None:
        """Arm (or disarm, with ``None``) one telemetry sink fleet-wide:
        the fabric's own route/steal events plus every shard's stream,
        shard-tagged through :class:`~repro_torch.obs.events.ShardSink`."""
        self._obs = NULL_SINK if sink is None else sink
        self._obs_on = bool(getattr(self._obs, "enabled", True))
        for i, g in enumerate(self.shards):
            g.set_sink(ShardSink(self._obs, i) if self._obs_on else None)

    # ------------------------------------------------- replay duck-typing

    @property
    def adapters(self) -> dict[str, Any]:
        """Served kinds (shard 0's adapters — shards are homogeneous)."""
        return self.shards[0].adapters

    @property
    def shares(self) -> dict[str, float]:
        return self.shards[0].shares

    @property
    def round_budget(self) -> int:
        return self.shards[0].round_budget

    @property
    def clock(self) -> int:
        """The lock-step fleet clock (all shards agree between rounds)."""
        return self.shards[0].clock

    @property
    def rounds(self) -> int:
        return self.shards[0].rounds

    @property
    def policy(self) -> str:
        """Descriptive label in the shape replay row names expect."""
        return (
            f"fabric{len(self.shards)}x-{self.router}"
            f"-{self.shards[0].policy}"
        )

    @property
    def requests(self) -> list:
        """All requests fleet-wide, shard-major (stolen requests appear
        under the shard that completed them)."""
        return [g for shard in self.shards for g in shard.requests]

    def pending(self) -> bool:
        return any(g.pending() for g in self.shards)

    # ------------------------------------------------------------ routing

    def _estimate(self, kind: str, payload, kw: dict):
        """Prepare once (idempotent at the shard) and price the admission
        estimate with shard 0's adapter — shards price identically."""
        adapter = self.shards[0].adapters[kind]
        prep_kw = {
            k: v for k, v in kw.items()
            if k not in ("qos", "deadline_cycles")
        }
        prepared = adapter.prepare(payload, rid=-1, **prep_kw)
        return prepared, int(adapter.estimate_cycles(prepared))

    def _route(self, qos: str, est: int) -> tuple[int, int | None]:
        """Pick the destination shard; returns ``(dst, alt)`` where
        ``alt`` is the shard the decision rejected (the p2c losing draw,
        the deficit router's most-loaded shard) — ``None`` when the
        decision had no alternative (class pinning, single shard, p2c
        drawing the same shard twice)."""
        n = len(self.shards)
        if n == 1:
            return 0, None
        if self.router == "class":
            return self.class_map[qos], None
        if self.router == "deficit":
            # least outstanding modeled work; ties to the lowest index
            dst = min(range(n), key=lambda s: (self._outstanding[s], s))
            alt = max(range(n), key=lambda s: (self._outstanding[s], -s))
            return dst, (None if alt == dst else alt)
        # p2c: two counter-keyed draws, the less loaded shard wins
        k = self._dispatch_counter
        i = int(counter_uniform(self.seed, 2 * k) * n)
        j = int(counter_uniform(self.seed, 2 * k + 1) * n)
        load = lambda s: (len(self.shards[s].queue), self._outstanding[s], s)
        dst = min(i, j, key=load)
        return dst, (None if i == j else (j if dst == i else i))

    def _record_route_quality(self, dst: int, alt: int | None) -> None:
        rq = self.route_quality
        rq["decided"] += 1
        if alt is None:  # pinned / single shard / p2c same draw:
            return       # no alternative to compare against
        dq, aq = len(self.shards[dst].queue), len(self.shards[alt].queue)
        if dq < aq:
            rq["chose_shallower"] += 1
        elif dq == aq:
            rq["tie"] += 1
        rq["depth_gap_sum"] += aq - dq

    # ------------------------------------------------------ work stealing

    def _steal_pass(self) -> None:
        """Round-boundary rebalance: an idle shard (empty queue, free
        slots) takes up to ``steal_batch`` queued requests from the most
        backlogged shard's tail.  Donor keeps at least one queued request
        (it will admit next round anyway); only never-admitted requests
        move, so donor per-class accounting is untouched."""
        n = len(self.shards)
        for t, thief in enumerate(self.shards):
            if len(thief.queue) > 0:
                continue
            free = sum(a.free_slots() for a in thief.adapters.values())
            if free < 1:
                continue
            d = max(range(n), key=lambda s: (len(self.shards[s].queue), -s))
            donor = self.shards[d]
            surplus = len(donor.queue) - 1
            take = min(self.steal_batch, free, surplus)
            if d == t or take < 1:
                continue
            src_q = len(donor.queue)  # donor depth at the decision
            moved = donor.export_queued(take)
            thief.import_queued(moved)
            est_moved = sum(g.est_cycles for g in moved)
            if self._obs_on and moved:
                # src_q/dst_q: queue depths the decision saw (thief was
                # empty by the steal precondition) — steal pressure is
                # readable off the stream without replaying state
                self._obs.emit(Event(self.clock, "steal", dict(
                    src=d, dst=t, n=len(moved), est=est_moved,
                    src_q=src_q, dst_q=0,
                )))
            self._outstanding[d] = max(self._outstanding[d] - est_moved, 0)
            self._outstanding[t] += est_moved
            self.stolen += len(moved)
            self.stolen_from[d] += len(moved)
            self.stolen_to[t] += len(moved)

    # ------------------------------------------------------------- rounds

    def step_round(self, arrivals=()) -> None:
        """One lock-step fleet round: route this round's arrivals to
        shards, rebalance idle capacity, step every shard one round, and
        post each shard's integer deltas to the fleet ledger."""
        n = len(self.shards)
        by_shard: list[list] = [[] for _ in range(n)]
        for cyc, kind, payload, kw in sorted(arrivals, key=lambda a: a[0]):
            prepared, est = self._estimate(kind, payload, kw)
            qos = kw.get("qos") or kind
            s, alt = self._route(qos, est)
            self._record_route_quality(s, alt)
            if self._obs_on:
                # chosen-vs-alternative depths make router quality
                # inspectable from the stream (p2c's classic diagnostic);
                # emitted before the counters move, at decision state
                data = dict(kind=kind, qos=qos, dst=s, est=est,
                            q=len(self.shards[s].queue))
                if alt is not None:
                    data.update(alt=alt, alt_q=len(self.shards[alt].queue))
                self._obs.emit(Event(int(cyc), "route", data))
            self._dispatch_counter += 1
            self.dispatched[s] += 1
            self._outstanding[s] += est
            by_shard[s].append((cyc, kind, prepared, kw))
        if self.steal:
            self._steal_pass()
        for s, gw in enumerate(self.shards):
            gw.step_round(arrivals=by_shard[s])
        # post per-round deltas to the fleet ledger — the incremental
        # path additivity() later verifies against the direct sums
        for s, gw in enumerate(self.shards):
            snap = gw.ledger_snapshot()
            prev = self._prev[s]
            d_class = {
                c: v - prev["class_worked"].get(c, 0)
                for c, v in snap["class_worked"].items()
                if v - prev["class_worked"].get(c, 0)
            }
            d_worked = snap["worked"] - prev["worked"]
            self.ledger.record_round(
                s,
                d_ops=snap["ops"] - prev["ops"],
                d_worked=d_worked,
                d_class_worked=d_class,
            )
            self._prev[s] = snap
            self._outstanding[s] = max(self._outstanding[s] - d_worked, 0)
        self.ledger.rounds += 1

    def advance_to(self, cycle: int) -> None:
        while self.clock < cycle:
            self.step_round()

    def drain(self, *, max_rounds: int = 100_000) -> None:
        while self.pending():
            if self.rounds >= max_rounds:
                raise RuntimeError(
                    f"fabric did not drain within {max_rounds} rounds "
                    f"(queues={[len(g.queue) for g in self.shards]})"
                )
            self.step_round()

    # -------------------------------------------------------------- stats

    def additivity(self) -> dict:
        """The fleet ledger's exact-additivity check against the shards'
        own cumulative counters (the fabric bench gates on ``holds``)."""
        return self.ledger.additivity(
            [g.ledger_snapshot()["ops"] for g in self.shards],
            [g.round_clock for g in self.shards],
        )

    def stats(self) -> dict:
        """Fleet-aggregate stats in the single-gateway ``stats()`` shape
        (plus fabric extras), so ``workload.replay.summarize`` and the
        bench tracker consume a fabric unchanged.

        GOPS/W is fleet-honest: total ops over the lock-step elapsed
        time, against N chips' worth of the paper's modeled power.
        Percentiles are exact order statistics, matching the single
        gateway's ``stats()`` semantics.
        """
        classes = list(self.shares)
        for g in self.requests:
            if g.qos not in classes:
                classes.append(g.qos)
        per_class: dict[str, dict] = {}
        for c in classes:
            of_c = [g for g in self.requests if g.qos == c]
            if not of_c and c not in self.adapters:
                continue
            lats = [g.latency_ms for g in of_c if g.done]
            p50 = exact_percentile(lats, 50)
            p99 = exact_percentile(lats, 99)
            per_class[c] = dict(
                n=len(of_c),
                completed=len(lats),
                p50_ms=None if p50 is None else float(p50),
                p99_ms=None if p99 is None else float(p99),
                max_ms=float(max(lats)) if lats else None,
                # fleet-wide: stolen requests count under the shard that
                # completed them, so the sum over shards is exact
                deadline_misses=sum(
                    1 for g in of_c if g.done and g.finished > g.deadline
                ),
            )
        add = self.additivity()
        total_ops = add["ledger_total_ops"]
        elapsed_s = max(g.clock for g in self.shards) / cm.FREQ_HZ
        chip_power = (
            cm.PAPER_TABLE1["proposed"]["gops"]
            / cm.PAPER_TABLE1["proposed"]["gops_w"]
        )
        power = chip_power * len(self.shards)
        gops = total_ops / elapsed_s / 1e9 if elapsed_s > 0 else 0.0
        out = dict(
            policy=self.policy,
            n_shards=len(self.shards),
            router=self.router,
            rounds=self.rounds,
            clock_cycles=max(g.clock for g in self.shards),
            per_class=per_class,
            total_ops=total_ops,
            gops=gops,
            gops_w=gops / power,
            forced=sum(g.forced for g in self.shards),
            worked_cycles=add["ledger_total_worked"],
            additivity=add,
            dispatched=list(self.dispatched),
            router_stats=dict(router=self.router, **self.route_quality),
            stolen=self.stolen,
            stolen_from=list(self.stolen_from),
            stolen_to=list(self.stolen_to),
            # fleet totals are the exact sums of the per_shard addends
            # below — same additivity discipline the ledger is gated on
            tile_events_seen=sum(
                g._tile_events_seen for g in self.shards
            ),
            tile_events_kept=sum(
                len(g.tile_events) for g in self.shards
            ),
            tile_events_dropped=sum(
                g._tile_events_seen - len(g.tile_events)
                for g in self.shards
            ),
            per_shard=[
                dict(
                    rounds=g.rounds,
                    clock_cycles=g.clock,
                    queue=len(g.queue),
                    ops=self.ledger.ops[s],
                    worked=self.ledger.worked[s],
                    forced=g.forced,
                    tile_events_seen=g._tile_events_seen,
                    tile_events_kept=len(g.tile_events),
                    tile_events_dropped=g._tile_events_seen
                    - len(g.tile_events),
                )
                for s, g in enumerate(self.shards)
            ],
        )
        # an armed SloMonitor surfaces fleet-aggregated burn rates +
        # miss attribution (per-shard scopes via monitor.summary(shard))
        from repro_torch.obs.slo import FLEET, find_monitor

        mon, _ = find_monitor(self._obs)
        if mon is not None:
            out["slo"] = mon.summary(scope=FLEET)
        # an armed EnergyMeter surfaces the fleet joule ledger; metered
        # GOPS/W divides fleet ops by fleet metered energy — the
        # per-shard scopes stay queryable via meter.summary(shard)
        from repro_torch.core import energy_model as em
        from repro_torch.obs.energy import find_meter

        meter, _ = find_meter(self._obs)
        if meter is not None:
            eb = meter.summary(scope=FLEET)
            eb["metered_gops_w"] = em.metered_gops_per_w(
                total_ops, eb["total_pj"]
            )
            eb["analytic_gops_w"] = out["gops_w"]
            out["energy"] = eb
        return out
