"""Joule-exact energy metering on the event bus (a copy of the reference's
``obs/energy.py``).  The picojoules are the paper's FPGA energy model
(relation-(2) cycles times plane-proportional rates), not a card reading.

:class:`EnergyMeter` is an event-bus sink (composable exactly like
:class:`~repro_torch.obs.slo.SloMonitor`: arm it directly, teed, or wrapped in
:class:`~repro_torch.obs.events.ShardSink`\\ s by a fabric) that streams the
``exec`` / ``round`` / ``draft`` / ``verify`` / ``accept`` / ``complete``
events a gateway or fabric already emits into **integer-picojoule**
energy attribution (:mod:`repro_torch.core.energy_model` rates):

* every ``exec`` quantum is *active* energy — cycles x the per-kind
  pJ/cycle rate (static + plane-proportional dynamic switching for the
  kind's plane schedule) — attributed to its request, QoS class, shard
  and the fleet;
* every ``round`` boundary charges *idle* energy — static pJ for each
  elapsed-but-unworked cycle of that round (the round events carry
  ``worked``; elapsed is the distance between consecutive round stamps);
* speculative ``draft`` / ``verify`` / ``accept`` events feed a per-op-
  class account: draft cycles priced at the truncated draft-plane rate,
  verify cycles at the full-digit rate, with the wasted/useful split
  closing integer-exactly the way
  :func:`~repro_torch.core.cycle_model.lm_spec_step_cycles` closes cycles
  (the per-slot ``accept`` cycle fields re-derive the round-level
  draft/verify totals — two independent event paths, gated equal).
  Each ``accept`` also *rebates* the request's exec charge from the
  full-digit rate down to the draft rate for its draft cycles, so the
  headline attribution prices op classes at their true plane widths.

The :class:`EnergyLedger` inside the meter carries the reconciliation
invariants, all in ``int`` pJ so ``reconcile()`` gates equality to the
picojoule, never within-epsilon:

1. per-shard ``active + idle`` sums equal the independently-accumulated
   fleet totals (the :class:`~repro_torch.serve.clock.FleetLedger` discipline,
   applied to joules);
2. per-request attributed pJ (completed + in-flight) sum to ledger
   active energy, per shard and fleet;
3. per-class pJ sums equal active energy;
4. the speculative draft/verify account closes: slot-level cycles equal
   round-level cycles, and ``useful_pj + wasted_pj == draft_pj +
   verify_pj``.

:class:`PowerSpec` adds power-*cap* observability on the same bucketed-
ring machinery as the SLO burn windows: a per-shard watt budget over a
rolling cycle window; charges that push the rolling average above budget
count violations (edge-triggered), optionally emitting ``power-cap``
events into a side sink.

Arm the meter before traffic (``gateway.set_sink(meter)`` or tee it) —
rounds observed from an unseen prefix are counted ``untracked_rounds``
and charge idle only for their reported ``spent`` span, mirroring the
SloMonitor's untracked-completion discipline.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import energy_model as em
from repro_torch.core.cycle_model import FREQ_HZ

from .events import Event, ShardSink, TeeSink
from .slo import FLEET


@dataclass(frozen=True)
class PowerSpec:
    """A per-shard power cap: rolling average power over ``window``
    modeled cycles must stay within ``watts``.

    Args:
      watts: the budget in watts.
      window: rolling window length in modeled cycles.
      buckets: ring granularity (watts resolution <= 1 bucket).
    """

    watts: float
    window: int = 3_200_000
    buckets: int = 32

    def __post_init__(self):
        if self.watts <= 0:
            raise ValueError(f"watts {self.watts} <= 0")
        if self.window <= 0:
            raise ValueError(f"window {self.window} <= 0")
        if self.buckets < 1:
            raise ValueError(f"buckets {self.buckets} < 1")

    def to_dict(self) -> dict:
        return dict(watts=self.watts, window=self.window,
                    buckets=self.buckets)


class _PowerWindow:
    """Bucketed pJ ring over one rolling window of the modeled clock —
    the :class:`~repro_torch.obs.slo._Window` burn-rate shape, accumulating
    picojoules instead of miss counts."""

    __slots__ = ("window", "buckets", "width", "pj", "_cur")

    def __init__(self, window: int, buckets: int):
        self.window = int(window)
        self.buckets = int(buckets)
        self.width = max(self.window // self.buckets, 1)
        self.pj = [0] * self.buckets
        self._cur = None

    def record(self, cycle: int, pj: int) -> None:
        b = cycle // self.width
        if self._cur is None:
            self._cur = b
        elif b > self._cur:
            for k in range(self._cur + 1,
                           min(b, self._cur + self.buckets) + 1):
                self.pj[k % self.buckets] = 0
            self._cur = b
        idx = (b if self._cur - b < self.buckets else
               self._cur - self.buckets + 1) % self.buckets
        self.pj[idx] += pj

    def watts(self) -> float:
        """Rolling average power over the window (0.0 when empty)."""
        return sum(self.pj) * FREQ_HZ / self.window * 1e-12


class _SpecAccount:
    """Per-scope speculative op-class energy account (module docstring
    invariant 4)."""

    __slots__ = ("draft_cycles", "verify_cycles", "draft_pj", "verify_pj",
                 "slot_draft_cycles", "slot_verify_cycles", "slot_pj",
                 "wasted_pj", "rounds", "drafted", "accepted")

    def __init__(self):
        self.draft_cycles = 0
        self.verify_cycles = 0
        self.draft_pj = 0
        self.verify_pj = 0
        # re-derived from per-slot accept events (independent path)
        self.slot_draft_cycles = 0
        self.slot_verify_cycles = 0
        self.slot_pj = 0
        self.wasted_pj = 0
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0


class _ScopeState:
    """One scope's (shard / ``None`` / fleet) integer energy ledger
    entry plus the rolling power ring."""

    __slots__ = ("active_pj", "idle_pj", "worked_cycles", "idle_cycles",
                 "rounds", "untracked_rounds", "completions", "class_pj",
                 "class_cycles", "request_pj", "spec", "ring",
                 "peak_watts", "violations", "over_budget_charges",
                 "_over")

    def __init__(self, window: int, buckets: int):
        self.active_pj = 0
        self.idle_pj = 0
        self.worked_cycles = 0
        self.idle_cycles = 0
        self.rounds = 0
        self.untracked_rounds = 0
        self.completions = 0
        self.class_pj: dict = {}
        self.class_cycles: dict = {}
        # completed per-request energies per class (exact percentiles)
        self.request_pj: dict = {}
        self.spec = _SpecAccount()
        self.ring = _PowerWindow(window, buckets)
        self.peak_watts = 0.0
        self.violations = 0
        self.over_budget_charges = 0
        self._over = False


class EnergyLedger:
    """The meter's integer pJ ledger: per-scope states plus the fleet
    totals accumulated *independently* on every charge — additivity is a
    real two-path check, exactly like
    :meth:`~repro_torch.serve.clock.FleetLedger.additivity`."""

    def __init__(self, window: int, buckets: int):
        self._window = int(window)
        self._buckets = int(buckets)
        self._scopes: dict = {}

    def state(self, scope) -> _ScopeState:
        st = self._scopes.get(scope)
        if st is None:
            st = self._scopes[scope] = _ScopeState(
                self._window, self._buckets
            )
        return st

    def scopes(self) -> list:
        return sorted(self._scopes, key=str)

    def shard_scopes(self) -> list:
        return [s for s in self.scopes() if s != FLEET]

    def additivity(self) -> dict:
        """Invariant 1: per-shard active/idle sums equal the fleet
        totals, to the picojoule."""
        fleet = self.state(FLEET)
        shard_active = sum(
            self.state(s).active_pj for s in self.shard_scopes()
        )
        shard_idle = sum(
            self.state(s).idle_pj for s in self.shard_scopes()
        )
        return dict(
            holds=bool(shard_active == fleet.active_pj
                       and shard_idle == fleet.idle_pj),
            fleet_active_pj=fleet.active_pj,
            shard_active_pj=shard_active,
            fleet_idle_pj=fleet.idle_pj,
            shard_idle_pj=shard_idle,
        )


class EnergyMeter:
    """Event-bus sink computing online joule attribution (module
    docstring).

    Args:
      rates: pJ per worked cycle by adapter kind (static + dynamic for
        the kind's plane schedule —
        :func:`repro_torch.core.energy_model.active_rate_pj`).  Kinds not
        listed charge the full-8 rate: observation must not require
        declaration.
      draft_rates: pJ per cycle for speculative *draft* work by kind
        (the truncated draft-plane datapath); defaults to the kind's
        full rate, i.e. no draft discount unless the plan declares one.
      static_pj: static pJ per un-worked clock cycle.
      power: a :class:`PowerSpec` (or mapping shard -> PowerSpec) to
        gate rolling per-shard power against; ``None`` still tracks
        rolling watts over the default window, with no cap.
      sink: optional side sink receiving edge-triggered ``power-cap``
        events.
    """

    enabled = True

    def __init__(self, rates=None, *, draft_rates=None,
                 static_pj: int = em.PJ_STATIC_CYCLE,
                 power: PowerSpec | dict | None = None, sink=None):
        self.rates = {k: int(v) for k, v in (rates or {}).items()}
        self.draft_rates = {
            k: int(v) for k, v in (draft_rates or {}).items()
        }
        self.default_rate = em.active_rate_pj()
        self.static_pj = int(static_pj)
        if self.static_pj < 0:
            raise ValueError(f"static_pj {static_pj} < 0")
        if isinstance(power, PowerSpec) or power is None:
            self._power_default = power
            self._power_by_shard = {}
        else:
            self._power_default = None
            self._power_by_shard = dict(power)
        spec = self._power_default or next(
            iter(self._power_by_shard.values()), None
        )
        window = spec.window if spec else 3_200_000
        buckets = spec.buckets if spec else 32
        self.ledger = EnergyLedger(window, buckets)
        self._sink = sink
        self._live: dict[tuple, int] = {}
        self.completed_pj: dict = {}
        self._round_end: dict = {}
        self.last_cycle = 0
        # bounded log of cap-violation edges (newest kept)
        self.cap_events: list[dict] = []

    # ------------------------------------------------------------- rates

    def rate(self, kind) -> int:
        return self.rates.get(kind, self.default_rate)

    def draft_rate(self, kind) -> int:
        return self.draft_rates.get(kind, self.rate(kind))

    def power_spec(self, shard) -> PowerSpec | None:
        return self._power_by_shard.get(shard, self._power_default)

    # ------------------------------------------------------------- sink

    def emit(self, event) -> None:
        et = event.etype
        if et not in ("exec", "round", "complete", "draft", "verify",
                      "accept"):
            return
        if event.cycle > self.last_cycle:
            self.last_cycle = event.cycle
        d = event.data
        shard = d.get("shard")
        if et == "exec":
            self._exec(shard, event.cycle, d)
        elif et == "round":
            self._round(shard, event.cycle, d)
        elif et == "complete":
            self._complete(shard, d)
        elif et == "draft":
            self._draft(shard, d)
        elif et == "verify":
            self._verify(shard, d)
        else:  # accept
            self._accept(shard, event.cycle, d)

    def _exec(self, shard, cycle, d) -> None:
        cycles = int(d["cycles"])
        pj = cycles * self.rate(d.get("kind"))
        key = (shard, d["rid"])
        self._live[key] = self._live.get(key, 0) + pj
        qos = d.get("qos")
        for scope in (shard, FLEET):
            st = self.ledger.state(scope)
            st.active_pj += pj
            st.worked_cycles += cycles
            st.class_pj[qos] = st.class_pj.get(qos, 0) + pj
            st.class_cycles[qos] = st.class_cycles.get(qos, 0) + cycles
        self._charge_ring(shard, cycle, pj)

    def _round(self, shard, cycle, d) -> None:
        worked = int(d["worked"])
        prev = self._round_end.get(shard)
        untracked = False
        if prev is None:
            if int(d.get("round", 0)) == 0:
                # armed from the first round: the clock started at 0
                prev = 0
            else:
                # armed mid-run: the round's true span is unknown —
                # charge idle for the reported spent span only
                prev = cycle - int(d.get("spent", worked))
                untracked = True
        idle_c = max((cycle - prev) - worked, 0)
        pj = idle_c * self.static_pj
        for scope in (shard, FLEET):
            st = self.ledger.state(scope)
            st.idle_pj += pj
            st.idle_cycles += idle_c
            st.rounds += 1
            if untracked:
                st.untracked_rounds += 1
        self._round_end[shard] = cycle
        self._charge_ring(shard, cycle, pj)

    def _complete(self, shard, d) -> None:
        key = (shard, d["rid"])
        pj = self._live.pop(key, 0)
        qos = d.get("qos")
        for scope in (shard, FLEET):
            st = self.ledger.state(scope)
            st.completions += 1
            st.request_pj.setdefault(qos, []).append(pj)
        # keyed like spans: rids are only unique within a shard
        self.completed_pj[key] = pj

    def _draft(self, shard, d) -> None:
        cycles = int(d["cycles"])
        pj = cycles * self.draft_rate(d.get("kind"))
        for scope in (shard, FLEET):
            sp = self.ledger.state(scope).spec
            sp.draft_cycles += cycles
            sp.draft_pj += pj
            sp.rounds += 1

    def _verify(self, shard, d) -> None:
        cycles = int(d["cycles"])
        pj = cycles * self.rate(d.get("kind"))
        for scope in (shard, FLEET):
            sp = self.ledger.state(scope).spec
            sp.verify_cycles += cycles
            sp.verify_pj += pj

    def _accept(self, shard, cycle, d) -> None:
        dr = self.draft_rate(d.get("kind"))
        fr = self.rate(d.get("kind"))
        for scope in (shard, FLEET):
            sp = self.ledger.state(scope).spec
            sp.drafted += int(d.get("k", 0))
            sp.accepted += int(d.get("accepted", 0))
            # instrumented adapters carry the per-slot cycle split — the
            # independent path invariant 4 re-derives the round-level
            # totals from, with wasted work priced per op class
            if "draft_cycles" in d:
                dc, vc = int(d["draft_cycles"]), int(d["verify_cycles"])
                sp.slot_draft_cycles += dc
                sp.slot_verify_cycles += vc
                sp.slot_pj += dc * dr + vc * fr
                sp.wasted_pj += (int(d["wasted_draft_cycles"]) * dr
                                 + int(d["wasted_verify_cycles"]) * fr)
        # The slot's exec quantum was charged entirely at the full-digit
        # rate; its draft steps actually ran on the truncated draft-plane
        # datapath.  Rebate the difference against the request's live
        # charge (and every scope it flowed into), so the *headline*
        # attribution — not just the spec account — prices op classes at
        # their own plane widths.  The rebate lands only while the exec
        # charge is live, so every invariant keeps closing exactly.
        if dr < fr and "draft_cycles" in d and "rid" in d:
            key = (shard, d["rid"])
            if key in self._live:
                rebate = int(d["draft_cycles"]) * (fr - dr)
                self._live[key] -= rebate
                qos = d.get("qos")
                for scope in (shard, FLEET):
                    st = self.ledger.state(scope)
                    st.active_pj -= rebate
                    st.class_pj[qos] = st.class_pj.get(qos, 0) - rebate
                self._charge_ring(shard, cycle, -rebate)

    def _charge_ring(self, shard, cycle, pj: int) -> None:
        st = self.ledger.state(shard)
        st.ring.record(cycle, pj)
        watts = st.ring.watts()
        if watts > st.peak_watts:
            st.peak_watts = watts
        spec = self.power_spec(shard)
        if spec is None:
            st._over = False
            return
        over = watts > spec.watts
        if over:
            st.over_budget_charges += 1
            if not st._over:
                st.violations += 1
                rec = dict(cycle=cycle, shard=shard,
                           watts=watts, budget=spec.watts)
                self.cap_events.append(rec)
                del self.cap_events[:-64]
                if self._sink is not None:
                    self._sink.emit(Event(cycle, "power-cap", dict(rec)))
        st._over = over

    # ---------------------------------------------------------- queries

    def in_flight(self) -> int:
        return len(self._live)

    def spec_summary(self, scope=FLEET) -> dict | None:
        """The speculative op-class energy split for one scope, wasted /
        useful closed per invariant 4 (``None`` when no spec traffic)."""
        sp = self.ledger.state(scope).spec
        if not sp.rounds:
            return None
        total_pj = sp.draft_pj + sp.verify_pj
        return dict(
            rounds=sp.rounds,
            draft_cycles=sp.draft_cycles,
            verify_cycles=sp.verify_cycles,
            draft_pj=sp.draft_pj,
            verify_pj=sp.verify_pj,
            total_pj=total_pj,
            wasted_pj=sp.wasted_pj,
            useful_pj=total_pj - sp.wasted_pj,
            drafted=sp.drafted,
            accepted=sp.accepted,
            accept_rate=(sp.accepted / sp.drafted if sp.drafted
                         else None),
        )

    def summary(self, scope=FLEET) -> dict:
        """The full energy state for one scope, JSON-ready — what
        ``gateway.stats()`` / ``fabric.stats()`` surface as
        ``'energy'``."""
        from repro_torch.serve.clock import exact_percentile

        st = self.ledger.state(scope)
        total_pj = st.active_pj + st.idle_pj
        per_class = {}
        for qos in sorted(set(st.class_pj) | set(st.request_pj),
                          key=str):
            reqs = st.request_pj.get(qos, [])
            n = len(reqs)
            p50 = exact_percentile(reqs, 50)
            p99 = exact_percentile(reqs, 99)
            per_class[qos] = dict(
                pj=st.class_pj.get(qos, 0),
                mj=em.pj_to_mj(st.class_pj.get(qos, 0)),
                cycles=st.class_cycles.get(qos, 0),
                requests=n,
                mean_request_pj=(sum(reqs) / n if n else None),
                p50_request_pj=p50,
                p99_request_pj=p99,
            )
        # the rolling power rings are charged per shard scope; the fleet
        # view aggregates them (watts add across lock-step shards)
        if scope == FLEET:
            shards = [self.ledger.state(s)
                      for s in self.ledger.shard_scopes()]
            spec = self._power_default
            power = dict(
                watts=sum(s.ring.watts() for s in shards),
                peak_watts=sum(s.peak_watts for s in shards),
                window=st.ring.window,
                budget_watts=(spec.watts * len(shards)
                              if spec and shards else None),
                violations=sum(s.violations for s in shards),
                over_budget_charges=sum(
                    s.over_budget_charges for s in shards
                ),
            )
        else:
            spec = self.power_spec(scope)
            power = dict(
                watts=st.ring.watts(),
                peak_watts=st.peak_watts,
                window=st.ring.window,
                budget_watts=spec.watts if spec else None,
                violations=st.violations,
                over_budget_charges=st.over_budget_charges,
            )
        return dict(
            scope=scope,
            last_cycle=self.last_cycle,
            static_pj_per_cycle=self.static_pj,
            rates={str(k): v for k, v in sorted(self.rates.items(),
                                                key=lambda kv: str(kv))},
            active_pj=st.active_pj,
            idle_pj=st.idle_pj,
            total_pj=total_pj,
            active_mj=em.pj_to_mj(st.active_pj),
            idle_mj=em.pj_to_mj(st.idle_pj),
            total_mj=em.pj_to_mj(total_pj),
            worked_cycles=st.worked_cycles,
            idle_cycles=st.idle_cycles,
            rounds=st.rounds,
            untracked_rounds=st.untracked_rounds,
            completions=st.completions,
            in_flight=len(self._live),
            per_class=per_class,
            spec=self.spec_summary(scope),
            power=power,
        )

    # ----------------------------------------------------- reconciliation

    def reconcile(self, spans=None) -> dict:
        """The integer-exact ledger gates (module docstring invariants).
        ``holds`` tolerates nothing — equality to the picojoule.  With
        ``spans`` (offline-assembled from an independent
        ``RecordingSink`` stream), additionally checks that the sum of
        per-request energies over completed spans equals the online
        completed total."""
        led = self.ledger
        additivity = led.additivity()
        checks = dict(additivity=additivity["holds"])

        # invariant 2+3: per-request and per-class sums == active, per
        # scope (live pJ keyed by shard folds into its scope's sum)
        live_by_scope: dict = {}
        for (shard, _rid), pj in self._live.items():
            live_by_scope[shard] = live_by_scope.get(shard, 0) + pj
        attribution = {}
        req_ok = cls_ok = True
        for scope in led.scopes():
            st = led.state(scope)
            live = (sum(live_by_scope.values()) if scope == FLEET
                    else live_by_scope.get(scope, 0))
            completed = sum(
                sum(v) for v in st.request_pj.values()
            )
            class_sum = sum(st.class_pj.values())
            ok_r = completed + live == st.active_pj
            ok_c = class_sum == st.active_pj
            req_ok &= ok_r
            cls_ok &= ok_c
            attribution[str(scope)] = dict(
                active_pj=st.active_pj,
                completed_pj=completed,
                live_pj=live,
                class_pj=class_sum,
                requests_hold=ok_r,
                classes_hold=ok_c,
            )
        checks["requests"] = req_ok
        checks["classes"] = cls_ok

        # invariant 4: the spec account closes — slot-level accept
        # fields re-derive the round-level draft/verify totals, and the
        # useful/wasted pJ split sums back exactly
        spec_ok = True
        spec_out = {}
        for scope in led.scopes():
            sp = led.state(scope).spec
            if not sp.rounds:
                continue
            s = self.spec_summary(scope)
            cycles_close = (
                sp.slot_draft_cycles == sp.draft_cycles
                and sp.slot_verify_cycles == sp.verify_cycles
            )
            pj_close = (
                sp.slot_pj == s["total_pj"]
                and s["useful_pj"] + s["wasted_pj"] == s["total_pj"]
                and 0 <= s["wasted_pj"] <= s["total_pj"]
            )
            spec_ok &= cycles_close and pj_close
            spec_out[str(scope)] = dict(
                cycles_close=cycles_close, pj_close=pj_close,
                slot_draft_cycles=sp.slot_draft_cycles,
                draft_cycles=sp.draft_cycles,
                slot_verify_cycles=sp.slot_verify_cycles,
                verify_cycles=sp.verify_cycles,
                slot_pj=sp.slot_pj,
                round_pj=s["total_pj"],
            )
        checks["spec"] = spec_ok

        out = dict(
            additivity=additivity,
            attribution=attribution,
            spec=spec_out,
        )
        if spans is not None:
            fleet = led.state(FLEET)
            online = sum(sum(v) for v in fleet.request_pj.values())
            offline = sum(
                self.completed_pj.get((sp.shard, sp.rid), 0)
                for sp in spans if sp.done
            )
            checks["spans"] = online == offline
            out["spans"] = dict(online_pj=online, offline_pj=offline)
        out["checks"] = checks
        out["holds"] = all(checks.values())
        return out


def attach_joules(spans, meter: EnergyMeter):
    """Grow assembled spans' ``pj`` field from the meter's per-request
    attribution (completed requests; in-flight spans get their partial
    charge).  Returns the same list."""
    for sp in spans:
        key = (sp.shard, sp.rid)
        sp.pj = (meter.completed_pj.get(key, 0) if sp.done
                 else meter._live.get(key, 0))
    return spans


def find_meter(sink, shard=None):
    """Locate an armed :class:`EnergyMeter` inside a sink tree (through
    :class:`~repro_torch.obs.events.TeeSink` fan-outs and
    :class:`~repro_torch.obs.events.ShardSink` wrappers), returning
    ``(meter, shard)`` — the :func:`~repro_torch.obs.slo.find_monitor`
    contract."""
    if isinstance(sink, EnergyMeter):
        return sink, shard
    if isinstance(sink, ShardSink):
        return find_meter(sink.base, sink.shard)
    if isinstance(sink, TeeSink):
        for s in sink.sinks:
            m, sh = find_meter(s, shard)
            if m is not None:
                return m, sh
    return None, shard
