"""Declarative SLOs + online burn-rate monitoring on the event bus (a copy
of the reference's ``obs/slo.py``; host code on Python ints).

:class:`SloSpec` declares one QoS class's objective: a latency target at
a percentile, and a *deadline-miss budget* (the fraction of requests
allowed to finish past their per-request deadline — traces carry
``deadline_cycles``, the gateway stamps an absolute deadline on every
request).  :class:`SloMonitor` is an event-bus sink (:mod:`repro_torch.obs
.events`) that watches the stream a gateway or fabric already emits and
maintains, **online and in bounded memory**:

* cumulative per-class completion / deadline-miss / latency-miss
  counters, per shard and fleet-aggregated — the miss counts are gated
  *integer-exactly* equal to the offline span-derived counts
  (:func:`repro_torch.obs.attrib.span_misses` over
  :func:`repro_torch.obs.spans.assemble`), because both fold the identical
  ``submit``/``import``/``admit``/``exec``/``complete`` stream;
* a streaming miss-attribution histogram (:mod:`repro_torch.obs.attrib`
  classes: queued / preempted / service / overdraft) built from the same
  integer segments span assembly would produce — state per *in-flight*
  request only, dropped at completion, so a million-request run holds a
  live table bounded by concurrency, never by trace length;
* rolling **multi-window burn rates** on the modeled cycle clock: for
  each window (in cycles) a bucketed ring holds completion/miss counts,
  and the burn rate is ``(miss fraction in window) / miss_budget`` —
  the multi-window alerting shape (fast window pages, slow window
  tickets).  Window rates are bucket-granular approximations; the
  *cumulative* counters are exact, and they are what reconciliation
  gates on.

Arm the monitor before traffic (``gateway.set_sink(monitor)`` or tee it
with a :class:`~repro_torch.obs.events.RecordingSink`); completions whose
submit the monitor never saw are counted ``untracked`` and excluded
from miss accounting — exactness is guaranteed for streams observed
from the first arrival.

A stolen request is handled exactly like span assembly handles it: the
donor-side record is dropped on the ``export`` event and the thief-side
``import`` (re-keyed rid, original arrival and deadline traveling with
it) opens the record that will complete — so online and offline miss
counts agree even under work stealing.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import cycle_model as cm

from .attrib import ATTRIB_CLASSES, attribution_shares, classify_segments
from .events import ShardSink, TeeSink

#: Scope key for the fleet-wide aggregate (individual shards key by their
#: integer index; an unsharded gateway's events key by ``None``).
FLEET = "fleet"


@dataclass(frozen=True)
class SloSpec:
    """One QoS class's declarative objective.

    Args:
      qos: the class label (a gateway ``shares`` key).
      pct: the latency percentile the target applies to (exact order
        statistic, :func:`~repro_torch.serve.clock.exact_percentile`).
      latency_target_ms: modeled-latency target at ``pct`` (None: no
        latency objective, deadline budget only).
      miss_budget: allowed deadline-miss fraction in (0, 1] — the burn
        rate denominator; burn 1.0 means missing exactly at budget.
    """

    qos: str
    pct: float = 99.0
    latency_target_ms: float | None = None
    miss_budget: float = 0.01

    def __post_init__(self):
        if not 0 < self.pct <= 100:
            raise ValueError(f"pct {self.pct} not in (0, 100]")
        if not 0 < self.miss_budget <= 1:
            raise ValueError(
                f"miss_budget {self.miss_budget} not in (0, 1]"
            )
        if self.latency_target_ms is not None and self.latency_target_ms <= 0:
            raise ValueError(
                f"latency_target_ms {self.latency_target_ms} <= 0"
            )

    @property
    def latency_target_cycles(self) -> int | None:
        if self.latency_target_ms is None:
            return None
        return int(round(self.latency_target_ms * cm.FREQ_HZ / 1e3))

    def to_dict(self) -> dict:
        return dict(
            qos=self.qos, pct=self.pct,
            latency_target_ms=self.latency_target_ms,
            miss_budget=self.miss_budget,
        )


class _Window:
    """Bucketed ring over one rolling window of the modeled clock:
    completion and miss counts per bucket, expired buckets zeroed as the
    clock advances.  Rates are exact at bucket granularity."""

    __slots__ = ("window", "buckets", "width", "n", "miss", "_cur")

    def __init__(self, window: int, buckets: int):
        self.window = int(window)
        self.buckets = int(buckets)
        self.width = max(self.window // self.buckets, 1)
        self.n = [0] * self.buckets
        self.miss = [0] * self.buckets
        self._cur = None  # absolute index of the newest bucket

    def record(self, cycle: int, miss: bool) -> None:
        b = cycle // self.width
        if self._cur is None:
            self._cur = b
        elif b > self._cur:
            # zero every bucket the clock skipped over (ring-capped)
            for k in range(self._cur + 1,
                           min(b, self._cur + self.buckets) + 1):
                self.n[k % self.buckets] = 0
                self.miss[k % self.buckets] = 0
            self._cur = b
        # late cross-shard events (bounded by one lock-step round) fold
        # into their own bucket if still live, else the oldest kept one
        idx = (b if self._cur - b < self.buckets else
               self._cur - self.buckets + 1) % self.buckets
        self.n[idx] += 1
        self.miss[idx] += 1 if miss else 0

    def rate(self) -> float:
        """Miss fraction over the live window (0.0 when empty)."""
        n = sum(self.n)
        return sum(self.miss) / n if n else 0.0


class _ClassState:
    """One (scope, qos) accumulator: exact cumulative counters + the
    rolling windows + streaming attribution histogram."""

    __slots__ = ("completions", "deadline_misses", "latency_misses",
                 "untracked", "attribution", "windows")

    def __init__(self, windows, buckets):
        self.completions = 0
        self.deadline_misses = 0
        self.latency_misses = 0
        self.untracked = 0
        self.attribution = {c: 0 for c in ATTRIB_CLASSES}
        self.windows = {w: _Window(w, buckets) for w in windows}


class _Live:
    """One in-flight request's streaming span state (dropped at
    completion — the live table is bounded by concurrency)."""

    __slots__ = ("arrival", "admitted", "deadline", "exec_cycles", "qos")

    def __init__(self, arrival, deadline, qos):
        self.arrival = arrival
        self.admitted = None
        self.deadline = deadline
        self.exec_cycles = 0
        self.qos = qos


class SloMonitor:
    """Event-bus sink computing online SLO state (module docstring).

    Args:
      specs: :class:`SloSpec` per monitored class.  Classes without a
        spec are still counted (budget defaults to ``default_budget``
        for burn rates) — observation must not require declaration.
      windows: rolling window lengths in modeled cycles, fast to slow.
      buckets: ring granularity per window (rate error ≤ 1 bucket).
      default_budget: miss budget applied to unspecified classes.
    """

    enabled = True

    def __init__(self, specs=(), *, windows=(2_000_000, 16_000_000),
                 buckets: int = 32, default_budget: float = 0.01):
        self.specs = {s.qos: s for s in specs}
        if not windows:
            raise ValueError("need at least one burn-rate window")
        self.windows = tuple(sorted(int(w) for w in windows))
        if any(w <= 0 for w in self.windows):
            raise ValueError(f"windows must be positive: {windows}")
        self.buckets = int(buckets)
        if not 0 < default_budget <= 1:
            raise ValueError(
                f"default_budget {default_budget} not in (0, 1]"
            )
        self.default_budget = float(default_budget)
        self._live: dict[tuple, _Live] = {}
        self._scopes: dict[object, dict[str, _ClassState]] = {}
        self.last_cycle = 0

    # ------------------------------------------------------------- sink

    def emit(self, event) -> None:
        et = event.etype
        if et not in ("submit", "import", "admit", "exec", "complete",
                      "export"):
            return
        d = event.data
        shard = d.get("shard")
        key = (shard, d["rid"])
        if event.cycle > self.last_cycle:
            self.last_cycle = event.cycle
        if et in ("submit", "import"):
            # import re-keys a stolen request; its original arrival and
            # absolute deadline travel with it (span-assembly semantics)
            self._live[key] = _Live(
                int(d.get("arrival", event.cycle)), d.get("deadline"),
                d.get("qos"),
            )
        elif et == "export":
            # donor side of a steal: this rid will never complete here
            self._live.pop(key, None)
        elif et == "admit":
            rec = self._live.get(key)
            if rec is not None:
                rec.admitted = event.cycle
        elif et == "exec":
            rec = self._live.get(key)
            if rec is not None:
                rec.exec_cycles += int(d["cycles"])
        else:  # complete
            self._complete(shard, key, event)

    def _complete(self, shard, key, event) -> None:
        rec = self._live.pop(key, None)
        qos = event.data.get("qos") or (rec.qos if rec else None)
        if rec is None or rec.admitted is None:
            # submit/admit predates the monitor: count, don't guess
            for scope in (shard, FLEET):
                self._state(scope, qos).untracked += 1
            return
        finished = event.cycle
        total = finished - rec.arrival
        # effective admission never precedes arrival (round-start stamps)
        queued = max(rec.admitted, rec.arrival) - rec.arrival
        preempted = total - queued - rec.exec_cycles
        miss = rec.deadline is not None and finished > rec.deadline
        spec = self.specs.get(qos)
        target = spec.latency_target_cycles if spec else None
        lat_miss = target is not None and total > target
        attrib = classify_segments(queued, rec.exec_cycles, preempted) \
            if miss else None
        for scope in (shard, FLEET):
            st = self._state(scope, qos)
            st.completions += 1
            if miss:
                st.deadline_misses += 1
                st.attribution[attrib] += 1
            if lat_miss:
                st.latency_misses += 1
            for w in st.windows.values():
                w.record(finished, miss)

    def _state(self, scope, qos) -> _ClassState:
        per_class = self._scopes.setdefault(scope, {})
        st = per_class.get(qos)
        if st is None:
            st = per_class[qos] = _ClassState(self.windows, self.buckets)
        return st

    # ---------------------------------------------------------- queries

    def scopes(self) -> list:
        """Scope keys seen so far (``'fleet'`` + shard indices; ``None``
        for an unsharded gateway's events)."""
        return sorted(self._scopes, key=str)

    def in_flight(self) -> int:
        return len(self._live)

    def budget(self, qos) -> float:
        spec = self.specs.get(qos)
        return spec.miss_budget if spec else self.default_budget

    def counts(self, scope=FLEET) -> dict[str, dict]:
        """Exact cumulative per-class counters for one scope — the
        surface reconciliation gates compare (integer equality)."""
        out = {}
        for qos, st in sorted(self._scopes.get(scope, {}).items(),
                              key=lambda kv: str(kv[0])):
            out[qos] = dict(
                completions=st.completions,
                deadline_misses=st.deadline_misses,
                latency_misses=st.latency_misses,
                untracked=st.untracked,
                attribution=dict(st.attribution),
            )
        return out

    def miss_counts(self, scope=FLEET) -> dict[str, int]:
        """Per-class cumulative deadline misses (zero-count classes
        omitted — the same shape :func:`repro_torch.obs.attrib.span_misses`
        derives offline)."""
        return {
            qos: st.deadline_misses
            for qos, st in self._scopes.get(scope, {}).items()
            if st.deadline_misses
        }

    def attribution(self, scope=FLEET) -> dict[str, dict[str, int]]:
        """Per-class miss-attribution histograms (classes with misses
        only — the shape :func:`repro_torch.obs.attrib.attribute` derives)."""
        return {
            qos: dict(st.attribution)
            for qos, st in self._scopes.get(scope, {}).items()
            if st.deadline_misses
        }

    def burn_rates(self, qos, scope=FLEET) -> dict:
        """Cumulative + per-window burn rates for one class: miss rate
        over the budget (1.0 = burning exactly at budget)."""
        st = self._scopes.get(scope, {}).get(qos)
        budget = self.budget(qos)
        if st is None:
            return dict(cumulative=0.0,
                        windows={str(w): 0.0 for w in self.windows})
        cum = (st.deadline_misses / st.completions / budget
               if st.completions else 0.0)
        return dict(
            cumulative=cum,
            windows={str(w): st.windows[w].rate() / budget
                     for w in self.windows},
        )

    def summary(self, scope=FLEET) -> dict:
        """The full per-class SLO state for one scope, JSON-ready — what
        ``gateway.stats()`` / ``fabric.stats()`` surface as ``slo``."""
        per_class = {}
        for qos, st in sorted(self._scopes.get(scope, {}).items(),
                              key=lambda kv: str(kv[0])):
            spec = self.specs.get(qos)
            per_class[qos] = dict(
                completions=st.completions,
                deadline_misses=st.deadline_misses,
                latency_misses=st.latency_misses,
                untracked=st.untracked,
                miss_rate=(st.deadline_misses / st.completions
                           if st.completions else 0.0),
                budget=self.budget(qos),
                burn=self.burn_rates(qos, scope),
                attribution=dict(st.attribution),
                attribution_shares=attribution_shares(st.attribution),
                spec=spec.to_dict() if spec else None,
            )
        return dict(
            scope=scope,
            windows=list(self.windows),
            last_cycle=self.last_cycle,
            in_flight=len(self._live),
            per_class=per_class,
        )

    # ----------------------------------------------------- reconciliation

    def reconcile(self, spans) -> dict:
        """Integer-exact gate: the monitor's cumulative fleet miss counts
        and attribution histograms must equal the offline span-derived
        ones (:mod:`repro_torch.obs.attrib` over the same event stream).
        ``holds`` tolerates nothing — equality to the integer."""
        from .attrib import attribute, span_misses

        online = self.miss_counts(FLEET)
        offline = span_misses(spans)
        online_att = self.attribution(FLEET)
        offline_att = attribute(spans)
        return dict(
            holds=bool(online == offline and online_att == offline_att),
            online=online,
            offline=offline,
            online_attribution=online_att,
            offline_attribution=offline_att,
        )


def find_monitor(sink, shard=None):
    """Locate an armed :class:`SloMonitor` inside a sink tree (through
    :class:`~repro_torch.obs.events.TeeSink` fan-outs and
    :class:`~repro_torch.obs.events.ShardSink` wrappers), returning
    ``(monitor, shard)`` — ``shard`` is the index the innermost wrapper
    tags events with (``None`` outside a fabric).  ``(None, shard)``
    when no monitor is armed."""
    if isinstance(sink, SloMonitor):
        return sink, shard
    if isinstance(sink, ShardSink):
        return find_monitor(sink.base, sink.shard)
    if isinstance(sink, TeeSink):
        for s in sink.sinks:
            mon, sh = find_monitor(s, shard)
            if mon is not None:
                return mon, sh
    return None, shard
