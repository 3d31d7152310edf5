"""Unified admission-controlled serving gateway: one front door for both
engines, co-scheduled against a shared modeled cycle budget — with
preemptive chunked execution, per-request QoS classes and an open-loop
(mid-round) arrival path.  A copy of the reference's ``serve/gateway.py``
over the port's engines: the gateway, its policies and its accounting are
host code on Python ints and floats; only the adapters' engines run on a
device (``device=``, the CUDA card unless ``'cpu'``).

The LM Engine (``serve.engine``) and SegEngine (``segserve.engine``) each
own a correct inner loop over the shared ``serve.queue`` primitives, but a
deployment serving heterogeneous traffic needs a *single* admission point
that can (1) decide which request enters which engine when, (2) split the
accelerator's modeled cycle capacity between traffic classes each
scheduling round, and (3) refuse to serve a tuned plan whose weights have
drifted.  This module is that front door.

Scheduling model
----------------
Time is the relation-(2) cycle clock of ``core.cycle_model`` — the same
currency every bench and certificate in this repo is priced in.  The
gateway runs discrete *rounds* of ``round_budget`` modeled cycles.  Each
round: the admission policy moves requests from the gateway queue into
engine slots, then the execution policy spends the round's budget stepping
the engines' micro-batches, charged at their modeled price.  Three
policies ship:

``fifo``
    Strict arrival order, head-of-line blocking and all: admission stops
    at the first request whose engine is full, execution drains the class
    of the oldest incomplete request first.  The honest baseline.
``fair``
    Cycle-budget fair-share (deficit round-robin): each traffic class
    accrues ``share * round_budget`` cycles of quantum per round (deficit
    carries over while the class has work, resets while idle), admission
    interleaves classes oldest-first, and leftover budget is
    work-conserving slack.  No class can starve: a backlogged class
    receives at least its share of every round.
``edf``
    Earliest-deadline-first on the modeled clock, deadlines defaulting to
    ``deadline_factor x`` the request's admission estimate.  Admission and
    execution both follow the earliest live deadline.

QoS classes
------------------
The scheduling class of a request is its ``qos`` label, *decoupled from
the engine kind*: ``submit(..., qos='interactive')`` and ``qos='batch'``
may both land on one ``LMAdapter``, each with its own fair share and its
own latency account.  ``qos`` defaults to the adapter kind, so kind-level
scheduling is the degenerate labeling.  Every non-kind
class must be declared in ``shares`` — a silently share-less class would
void the starvation-freedom guarantee the fair policy exists for.

Preemptive chunked execution
-----------------------------------
Under ``preemptive=True`` (the default) adapters never overdraft a budget
they are handed:

* LM prefill is *chunked* — charged token-by-token through the round
  budget as it runs, instead of atomically at admission.  A long prompt
  no longer front-loads its whole cost into one round; the remainder
  yields to the next round.
* A SegEngine micro-batch whose relation-(2) price exceeds the class's
  remaining quantum is *not started*: the quantum carries (deficit is
  never driven negative) and the batch runs once the class has accrued
  enough.  This is the digit-serial (DSLR-CNN online-arithmetic) story:
  work is metered in small online chunks, so yielding between chunks is
  architecturally free.
* LM decode steps are class-scoped (``Engine.step(only=...)``): a class's
  quantum pays for its own slots only.

``preemptive=False`` restores the atomic semantics (prefill charged
at admission, micro-steps run past the budget) — the bench's baseline.
Liveness: if *no* class makes progress for enough consecutive rounds to
prove the cheapest step can never fit (its price exceeds the full round
budget), the gateway forces exactly one micro-step and records the
overdraft in ``stats()['forced']``.

Open-loop arrivals
-------------------------
``step_round(arrivals=...)`` injects requests *inside* the round at their
stamped modeled cycle: execution proceeds to each arrival's offset, the
request is submitted with ``arrival_cycle`` equal to its stamp, and a
mid-round admission pass runs before execution resumes.  ``advance_to``
runs rounds until the clock reaches a target cycle.  The open-loop replay
harness (``repro_torch.workload.replay``) drives this path from serialized
traces.

Plan invalidation and hot-reload
--------------------------------
An adapter serving a :class:`~repro_torch.autotune.plan.TunedPlan` carries the
plan's ``params_fingerprint`` next to a fingerprint of the weights it is
*actually* serving.  Every submission re-checks the pair; on mismatch the
gateway either rejects the request with :class:`StalePlanError` (naming
both fingerprints) or — ``on_stale='fallback'`` — quarantines the plan and
rebuilds the engine on the certified uniform schedule before admitting.
:meth:`Gateway.swap_plan` is the hot-reload path: the incoming plan's
fingerprint is re-verified against the served params immediately, then the
plan installs at the first round boundary where the adapter is idle
(admission to it is held until the swap lands, so mid-stream requests
drain under the old plan and later ones serve under the new one).

Progressive results
-------------------
Segmentation work streams :class:`~repro_torch.segserve.engine.TileEvent` s
through the gateway (``on_event`` / ``Gateway.tile_events``): with the
engine's structure-first tile prioritization, callers get the
high-information cores of an image while its background is still queued.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any

from repro_torch.core import cycle_model as cm
from repro_torch.obs.events import NULL_SINK, Event, payload_spec

from .clock import RoundClock, exact_percentile
from .queue import FifoQueue

POLICIES = ("fifo", "fair", "edf")
_POLICY_ALIASES = {"fair_share": "fair", "fairshare": "fair"}


class StalePlanError(RuntimeError):
    """A tuned plan's fingerprint does not match the served params."""


def _check_plan(adapter, on_stale: str) -> None:
    """The admission-time plan-invalidation gate (ROADMAP item): verify the
    served plan's weights-only fingerprint against the weights the adapter
    actually holds, once per submission."""
    info = adapter.verify_info()
    if info is None:
        return
    plan_fp, served_fp = info
    if plan_fp == served_fp:
        return
    msg = (
        f"stale tuned plan on {adapter.kind!r}: plan was tuned for params "
        f"with fingerprint {plan_fp} but the engine serves params with "
        f"fingerprint {served_fp}; refusing to serve a certificate "
        f"conditioned on different weights"
    )
    if on_stale == "reject":
        raise StalePlanError(msg)
    adapter.install_fallback(msg)


def _served_fingerprint(adapter) -> str:
    """SHA-256 over the weights the adapter actually serves, computed once
    per adapter lifetime (weights are fixed) and cached: weights on the
    card are copied to the host once, here, never per submission."""
    if getattr(adapter, "_served_fp", None) is None:
        from repro_torch.autotune.calibrate import params_fingerprint

        adapter._served_fp = params_fingerprint(adapter.params)
    return adapter._served_fp


def _plan_fingerprint(plan) -> str:
    return plan.params_fingerprint or (
        f"<unverifiable v1 plan {plan.fingerprint}>"
    )


def _verify_info(adapter):
    """The cached (plan binding, served binding) fingerprint pair for an
    adapter serving a tuned plan — the per-submission work is a string
    compare."""
    if adapter.plan is None:
        return None
    return _plan_fingerprint(adapter.plan), _served_fingerprint(adapter)


@dataclass
class GatewayRequest:
    """One typed request with its modeled-clock lifecycle timestamps."""

    rid: int
    kind: str  # adapter key: 'lm' | 'seg' | ...
    qos: str  # scheduling class (defaults to kind at submit)
    payload: Any  # engine-native request (serve.engine.Request / image)
    est_cycles: int  # relation-(2) admission estimate
    deadline: int | None  # absolute modeled-cycle deadline (EDF)
    arrival: int  # modeled clock at submit (trace stamp under open loop)
    admitted: int | None = None  # modeled clock at admission
    finished: int | None = None  # modeled clock at completion
    arrival_round: int = 0
    admitted_round: int | None = None
    finished_round: int | None = None
    handle: Any = None  # engine-side request object, set at admission

    @property
    def done(self) -> bool:
        return self.finished is not None

    @property
    def latency_cycles(self) -> int:
        if self.finished is None:
            raise ValueError(f"request {self.rid} not finished")
        return self.finished - self.arrival

    @property
    def latency_ms(self) -> float:
        return self.latency_cycles / cm.FREQ_HZ * 1e3


# --------------------------------------------------------------- adapters
#
# An adapter owns one engine and speaks the gateway's protocol:
#   kind            class name ('lm', 'seg')
#   free_slots()    admission headroom
#   estimate_cycles(payload)  relation-(2) cost estimate for admission
#   admit(greq)     occupy a slot; returns cycles charged up front
#                   (atomic-mode prefill; 0 under preemptive chunking)
#   has_work(qos=None)        admitted-but-unfinished micro-work pending
#                   (restricted to one QoS class when given)
#   work(budget, qos=None, force=False, soft_limit=None)
#                   run micro-steps charging at most ~budget cycles;
#                   preemptive adapters never exceed budget (the *hard*
#                   quantum bound) unless ``force`` (then exactly one
#                   micro-step may overdraft).  ``soft_limit`` marks a
#                   segment boundary (a mid-round arrival's offset): no
#                   new micro-step *starts* at or past it, but a step
#                   started before it may run across — arrivals queue
#                   behind in-flight work, they do not interrupt it.
#                   Returns (consumed, completions, events) where each
#                   completion is a (GatewayRequest, offset) pair: offset
#                   is the cycles consumed *within this call* at the
#                   micro-step the request finished on, so the gateway
#                   stamps each completion at its own point in the round
#                   instead of smearing a whole chunk's latency onto a
#                   request that finished on its first micro-step.
#                   Offsets must be non-decreasing in return order.
#                   (Bare GatewayRequests are accepted for backward
#                   compatibility and stamp at the call's full consumed.)
#   total_ops       useful-op account for aggregate GOPS/W
#   verify_info()   None, or (plan params fingerprint, served fingerprint)
#   install_fallback(reason)  drop a stale plan for the uniform schedule
#   install_plan(plan)        hot-swap a verified plan (adapter idle)
#
# The gateway itself never touches a tensor: policies are pure cycle-clock
# scheduling, so tests drive them with synthetic adapters at zero model
# cost and the property suite can sweep traffic shapes.


class LMAdapter:
    """Continuous-batching LM decode behind the gateway protocol.

    ``plan`` (a ``workload='lm'`` :class:`~repro_torch.autotune.plan.TunedPlan`)
    installs the certified per-layer schedule via
    :func:`repro_torch.autotune.api.apply_plan_lm` and arms the admission-time
    fingerprint check.  Work is priced per continuous-batching step at the
    sharper ``cm.lm_step_cycles`` itemization (true GQA projection widths,
    attention score/value products against a ``max_seq``-token cache — a
    conservative context upper bound — and MoE routing when the config has
    experts).  Under ``preemptive=True`` prefill runs in budget-sized
    chunks through ``work`` and decode steps are class-scoped;
    ``preemptive=False`` restores the atomic path (prefill charged in
    full at admission).  ``device`` is where the engine runs: the CUDA card
    unless ``'cpu'``.
    """

    kind = "lm"
    # armed by Gateway.set_sink: when True, work() appends per-request
    # (rid, qos, cycles, offset) execution-attribution records to
    # exec_log for the gateway to drain into the event bus
    obs_enabled = False
    obs_sink = None

    def __init__(self, cfg, params, *, batch: int, max_seq: int,
                 plan=None, extras=None, preemptive: bool = True,
                 device=None):
        self.plan = plan
        self.params = params
        self.device = device
        self._base_cfg = cfg
        self._batch = batch
        self._max_seq = max_seq
        self._extras = extras
        self.preemptive = bool(preemptive)
        self.fallback_reason: str | None = None
        self.exec_log: list[tuple] = []
        if plan is not None:
            from repro_torch.autotune.api import apply_plan_lm

            cfg = apply_plan_lm(cfg, plan)
        self._build(cfg)
        # keyed by handle identity: pre-built Requests keep their own rid,
        # which need not match (or may collide with) the gateway's counter
        self._inflight: dict[int, GatewayRequest] = {}
        self._order: list[GatewayRequest] = []  # admission order (prefill)
        self.total_ops = 0

    def _make_engine(self, cfg):
        """Engine factory — the subclass hook
        (:class:`~repro_torch.serve.specdecode.SpecLMAdapter` builds its
        ``SpecEngine`` here)."""
        from .engine import Engine

        return Engine(
            cfg, self.params, batch=self._batch, max_seq=self._max_seq,
            extras=self._extras, device=self.device,
        )

    def _build(self, cfg) -> None:
        self.cfg = cfg
        self.engine = self._make_engine(cfg)
        self.engine.obs = self.obs_sink or NULL_SINK
        schedule = cfg.quant.plane_schedule
        self._price_kw = price_kw = dict(
            n_heads=cfg.n_heads, head_dim=cfg.hd, n_kv_heads=cfg.n_kv_heads,
            context=self._max_seq, n_experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k,
        )
        self._step_cycles = cm.lm_step_cycles(
            cfg.d_model, cfg.d_ff, cfg.n_layers, schedule, **price_kw
        )
        self._step_ops = cm.lm_step_ops(
            cfg.d_model, cfg.d_ff, cfg.n_layers, **price_kw
        )

    # -- plan invalidation / hot reload
    def verify_info(self):
        return _verify_info(self)

    def install_fallback(self, reason: str) -> None:
        """Quarantine the stale plan: rebuild on the uniform full-digit
        schedule (certified by construction — zero truncation error)."""
        import dataclasses

        self.plan = None
        self.fallback_reason = reason
        self._build(
            self._base_cfg.replace(
                quant=dataclasses.replace(
                    self._base_cfg.quant, plane_schedule=None, planes=8
                )
            )
        )

    def install_plan(self, plan) -> None:
        """Hot-swap to a (gateway-verified) tuned plan.  Only legal while
        idle — the rebuild drops engine slot state."""
        if self.has_work():
            raise RuntimeError("install_plan with requests in flight")
        from repro_torch.autotune.api import apply_plan_lm

        self.plan = plan
        self.fallback_reason = None
        self._build(apply_plan_lm(self._base_cfg, plan))
        self._inflight.clear()
        self._order.clear()

    # -- gateway protocol
    def prepare(self, payload, *, rid: int, max_new: int = 16):
        import numpy as np

        from .engine import Request

        if isinstance(payload, Request):
            return payload
        return Request(rid=rid, prompt=np.asarray(payload), max_new=max_new)

    def free_slots(self) -> int:
        return self.engine.slots.free_count()

    def estimate_cycles(self, payload) -> int:
        return (len(payload.prompt) + payload.max_new) * self._step_cycles

    def admit(self, greq: GatewayRequest) -> int:
        if self.preemptive:
            ok = self.engine.admit_slot(greq.payload)
        else:
            ok = self.engine.admit(greq.payload)
        if not ok:
            raise RuntimeError("admit called with no free LM slot")
        greq.handle = greq.payload
        self._inflight[id(greq.handle)] = greq
        self._order.append(greq)
        if self.preemptive:
            return 0  # prefill is metered through work(), chunk by chunk
        n_prefill = len(greq.payload.prompt)
        self.total_ops += n_prefill * self._step_ops
        return n_prefill * self._step_cycles

    def _matches(self, greq: GatewayRequest, qos: str | None) -> bool:
        return qos is None or greq.qos == qos

    def has_work(self, qos: str | None = None) -> bool:
        return any(
            self._matches(g, qos) and not g.done
            for g in self._inflight.values()
        )

    def _ready_slots(self, qos: str | None):
        return [
            (i, r) for i, r in self.engine.ready_slots()
            if id(r) in self._inflight
            and self._matches(self._inflight[id(r)], qos)
        ]

    def work(self, budget: int, qos: str | None = None, force: bool = False,
             soft_limit: int | None = None):
        consumed = 0
        completed: list[tuple[GatewayRequest, int]] = []
        if self.preemptive:
            consumed, force = self._work_prefill(
                budget, qos, force, soft_limit
            )
        consumed = self._work_decode(
            budget, consumed, qos, force, soft_limit, completed
        )
        for greq, _ in completed:
            if greq in self._order:
                self._order.remove(greq)
        return consumed, completed, []

    def _work_prefill(self, budget: int, qos, force: bool, soft_limit):
        """Chunked prefill, admission order: each token charged at the
        step price as it enters the cache; an unaffordable remainder
        yields to the next round instead of overdrafting."""
        consumed = 0
        sc = self._step_cycles
        for greq in list(self._order):
            if greq.done or not self._matches(greq, qos):
                continue
            h = greq.handle
            if h.prefill_remaining <= 0:
                continue
            n = min((budget - consumed) // sc, h.prefill_remaining)
            if soft_limit is not None:
                # tokens may start only before the segment boundary
                # (the last one may run across it)
                n_soft = -(-max(soft_limit - consumed, 0) // sc)
                n = min(n, n_soft)
            if n <= 0 and force and consumed == 0:
                n = 1  # forced progress: one token, overdraft recorded
            if n <= 0:
                break
            force = False
            self.engine.prefill(h, int(n))
            consumed += n * sc
            self.total_ops += n * self._step_ops
            if self.obs_enabled:
                self.exec_log.append((greq.rid, greq.qos, n * sc,
                                      consumed))
            if h.prefill_remaining:
                break  # budget exhausted mid-prompt
        return consumed, force

    def _work_decode(self, budget: int, consumed: int, qos, force: bool,
                     soft_limit, completed) -> int:
        """Decode steps — class-scoped under the preemptive path *when
        the family supports slot isolation* (the per-slot cache index:
        excluded rows' junk writes land at their own positions and are
        overwritten before read).  Recurrent/scalar-index families have
        no position-addressed state, so a subset step would corrupt the
        excluded rows — they decode every ready slot instead, charged
        to the invoking class.  The atomic path always decodes every
        ready slot."""
        sc = self._step_cycles
        scoped = self.preemptive and self.engine._vector_index
        while True:
            slots = self._ready_slots(qos)
            if not slots:
                break
            decoding = slots if scoped else self.engine.ready_slots()
            cost = sc * len(decoding)
            if self.preemptive:
                over_hard = consumed + cost > budget
                at_soft = soft_limit is not None and consumed >= soft_limit
                if (over_hard or at_soft) and not (force and consumed == 0):
                    break
            elif consumed >= budget:
                break
            force = False
            finished = self.engine.step(
                only={i for i, _ in slots} if scoped else None
            )
            consumed += cost
            self.total_ops += self._step_ops * len(decoding)
            if self.obs_enabled:
                # per-slot attribution: each decoding request owns one
                # step price, whichever class invoked the batch step
                for _, r in decoding:
                    g2 = self._inflight.get(id(r))
                    if g2 is not None:
                        self.exec_log.append((g2.rid, g2.qos, sc, consumed))
            # every request that finished on this decode step finished at
            # *this* step's offset, not at the end of the whole chunk
            completed.extend(
                (self._inflight.pop(id(r)), consumed)
                for r in finished
                if id(r) in self._inflight
            )
        return consumed


class SegAdapter:
    """Tiled segmentation behind the gateway protocol.

    ``plan`` serves a tuned operating point through
    :func:`repro_torch.autotune.api.apply_plan` semantics and arms the
    fingerprint check; without one the engine serves ``cfg`` as given.
    Work is the engine's own micro-batch step, charged at the summed
    relation-(2) price of the tiles it emitted.  Requests are labeled with
    their QoS class as the engine's tile *group*, so tiles of different
    classes never share a micro-batch and a class's quantum pays exactly
    for its own tiles.  Under ``preemptive=True`` a micro-batch whose
    price exceeds the remaining budget is not started (the quantum
    carries); ``preemptive=False`` restores the atomic loop.
    Emitted :class:`~repro_torch.segserve.engine.TileEvent` s pass through to
    the gateway's progressive stream.  ``device`` is where the engine runs:
    the CUDA card unless ``'cpu'``.
    """

    kind = "seg"
    # armed by Gateway.set_sink (see LMAdapter.obs_enabled)
    obs_enabled = False
    obs_sink = None

    def __init__(self, cfg, params, *, plan=None, preemptive: bool = True,
                 device=None, **engine_kw):
        self.plan = plan
        self.params = params
        self.device = device
        self._base_cfg = cfg
        self._engine_kw = dict(engine_kw)
        self.preemptive = bool(preemptive)
        self.fallback_reason: str | None = None
        self.exec_log: list[tuple] = []
        self._build(cfg, plan)
        self._inflight: dict[int, GatewayRequest] = {}
        self.total_ops = 0

    def _build(self, cfg, plan) -> None:
        from repro_torch.segserve.engine import SegEngine

        if plan is not None:
            from repro_torch.autotune.api import apply_plan

            cfg = apply_plan(cfg, plan)
        self.cfg = cfg
        self.engine = SegEngine(cfg, self.params, plan=plan, device=self.device,
                                **self._engine_kw)
        self.engine.obs = self.obs_sink or NULL_SINK
        self._base_planes = tuple(self.engine._class_planes(0))

    # -- plan invalidation / hot reload
    def verify_info(self):
        return _verify_info(self)

    def install_fallback(self, reason: str) -> None:
        import dataclasses

        self.plan = None
        self.fallback_reason = reason
        kw = dict(self._engine_kw)
        # the stale plan owned the tile geometry; fall back to the smallest
        # stride the halo walk certifies viable for this net
        kw.setdefault("tile", self._base_cfg.min_viable_tile())
        self._engine_kw = kw
        self._build(
            dataclasses.replace(
                self._base_cfg, plane_schedule=None, planes=8
            ),
            None,
        )

    def install_plan(self, plan) -> None:
        """Hot-swap to a (gateway-verified) tuned plan.  Only legal while
        idle — the rebuild drops canvases and the task table."""
        if self.has_work() or self._inflight:
            raise RuntimeError("install_plan with requests in flight")
        self.fallback_reason = None
        self.plan = plan
        self._build(self._base_cfg, plan)
        self._inflight.clear()

    # -- gateway protocol
    def prepare(self, payload, *, rid: int):
        import numpy as np

        return np.asarray(payload)

    def free_slots(self) -> int:
        return self.engine.slots.free_count()

    def estimate_cycles(self, payload) -> int:
        """Upper admission estimate: every tile window priced at the
        class-0 (full-budget) schedule — adaptivity only lowers it."""
        from repro_torch.segserve import tiling

        e = self.engine
        tplan = tiling.plan_tiles(
            payload.shape[0], payload.shape[1], depth=e.cfg.depth,
            convs_per_stage=e.cfg.convs_per_stage, tile=e.tile, halo=e.halo,
        )
        return sum(
            cm.unet_window_cycles(
                spec.in_shape, e.cfg.in_ch, e.cfg.base, e.cfg.depth,
                e.cfg.convs_per_stage, self._base_planes,
            )
            for spec in tplan.tiles
        )

    def admit(self, greq: GatewayRequest) -> int:
        handle = self.engine.submit(greq.payload, group=greq.qos)
        if not self.engine.queue.pump(self.engine.slots, self.engine._admit):
            raise RuntimeError("admit called with no free seg slot")
        greq.handle = handle
        # keyed by the engine-local rid the TileEvents will carry
        self._inflight[handle.rid] = greq
        return 0  # tile planning is host work, not accelerator cycles

    def has_work(self, qos: str | None = None) -> bool:
        if qos is None:
            return self.engine.has_work()
        return self.engine.has_work(group=qos)

    def work(self, budget: int, qos: str | None = None, force: bool = False,
             soft_limit: int | None = None):
        consumed = 0
        completed: list[tuple[GatewayRequest, int]] = []
        events = []
        group = ... if qos is None else qos
        while True:
            cost = self.engine.next_cost(group)
            if cost == 0:
                break
            if self.preemptive:
                # the preemption point: a micro-batch that would overdraft
                # the quantum yields; the deficit carries to the next round
                over_hard = consumed + cost > budget
                at_soft = soft_limit is not None and consumed >= soft_limit
                if (over_hard or at_soft) and not (force and consumed == 0):
                    break
            elif consumed >= budget:
                break
            force = False
            evs = self.engine.step(group)
            for ev in evs:
                consumed += ev.cycles
                if self.obs_enabled:
                    g2 = self._inflight.get(ev.rid)
                    if g2 is not None:
                        self.exec_log.append((g2.rid, g2.qos, ev.cycles,
                                              consumed))
                if ev.done:
                    greq = self._inflight.pop(ev.rid, None)
                    if greq is not None:
                        self.total_ops += ev.request.result.ops
                        # finished when its last tile emitted, offset-exact
                        completed.append((greq, consumed))
            events.extend(evs)
        return consumed, completed, events


# ---------------------------------------------------------------- gateway


class Gateway:
    """Admission-controlled front door over a set of engine adapters.

    Args:
      adapters: the served engines, e.g. ``[LMAdapter(...), SegAdapter(...)]``
        (or any object speaking the adapter protocol — tests use synthetic
        ones).  Keyed by ``adapter.kind``.
      policy: ``'fifo' | 'fair' | 'edf'`` (see module docstring).
      round_budget: modeled cycles one scheduling round may spend across
        all engines — the co-scheduling knob.
      shares: per-*class* fair-share fractions.  Keys are scheduling
        classes: an adapter kind (the default class of its unlabeled
        requests) or a QoS label requests carry (``submit(..., qos=...)``).
        Every submitted request's class must be declared here — submit
        rejects undeclared classes, so no class can silently arrive
        share-less.  Must sum to <= 1; unallocated share is
        work-conserving slack.  Default: equal across kinds.
      on_stale: ``'reject'`` (raise :class:`StalePlanError` at submission)
        or ``'fallback'`` (quarantine the plan, serve the uniform
        schedule) when a tuned plan's fingerprint mismatches the served
        params.
      deadline_factor: default EDF deadline = admission estimate x this.
      on_event: optional callback fed every streamed
        :class:`~repro_torch.segserve.engine.TileEvent` (progressive display).
      max_kept_events: how many recent tile events ``Gateway.tile_events``
        retains (a bounded deque — the oldest drop off as new ones land).
        ``on_event`` stays the lossless path; dropped-event counts surface
        in ``stats()['tile_events_dropped']``.
      sink: optional telemetry sink (:mod:`repro_torch.obs.events`): every
        scheduling-significant moment — queue-enter, admission, quantum
        grants, preemption yields, forced escapes, swap holds, per-request
        execution attribution, tile emissions, completions, round closes —
        is emitted as a cycle-stamped :class:`~repro_torch.obs.events.Event`.
        Default is the null sink: no events are built and observable
        behavior (scheduling, stats, bench numbers) is bit-identical to an
        uninstrumented run.  Swap sinks later with :meth:`set_sink`.
    """

    def __init__(
        self,
        adapters,
        *,
        policy: str = "fair",
        round_budget: int = 1_000_000,
        shares: dict[str, float] | None = None,
        on_stale: str = "reject",
        deadline_factor: float = 4.0,
        on_event=None,
        max_kept_events: int = 100_000,
        sink=None,
    ):
        policy = _POLICY_ALIASES.get(policy, policy)
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        if round_budget < 1:
            raise ValueError(f"round_budget {round_budget} < 1")
        if on_stale not in ("reject", "fallback"):
            raise ValueError(f"on_stale {on_stale!r}: 'reject' or 'fallback'")
        self.adapters: dict[str, Any] = {a.kind: a for a in adapters}
        if not self.adapters:
            raise ValueError("gateway needs at least one adapter")
        self.policy = policy
        self.round_budget = int(round_budget)
        self.on_stale = on_stale
        self.deadline_factor = float(deadline_factor)
        self.on_event = on_event
        kinds = list(self.adapters)
        if shares is None:
            shares = {k: 1.0 / len(kinds) for k in kinds}
        if any(s <= 0 for s in shares.values()) or sum(shares.values()) > 1 + 1e-9:
            raise ValueError(f"shares must be positive and sum <= 1: {shares}")
        # No silent share-less class: every request's scheduling class must
        # be declared here — submit() rejects undeclared classes loudly
        # (including a kind's own default class when traffic arrives
        # unlabeled), so the starvation-freedom guarantee cannot be voided
        # by an un-shared class slipping in.
        # keys beyond the kinds declare QoS classes requests may carry
        self.shares = dict(shares)
        self.queue: FifoQueue[GatewayRequest] = FifoQueue()
        self.requests: list[GatewayRequest] = []
        self._live: dict[int, GatewayRequest] = {}  # admitted, unfinished
        # bounded recent-events window (one small record per emitted tile;
        # unbounded growth was a documented leak, N-times worse per fabric
        # shard) — on_event remains the lossless streaming path
        if max_kept_events < 1:
            raise ValueError(f"max_kept_events {max_kept_events} < 1")
        self.tile_events: deque = deque(maxlen=int(max_kept_events))
        self._tile_events_seen = 0  # lifetime emitted (kept + dropped)
        # the modeled cycle clock + per-round ledger, extracted to
        # serve.clock so the single gateway and every fabric shard run
        # the exact same accounting arithmetic
        self._clock = RoundClock()
        self._deficit = {c: 0.0 for c in self.shares}
        self._admit_charges: dict[str, int] = {}
        self._granted = set()  # classes granted quantum this round
        self._class_stalled: dict[str, int] = {}  # consecutive dry rounds
        self._pending_swap: dict[str, Any] = {}
        self.plan_swaps: list[dict] = []  # installed hot-reloads
        self._next_rid = 0
        self._obs = NULL_SINK
        self._obs_on = False
        self.set_sink(sink)

    # Historical surface: ``gw.clock`` / ``gw.rounds`` / ``gw.forced`` were
    # plain counters before the RoundClock extraction; every test, bench
    # and replay harness reads them, so they stay as read-only views.
    @property
    def clock(self) -> int:
        """Absolute modeled clock (round start while stepping)."""
        return self._clock.cycles

    @property
    def rounds(self) -> int:
        return self._clock.rounds

    @property
    def forced(self) -> int:
        """Forced-progress overdraft steps (liveness escapes)."""
        return self._clock.forced

    @property
    def round_clock(self) -> RoundClock:
        """The underlying :class:`~repro_torch.serve.clock.RoundClock` — read-only
        use (fleet-ledger additivity checks diff its cumulative counters)."""
        return self._clock

    def ledger_snapshot(self) -> dict:
        """Cumulative integer accounts a fleet ledger diffs per round."""
        return dict(
            ops=sum(a.total_ops for a in self.adapters.values()),
            worked=self._clock.worked_total,
            class_worked=dict(self._clock.class_worked_total),
        )

    # ---------------------------------------------------------- telemetry

    @property
    def sink(self):
        """The armed telemetry sink (:data:`~repro_torch.obs.events.NULL_SINK`
        when observation is off)."""
        return self._obs

    def set_sink(self, sink) -> None:
        """Arm (or disarm, with ``None``) the telemetry sink.

        Arms the whole stack in one call: the gateway's own emission
        points, the :class:`~repro_torch.serve.clock.RoundClock` round-close
        events, each adapter's execution-attribution log
        (``adapter.obs_enabled`` / ``adapter.exec_log``), and — for
        adapters that own an engine — the engine's sequence-stamped
        micro-step records.  Adapters without the attribute surface
        (synthetic test adapters) degrade gracefully: their per-request
        attribution is simply absent from the stream.
        """
        self._obs = NULL_SINK if sink is None else sink
        self._obs_on = bool(getattr(self._obs, "enabled", True))
        self._clock.obs = self._obs if self._obs_on else None
        for a in self.adapters.values():
            try:
                a.obs_enabled = self._obs_on
                a.obs_sink = self._obs if self._obs_on else None
            except AttributeError:
                continue
            eng = getattr(a, "engine", None)
            if eng is not None and hasattr(eng, "obs"):
                eng.obs = self._obs if self._obs_on else NULL_SINK

    # ------------------------------------------------------------- submit

    def submit(self, kind: str, payload, *, qos: str | None = None,
               deadline_cycles: int | None = None,
               arrival_cycle: int | None = None, **prepare_kw
               ) -> GatewayRequest:
        """Type, verify and enqueue one request.

        ``qos`` is the scheduling class (defaults to ``kind``); a non-kind
        class must be declared in ``shares``.  ``arrival_cycle`` stamps the
        request's arrival on the modeled clock (the open-loop replay path;
        defaults to the current clock).  Admission control starts here:
        the adapter's tuned plan (if any) is verified against its served
        params *before* the request may enter the system."""
        if kind not in self.adapters:
            raise ValueError(
                f"unknown request kind {kind!r}; served kinds: "
                f"{sorted(self.adapters)}"
            )
        qos = kind if qos is None else str(qos)
        if qos not in self.shares:
            raise ValueError(
                f"undeclared QoS class {qos!r}: declare it in shares= "
                f"(declared: {sorted(self.shares)})"
            )
        adapter = self.adapters[kind]
        _check_plan(adapter, self.on_stale)
        rid = self._next_rid
        self._next_rid += 1
        # the raw-payload spec must be read *before* prepare (preparation
        # is lossy) — it is what obs.capture rebuilds traces from
        spec = payload_spec(kind, payload, prepare_kw) if self._obs_on \
            else None
        payload = adapter.prepare(payload, rid=rid, **prepare_kw)
        est = int(adapter.estimate_cycles(payload))
        arrival = self.clock if arrival_cycle is None else int(arrival_cycle)
        if deadline_cycles is None:
            deadline = arrival + math.ceil(self.deadline_factor * est)
        else:
            deadline = arrival + int(deadline_cycles)
        greq = GatewayRequest(
            rid=rid, kind=kind, qos=qos, payload=payload, est_cycles=est,
            deadline=deadline, arrival=arrival,
            arrival_round=self.rounds,
        )
        self.queue.push(greq)
        self.requests.append(greq)
        if self._obs_on:
            self._obs.emit(Event(arrival, "submit", dict(
                rid=rid, kind=kind, qos=qos, est=est, deadline=deadline,
                spec=spec,
            )))
        return greq

    # ------------------------------------------------------ work stealing

    def export_queued(self, n: int) -> list[GatewayRequest]:
        """Give up to ``n`` *queued* requests from the queue tail — the
        work-stealing donor side (:class:`~repro_torch.serve.fabric.Fabric`).

        Only never-admitted requests move: admitted work owns engine slot
        state (KV cache rows, stitching canvases) that cannot migrate.
        Taking from the tail preserves the donor's own FIFO semantics —
        its oldest requests keep their place.  Returned in arrival order.
        """
        take = min(int(n), len(self.queue))
        out = [self.queue.pop_at(len(self.queue) - 1) for _ in range(take)]
        out.reverse()  # popped newest-first; hand back in arrival order
        if out:
            gone = {id(g) for g in out}
            self.requests = [
                g for g in self.requests if id(g) not in gone
            ]
            if self._obs_on:
                for g in out:
                    self._obs.emit(Event(self.clock, "export",
                                         dict(rid=g.rid, qos=g.qos)))
        return out

    def import_queued(self, greqs) -> None:
        """Accept requests exported from another gateway (the thief side).

        Each request is re-keyed onto this gateway's rid counter — rids
        index the ``_live`` table, so an imported request keeping its
        donor-assigned rid could collide with a local one.  Arrival
        stamps travel with the request: latency is measured from the
        original arrival, wherever it completes.
        """
        for g in greqs:
            if g.kind not in self.adapters:
                raise ValueError(
                    f"imported request kind {g.kind!r} not served here "
                    f"(kinds: {sorted(self.adapters)})"
                )
            if g.qos not in self.shares:
                raise ValueError(
                    f"imported request class {g.qos!r} undeclared in "
                    f"shares (declared: {sorted(self.shares)})"
                )
            g.rid = self._next_rid
            self._next_rid += 1
            self.queue.push(g)
            self.requests.append(g)
            if self._obs_on:
                # span assembly treats an import as the (re-keyed)
                # request's queue-enter: the original arrival travels
                self._obs.emit(Event(self.clock, "import", dict(
                    rid=g.rid, kind=g.kind, qos=g.qos, arrival=g.arrival,
                    est=g.est_cycles, deadline=g.deadline,
                )))

    # --------------------------------------------------------- hot reload

    def swap_plan(self, kind: str, plan) -> None:
        """Queue a verified tuned plan for installation at a round
        boundary (plan hot-reload).

        The plan's ``params_fingerprint`` is re-verified against the
        served weights *now* — an operator swapping in a plan tuned for
        different weights gets :class:`StalePlanError` immediately, naming
        both fingerprints.  Installation waits until the adapter is idle:
        admission to ``kind`` is held (its queued requests wait), in-flight
        requests drain under the old plan, and the new plan installs at
        the next round boundary, after which admission resumes.
        """
        if kind not in self.adapters:
            raise ValueError(f"unknown kind {kind!r}")
        adapter = self.adapters[kind]
        if not hasattr(adapter, "install_plan"):
            raise TypeError(f"adapter {kind!r} does not support plan swaps")
        plan_fp = _plan_fingerprint(plan)
        served_fp = _served_fingerprint(adapter)
        if plan_fp != served_fp:
            raise StalePlanError(
                f"refusing to hot-swap a stale plan onto {kind!r}: plan "
                f"fingerprint {plan_fp} vs served params fingerprint "
                f"{served_fp}"
            )
        self._pending_swap[kind] = plan
        if self._obs_on:
            self._obs.emit(Event(self.clock, "swap-hold", dict(
                kind=kind, fingerprint=plan_fp,
            )))
        self._install_pending_swaps()

    def _install_pending_swaps(self) -> None:
        for kind in list(self._pending_swap):
            adapter = self.adapters[kind]
            if adapter.has_work() or any(
                g.kind == kind for g in self._live.values()
            ):
                continue  # drain first; admission to this kind is held
            plan = self._pending_swap.pop(kind)
            adapter.install_plan(plan)
            self.plan_swaps.append(
                dict(kind=kind, round=self.rounds,
                     fingerprint=plan.fingerprint)
            )
            if self._obs_on:
                # install_plan rebuilt the engine — re-arm its sink
                eng = getattr(adapter, "engine", None)
                if eng is not None and hasattr(eng, "obs"):
                    eng.obs = self._obs
                self._obs.emit(Event(self.clock, "swap-inst", dict(
                    kind=kind, round=self.rounds,
                    fingerprint=plan.fingerprint,
                )))

    # ---------------------------------------------------------- admission

    def _try_admit(self, idx: int) -> bool:
        """Admit the ``idx``-th queued request if its engine has a slot."""
        greq = self.queue.peek(idx)
        if greq.kind in self._pending_swap:
            return False  # admission held until the plan swap installs
        adapter = self.adapters[greq.kind]
        if adapter.free_slots() < 1:
            return False
        self.queue.pop_at(idx)
        charged = adapter.admit(greq)
        greq.admitted = self.clock
        greq.admitted_round = self.rounds
        self._live[greq.rid] = greq
        if self._obs_on:
            self._obs.emit(Event(self.clock, "admit", dict(
                rid=greq.rid, kind=greq.kind, qos=greq.qos,
                charged=int(charged),
            )))
        if charged:
            self._admit_charges[greq.qos] = (
                self._admit_charges.get(greq.qos, 0) + int(charged)
            )
        return True

    def _classes(self) -> list[str]:
        """Scheduling classes, declared-share order (kinds + QoS labels)."""
        return list(self.shares)

    def _admission_phase(self) -> None:
        # A kind whose plan swap is draining is *held* — an operator
        # action, not arrival-order semantics — so every policy's scan
        # skips held-kind requests instead of letting one freeze admission
        # for the other kinds behind it (the swap-hold head-of-line leak).
        held = self._pending_swap
        if self.policy == "fifo":
            # strict arrival order among admissible kinds: a full engine
            # at the (non-held) head blocks the whole queue — the classic
            # failure mode the other policies fix
            progress = True
            while progress and self.queue:
                progress = False
                idx = next(
                    (i for i, g in enumerate(self.queue)
                     if g.kind not in held),
                    None,
                )
                if idx is not None and self._try_admit(idx):
                    progress = True
        elif self.policy == "fair":
            # round-robin classes, oldest-first within a class; a blocked
            # class never blocks the others
            progress = True
            while progress and self.queue:
                progress = False
                for c in self._classes():
                    idx = next(
                        (i for i, g in enumerate(self.queue)
                         if g.qos == c and g.kind not in held),
                        None,
                    )
                    if idx is not None and self._try_admit(idx):
                        progress = True
        else:  # edf
            progress = True
            while progress and self.queue:
                progress = False
                order = sorted(
                    range(len(self.queue)),
                    key=lambda i: (
                        self.queue.peek(i).deadline,
                        self.queue.peek(i).arrival,
                    ),
                )
                for idx in order:
                    if self._try_admit(idx):
                        progress = True
                        break  # indices shifted; re-sort

    # ---------------------------------------------------------- execution

    def _class_order(self) -> list[str]:
        """Execution priority between classes for fifo/edf: the class of
        the most urgent incomplete admitted request first.  Derived from
        the gateway's own live-request table — adapters owe the protocol
        nothing about how they track in-flight work, and completed history
        is never rescanned."""
        live_by_class: dict[str, list[GatewayRequest]] = {}
        for g in self._live.values():
            live_by_class.setdefault(g.qos, []).append(g)

        def urgency(c: str):
            live = live_by_class.get(c)
            if not live:
                return (1, 0)
            if self.policy == "edf":
                return (0, min(g.deadline for g in live))
            return (0, min(g.arrival for g in live))

        return sorted(self._classes(), key=urgency)

    def _class_has_work(self, c: str) -> bool:
        return any(a.has_work(qos=c) for a in self.adapters.values())

    def _do_work(self, kind: str, budget: float, qos: str | None,
                 force: bool = False, soft: float | None = None) -> int:
        adapter = self.adapters[kind]
        base = self._clock.round_spent  # intra-round offset of this call
        consumed, completed, events = adapter.work(
            int(budget), qos=qos, force=force,
            soft_limit=None if soft is None else int(soft),
        )
        self._clock.record_work(consumed, qos)
        if self._obs_on:
            # drain the adapter's execution-attribution log: each entry is
            # (rid, qos, cycles, offset-in-call), stamped like completions
            # so Σ exec cycles reconciles with worked_total exactly
            log = getattr(adapter, "exec_log", None)
            if log:
                for rid, equos, cyc, off in log:
                    self._obs.emit(Event(
                        self.clock + min(base + off, self.round_budget),
                        "exec",
                        dict(rid=rid, kind=kind, qos=equos, cycles=cyc),
                    ))
                log.clear()
            # adapter-level lifecycle annotations (the speculative engine's
            # draft/verify/accept/rollback moments): (etype, data, offset)
            # triples stamped exactly like exec attribution.  These carry
            # no cycle account of their own — the exec entries do — so
            # span reconciliation is untouched by their presence.
            slog = getattr(adapter, "obs_log", None)
            if slog:
                for etype, data, off in slog:
                    self._obs.emit(Event(
                        self.clock + min(base + off, self.round_budget),
                        etype,
                        dict(kind=kind, **data),
                    ))
                slog.clear()
        prev_off = 0
        for item in completed:
            # protocol v3: (greq, offset) — stamp each completion at its
            # own micro-step's offset, so a request that finished on the
            # first step of a large quantum does not inherit the whole
            # chunk's latency.  Bare greqs (legacy adapters) stamp at the
            # call's full consumed, the pre-fix behavior.
            if isinstance(item, tuple):
                greq, off = item
            else:
                greq, off = item, consumed
            if off < prev_off:
                raise AssertionError(
                    f"adapter {kind!r} returned decreasing completion "
                    f"offsets ({off} after {prev_off})"
                )
            prev_off = off
            stamp = self.clock + min(base + off, self.round_budget)
            if stamp < greq.arrival:
                raise AssertionError(
                    f"completion stamp {stamp} precedes arrival "
                    f"{greq.arrival} for request {greq.rid}"
                )
            greq.finished = stamp
            greq.finished_round = self.rounds
            self._live.pop(greq.rid, None)
            if self._obs_on:
                self._obs.emit(Event(stamp, "complete", dict(
                    rid=greq.rid, kind=greq.kind, qos=greq.qos,
                    latency=greq.latency_cycles,
                )))
            # the result lives on greq.handle; drop the input payload so a
            # long-running gateway does not pin every served image/prompt
            greq.payload = None
        for ev in events:
            self.tile_events.append(ev)  # bounded: oldest drop off
            self._tile_events_seen += 1
            if self.on_event is not None:
                self.on_event(ev)
            if self._obs_on:
                self._obs.emit(Event(
                    self.clock + min(self._clock.round_spent,
                                     self.round_budget),
                    "tile",
                    dict(rid=ev.rid, klass=ev.klass, cycles=ev.cycles,
                         tile=ev.tile, done=bool(ev.done)),
                ))
        return consumed

    def _work_class(self, c: str, budget: float, force: bool = False,
                    soft: float | None = None) -> int:
        """Offer ``budget`` cycles (hard bound) to class ``c`` across its
        adapters; ``soft`` is the segment boundary no new step may start
        past."""
        used_total = 0
        for kind, adapter in self.adapters.items():
            if used_total >= budget and not force:
                break
            if adapter.has_work(qos=c):
                used = self._do_work(
                    kind, budget - used_total, c,
                    force=force and used_total == 0,
                    soft=None if soft is None else max(soft - used_total, 0),
                )
                used_total += used
                if used:
                    force = False
        if self._obs_on and used_total < budget and \
                self._class_has_work(c):
            # the preemption point: the class stopped with work pending
            # and budget in hand (next step unaffordable, or a mid-round
            # segment boundary) — its quantum carries to the next round
            self._obs.emit(Event(
                self.clock + min(self._clock.round_spent,
                                 self.round_budget),
                "preempt",
                dict(qos=c, used=used_total, budget=int(budget)),
            ))
        return used_total

    def _apply_admit_charges(self) -> None:
        """Atomic-mode prefill charges: eat into the round
        before any micro-step, debited from the class's quantum — the
        overdraft the preemptive path exists to avoid."""
        for qos in list(self._admit_charges):
            charged = self._admit_charges.pop(qos)
            if charged:
                self._clock.record_spent(charged)
                if self.policy == "fair":
                    self._deficit[qos] = (
                        self._deficit.get(qos, 0.0) - charged
                    )

    def _accrue_quanta(self) -> None:
        self._granted = set()
        for c, share in self.shares.items():
            if self._class_has_work(c) or self._deficit[c] < 0:
                self._deficit[c] += share * self.round_budget
                self._granted.add(c)
                if self._obs_on:
                    self._obs.emit(Event(self.clock, "grant", dict(
                        qos=c, quantum=share * self.round_budget,
                        deficit=self._deficit[c],
                    )))
            else:
                self._deficit[c] = 0.0  # no banking while idle

    def _grant_midround(self) -> None:
        """Quantum for a class that became backlogged mid-round (open-loop
        arrival after the round-start accrual): its share of the round's
        *remaining* capacity — it was absent for the part already spent,
        so the grant is pro-rated, never retroactive."""
        if self.policy != "fair":
            return
        remaining = max(self.round_budget - self._clock.round_spent, 0)
        for c, share in self.shares.items():
            if c not in self._granted and self._class_has_work(c):
                self._deficit[c] += share * remaining
                self._granted.add(c)
                if self._obs_on:
                    self._obs.emit(Event(
                        self.clock + self._clock.round_spent, "grant",
                        dict(qos=c, quantum=share * remaining,
                             deficit=self._deficit[c], midround=True),
                    ))

    def _execute(self, limit: float) -> None:
        """Spend modeled cycles until the round's intra-round clock
        reaches ``limit`` or no class can start an affordable micro-step.
        Called multiple times per round — mid-round arrivals partition the
        round into segments at their stamped offsets.  Modeled time flows
        to the segment boundary regardless: capacity nobody could (or was
        entitled to) use before an arrival is spent as idle, never banked
        — so completion stamps after an arrival are never earlier than
        the arrival itself."""
        limit = min(int(limit), self.round_budget)
        clk = self._clock
        self._apply_admit_charges()
        progress = True
        while progress and clk.round_spent < limit:
            progress = False
            soft = limit - clk.round_spent  # segment boundary offset
            room = self.round_budget - clk.round_spent  # physical round
            if room < 1:
                break
            if self.policy == "fair":
                # largest-deficit-first: when round capacity only fits one
                # micro-step, a fixed iteration order would systematically
                # serve earlier-declared classes and stall the rest even
                # as their banked quanta grow — the class with the most
                # credit goes first (stable sort: declared order on ties)
                order = sorted(
                    self._classes(),
                    key=lambda c: -self._deficit.get(c, 0.0),
                )
                for c in order:
                    soft = limit - clk.round_spent
                    room = self.round_budget - clk.round_spent
                    if soft <= 0 or room < 1:
                        break
                    budget = min(self._deficit.get(c, 0.0), room)
                    if budget < 1:
                        continue
                    used = self._work_class(c, budget, soft=soft)
                    if used:
                        # preemptive adapters never exceed the offered
                        # budget, so the quantum is never driven negative;
                        # an atomic adapter's overshoot past the budget is
                        # real service and stays as debt (atomic semantics)
                        # rather than being forgiven by the floor
                        if used <= budget:
                            self._deficit[c] = max(
                                self._deficit[c] - used, 0.0
                            )
                        else:
                            self._deficit[c] -= used
                        progress = True
                if not progress:
                    # quanta exhausted (or unaffordable) with budget left:
                    # work-conserving slack, un-charged (quanta stay
                    # non-negative), handed out in urgency order — the
                    # oldest live class first, not declaration order
                    for c in self._class_order():
                        soft = limit - clk.round_spent
                        room = self.round_budget - clk.round_spent
                        if soft <= 0 or room < 1:
                            break
                        used = self._work_class(c, room, soft=soft)
                        if used:
                            progress = True
            else:
                for c in self._class_order():
                    soft = limit - clk.round_spent
                    room = self.round_budget - clk.round_spent
                    if soft <= 0 or room < 1:
                        break
                    if self._work_class(c, room, soft=soft):
                        progress = True
        # idle time flows: the intra-round clock reaches the boundary
        clk.idle_to(limit)

    def _stall_limit(self) -> int:
        """Consecutive zero-progress rounds that prove a class's cheapest
        pending micro-step can never fit a round budget.  Under fair, a
        backlogged class's quantum grows by share x round_budget per
        round, so after ceil(1/min_share) rounds its deficit exceeds a
        full round budget — further stalling means the step itself is
        bigger than a round.  Other policies offer the whole round every
        round."""
        if self.policy == "fair":
            return math.ceil(1.0 / min(self.shares.values())) + 1
        return 1

    def _check_starvation(self) -> None:
        """Liveness escape for micro-steps larger than a whole round.

        Under ``fair`` the check is *per class*: a class with pending work
        and zero progress for ``_stall_limit`` consecutive rounds — even
        while other classes kept the gateway busy — is holding a step its
        ever-growing quantum can never fit inside a round; run exactly one
        such step, overdraft and all, and leave the overdraft as quantum
        debt so the class repays it.  Under ``fifo``/``edf`` per-class
        starvation is the *policy's own semantics* (head-of-line blocking
        is what FIFO means), so only a globally idle round with work
        pending — nothing anywhere could start — triggers the escape.
        Forced steps are counted in ``stats()['forced']`` — a
        modeled-capacity smell either way."""
        if self.policy != "fair":
            if self._clock.round_worked == 0 and any(
                a.has_work() for a in self.adapters.values()
            ):
                for c in self._class_order():
                    if self._class_has_work(c):
                        used = self._work_class(c, self.round_budget,
                                                force=True)
                        if used:
                            self._clock.forced += 1
                            if self._obs_on:
                                self._obs.emit(Event(
                                    self.clock, "forced",
                                    dict(qos=c, cycles=used),
                                ))
                            return
            return
        for c in self._classes():
            if not self._class_has_work(c) or \
                    self._clock.round_class_worked.get(c, 0) > 0:
                self._class_stalled[c] = 0
                continue
            self._class_stalled[c] = self._class_stalled.get(c, 0) + 1
            if self._class_stalled[c] < self._stall_limit():
                continue
            used = self._work_class(c, self.round_budget, force=True)
            if used:
                self._clock.forced += 1
                self._deficit[c] = self._deficit.get(c, 0.0) - used
                if self._obs_on:
                    self._obs.emit(Event(self.clock, "forced",
                                         dict(qos=c, cycles=used)))
            self._class_stalled[c] = 0

    # ------------------------------------------------------------- rounds

    def pending(self) -> bool:
        return bool(self.queue) or any(
            a.has_work() for a in self.adapters.values()
        )

    def step_round(self, arrivals=()) -> None:
        """One scheduling round: admit per policy, execute against the
        shared cycle budget, advance the modeled clock.

        ``arrivals`` is an iterable of ``(cycle, kind, payload, kwargs)``
        tuples injected open-loop: execution runs to each arrival's offset
        within the round, the request is submitted with its stamped
        ``arrival_cycle``, and a mid-round admission pass runs before
        execution resumes — so a request arriving mid-round can be served
        in the same round instead of waiting for the next boundary.
        Arrivals stamped at or past the round's end are rejected (a
        future-stamped request admitted early could finish before it
        "arrived" and corrupt the latency account) — feed each round only
        its own window, as ``workload.replay`` does.
        """
        arr = sorted(arrivals, key=lambda a: a[0])
        if arr and arr[-1][0] >= self.clock + self.round_budget:
            raise ValueError(
                f"arrival stamped at cycle {arr[-1][0]} is outside this "
                f"round [{self.clock}, {self.clock + self.round_budget}) — "
                f"defer it to its own round"
            )
        self._clock.begin_round()
        self._install_pending_swaps()
        # backlog: arrivals stamped at or before the round start
        while arr and arr[0][0] <= self.clock:
            cyc, kind, payload, kw = arr.pop(0)
            self.submit(kind, payload, arrival_cycle=cyc, **kw)
        self._admission_phase()
        if self.policy == "fair":
            self._accrue_quanta()
        for cyc, kind, payload, kw in arr:
            self._execute(max(cyc - self.clock, 0))
            self.submit(kind, payload, arrival_cycle=cyc, **kw)
            self._admission_phase()
            self._grant_midround()
        self._execute(self.round_budget)
        self._check_starvation()
        self._clock.end_round(self.round_budget)

    def advance_to(self, cycle: int) -> None:
        """Run scheduling rounds until the modeled clock reaches
        ``cycle`` (the open-loop replay idle path)."""
        while self.clock < cycle:
            self.step_round()

    def drain(self, *, max_rounds: int = 100_000) -> None:
        """Run rounds until nothing is queued or in flight."""
        while self.pending():
            if self.rounds >= max_rounds:
                raise RuntimeError(
                    f"gateway did not drain within {max_rounds} rounds "
                    f"(queue={len(self.queue)}, policy={self.policy})"
                )
            self.step_round()

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Per-class modeled-latency distribution + aggregate GOPS/W.
        Classes are QoS labels (adapter kinds for unlabeled traffic).
        Percentiles are exact order statistics
        (:func:`~repro_torch.serve.clock.exact_percentile`): every reported
        p50/p99 is an actual observed latency, never an interpolation."""
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
                # every request carries an absolute deadline (explicit
                # deadline_cycles or deadline_factor x estimate) — misses
                # reconcile with the SloMonitor's online counts
                deadline_misses=sum(
                    1 for g in of_c if g.done and g.finished > g.deadline
                ),
            )
        total_ops = sum(a.total_ops for a in self.adapters.values())
        elapsed_s = self.clock / cm.FREQ_HZ
        power = (
            cm.PAPER_TABLE1["proposed"]["gops"]
            / cm.PAPER_TABLE1["proposed"]["gops_w"]
        )
        gops = total_ops / elapsed_s / 1e9 if elapsed_s > 0 else 0.0
        out = dict(
            policy=self.policy,
            rounds=self.rounds,
            clock_cycles=self.clock,
            per_class=per_class,
            total_ops=total_ops,
            gops=gops,
            gops_w=gops / power,
            forced=self.forced,
            worked_cycles=self._clock.worked_total,
            class_worked_cycles=dict(self._clock.class_worked_total),
            tile_events_seen=self._tile_events_seen,
            tile_events_kept=len(self.tile_events),
            tile_events_dropped=self._tile_events_seen
            - len(self.tile_events),
            plan_swaps=list(self.plan_swaps),
            fallbacks={
                k: a.fallback_reason
                for k, a in self.adapters.items()
                if getattr(a, "fallback_reason", None)
            },
        )
        # an armed SloMonitor (directly, teed, or shard-wrapped) surfaces
        # its burn rates + miss attribution for this gateway's scope
        from repro_torch.obs.slo import find_monitor

        mon, shard = find_monitor(self._obs)
        if mon is not None:
            out["slo"] = mon.summary(scope=shard)
        # an armed EnergyMeter surfaces the joule ledger for the same
        # scope; metered GOPS/W divides this gateway's ops by *metered*
        # energy (active + idle), refining the analytic constant above
        from repro_torch.core import energy_model as em
        from repro_torch.obs.energy import find_meter

        meter, eshard = find_meter(self._obs)
        if meter is not None:
            eb = meter.summary(scope=eshard)
            eb["metered_gops_w"] = em.metered_gops_per_w(
                total_ops, eb["total_pj"]
            )
            eb["analytic_gops_w"] = out["gops_w"]
            out["energy"] = eb
        return out
