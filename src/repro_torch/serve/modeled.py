"""Modeled (pricing-only) engine adapters for capacity-scale benchmarks (a
copy of the reference's ``serve/modeled.py``; no tensor is touched here).

Fabric benchmarks replay traces at 10-100x arrival rates across N shards;
running the real engines at that scale would dominate CI wall time
while the things under test — routing, work stealing, fleet-ledger
additivity, per-class latency under load — are pure cycle-clock
scheduling.  These adapters speak the full gateway adapter protocol
(including protocol-v3 per-completion offsets, preemptive ``soft_limit``
segment boundaries and forced-progress overdrafts) and price work with
the same relation-(2) model the real adapters use
(:func:`cm.lm_step_cycles`, :func:`cm.unet_window_cycles`), but never
touch model weights: a fabric of N shards replays a 100x trace in
milliseconds with exact integer ops/cycles accounts.

Payloads are the *trace* payload specs themselves (lm:
``{prompt_len, max_new}``, seg: ``{h, w}``) — :func:`modeled_materializer`
passes them through, so no prompt/image bytes are ever materialized.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import cycle_model as cm


def modeled_materializer():
    """Trace-spec pass-through for modeled adapters (any kind).

    Deterministic trivially: the submitted payload *is* the spec dict,
    a pure function of the trace request alone.
    """

    def mat(treq, trace_seed: int, index: int):
        return dict(treq.payload), {}

    return mat


@dataclass
class _LMJob:
    """One modeled LM request: token counts stand in for the KV cache."""

    rid: int
    prefill_remaining: int
    decode_remaining: int

    @property
    def done(self) -> bool:
        return self.prefill_remaining == 0 and self.decode_remaining == 0


@dataclass
class _SegJob:
    """One modeled segmentation request: a countdown of priced tiles."""

    rid: int
    tiles_remaining: int

    @property
    def done(self) -> bool:
        return self.tiles_remaining == 0


class _ModeledBase:
    """Shared protocol plumbing: slot accounting and inflight tracking."""

    plan = None
    fallback_reason = None
    # armed by Gateway.set_sink: when True, work() appends per-request
    # (rid, qos, cycles, offset) execution-attribution records
    obs_enabled = False
    obs_sink = None

    def __init__(self, *, slots: int):
        if slots < 1:
            raise ValueError(f"slots {slots} < 1")
        self._slots = int(slots)
        # admission order; gateway requests carry the jobs as handles
        self._order: list = []
        self.total_ops = 0
        self.exec_log: list[tuple] = []

    def verify_info(self):
        return None  # no tuned plan — nothing to invalidate

    def free_slots(self) -> int:
        return self._slots - len(self._order)

    def _matches(self, greq, qos) -> bool:
        return qos is None or greq.qos == qos

    def admit(self, greq) -> int:
        if self.free_slots() < 1:
            raise RuntimeError(f"admit called with no free {self.kind} slot")
        greq.handle = greq.payload
        self._order.append(greq)
        return 0  # preemptive: all work metered through work()

    def has_work(self, qos=None) -> bool:
        return any(
            self._matches(g, qos) and not g.handle.done for g in self._order
        )


class ModeledLMAdapter(_ModeledBase):
    """Continuous-batching LM decode, priced but not executed.

    Mirrors :class:`~repro_torch.serve.gateway.LMAdapter`'s preemptive path:
    chunked prefill in admission order (each token charged at the step
    price), then batched decode — one modeled step advances every ready
    job, costing ``step_cycles`` per active job, and every job that
    finishes on a step completes at *that* step's offset.
    """

    kind = "lm"

    def __init__(self, *, batch: int, step_cycles: int, step_ops: int):
        super().__init__(slots=batch)
        self._step_cycles = int(step_cycles)
        self._step_ops = int(step_ops)

    @classmethod
    def from_config(cls, cfg, *, batch: int, max_seq: int):
        """Price from a model config exactly as LMAdapter does (same
        ``cm.lm_step_cycles`` itemization, same ``max_seq`` context
        bound) — no params, no engine build."""
        price_kw = dict(
            n_heads=cfg.n_heads, head_dim=cfg.hd,
            n_kv_heads=cfg.n_kv_heads, context=max_seq,
            n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        )
        return cls(
            batch=batch,
            step_cycles=cm.lm_step_cycles(
                cfg.d_model, cfg.d_ff, cfg.n_layers,
                cfg.quant.plane_schedule, **price_kw,
            ),
            step_ops=cm.lm_step_ops(
                cfg.d_model, cfg.d_ff, cfg.n_layers, **price_kw
            ),
        )

    def prepare(self, payload, *, rid: int, max_new: int = 16):
        if isinstance(payload, _LMJob):
            return payload  # idempotent (router-side estimates re-prepare)
        spec = payload
        return _LMJob(
            rid=rid,
            prefill_remaining=int(spec["prompt_len"]),
            decode_remaining=int(spec.get("max_new", max_new)),
        )

    def estimate_cycles(self, job: _LMJob) -> int:
        return (
            job.prefill_remaining + job.decode_remaining
        ) * self._step_cycles

    def work(self, budget: int, qos=None, force: bool = False,
             soft_limit: int | None = None):
        completed: list[tuple] = []
        consumed, force = self._work_prefill(
            0, budget, qos, force, soft_limit
        )
        consumed = self._work_decode(
            budget, consumed, qos, force, soft_limit, completed
        )
        done = {id(g) for g, _ in completed}
        if done:
            self._order = [g for g in self._order if id(g) not in done]
        return consumed, completed, []

    def _work_prefill(self, consumed, budget, qos, force, soft_limit):
        """Chunked prefill in admission order; returns the consumed
        cycles and whether the forced-progress escape is still live."""
        sc = self._step_cycles
        for greq in self._order:
            if not self._matches(greq, qos):
                continue
            job = greq.handle
            if job.prefill_remaining <= 0:
                continue
            n = min((budget - consumed) // sc, job.prefill_remaining)
            if soft_limit is not None:
                n_soft = -(-max(soft_limit - consumed, 0) // sc)
                n = min(n, n_soft)
            if n <= 0 and force and consumed == 0:
                n = 1  # forced progress: one token, overdraft recorded
            if n <= 0:
                break
            force = False
            job.prefill_remaining -= n
            consumed += n * sc
            self.total_ops += n * self._step_ops
            if self.obs_enabled:
                self.exec_log.append((greq.rid, greq.qos, n * sc, consumed))
            if job.prefill_remaining:
                break  # budget exhausted mid-prompt
        return consumed, force

    def _ready(self, qos) -> list:
        return [
            g for g in self._order
            if self._matches(g, qos)
            and g.handle.prefill_remaining == 0
            and g.handle.decode_remaining > 0
        ]

    def _work_decode(self, budget, consumed, qos, force, soft_limit,
                     completed):
        """Batched decode: every ready matching job advances together."""
        sc = self._step_cycles
        while True:
            ready = self._ready(qos)
            if not ready:
                break
            cost = sc * len(ready)
            over_hard = consumed + cost > budget
            at_soft = soft_limit is not None and consumed >= soft_limit
            if (over_hard or at_soft) and not (force and consumed == 0):
                break
            force = False
            consumed += cost
            self.total_ops += self._step_ops * len(ready)
            for g in ready:
                g.handle.decode_remaining -= 1
                if self.obs_enabled:
                    self.exec_log.append((g.rid, g.qos, sc, consumed))
                if g.handle.done:
                    completed.append((g, consumed))
        return consumed


class ModeledSpecLMAdapter(ModeledLMAdapter):
    """Precision-speculative decode, priced but not executed.

    Mirrors :class:`~repro_torch.serve.specdecode.SpecLMAdapter`'s chunked
    speculative rounds and its full event protocol — per-slot ``exec``
    attribution at the deterministic round price
    (:func:`cm.lm_spec_step_cycles` itemization: k sequential draft
    steps + one layer-pipelined verify pass), plus ``draft`` /
    ``verify`` / ``accept`` / ``rollback`` lifecycle annotations with
    the per-slot op-class cycle split the energy meter closes on —
    without touching weights.  Acceptance is a seed-free deterministic
    pattern (a pure function of the global round counter), so runs are
    byte-identical like every other modeled adapter.
    """

    def __init__(self, *, batch: int, step_cycles: int, step_ops: int,
                 draft_step_cycles: int, interval_cycles: int, k: int,
                 accept_pattern=(4, 4, 3, 4, 2, 4, 4, 3)):
        super().__init__(batch=batch, step_cycles=step_cycles,
                         step_ops=step_ops)
        if k < 1:
            raise ValueError(f"spec depth k {k} < 1")
        self._draft_step_cycles = int(draft_step_cycles)
        self._interval_cycles = int(interval_cycles)
        self._k = int(k)
        self._pattern = tuple(
            min(max(int(a), 0), self._k) for a in accept_pattern
        )
        if not self._pattern:
            raise ValueError("accept_pattern must be non-empty")
        self._spec_rounds = 0
        self.obs_log: list[tuple] = []

    @classmethod
    def from_config(cls, cfg, *, batch: int, max_seq: int,
                    draft_schedule=(2,), k: int = 4,
                    accept_pattern=(4, 4, 3, 4, 2, 4, 4, 3)):
        """Price drafts and verifies from a model config exactly as
        SpecLMAdapter does: draft steps under ``draft_schedule``, the
        verify pass layer-pipelined at the serve schedule's slowest
        layer interval."""
        price_kw = dict(
            n_heads=cfg.n_heads, head_dim=cfg.hd,
            n_kv_heads=cfg.n_kv_heads, context=max_seq,
            n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        )
        return cls(
            batch=batch,
            step_cycles=cm.lm_step_cycles(
                cfg.d_model, cfg.d_ff, cfg.n_layers,
                cfg.quant.plane_schedule, **price_kw,
            ),
            step_ops=cm.lm_step_ops(
                cfg.d_model, cfg.d_ff, cfg.n_layers, **price_kw
            ),
            draft_step_cycles=cm.lm_step_cycles(
                cfg.d_model, cfg.d_ff, cfg.n_layers,
                tuple(int(p) for p in draft_schedule), **price_kw,
            ),
            interval_cycles=max(cm.lm_layer_cycles(
                cfg.d_model, cfg.d_ff, cfg.n_layers,
                cfg.quant.plane_schedule, **price_kw,
            )),
            k=k,
            accept_pattern=accept_pattern,
        )

    def _slot_cycles(self) -> int:
        """Deterministic per-slot round price, fixed before acceptance
        — the never-overdraft invariant SpecLMAdapter keeps."""
        return (self._k * self._draft_step_cycles + self._step_cycles
                + self._k * self._interval_cycles)

    def _work_decode(self, budget, consumed, qos, force, soft_limit,
                     completed):
        k = self._k
        ds, iv, sc = (self._draft_step_cycles, self._interval_cycles,
                      self._step_cycles)
        per_slot = self._slot_cycles()
        while True:
            ready = self._ready(qos)
            if not ready:
                break
            n = len(ready)
            cost = per_slot * n
            over_hard = consumed + cost > budget
            at_soft = soft_limit is not None and consumed >= soft_limit
            if (over_hard or at_soft) and not (force and consumed == 0):
                break
            force = False
            start = consumed
            consumed += cost
            accepted = self._pattern[
                self._spec_rounds % len(self._pattern)
            ]
            self._spec_rounds += 1
            if self.obs_enabled:
                draft_c = k * ds * n
                self.obs_log.append(("draft", dict(
                    k=k, slots=n, cycles=draft_c,
                ), start + draft_c))
                self.obs_log.append(("verify", dict(
                    tokens=k + 1, slots=n, cycles=cost - draft_c,
                ), consumed))
            for g in ready:
                # accepted drafts + the verify pass's one correction
                emit = min(accepted + 1, g.handle.decode_remaining)
                g.handle.decode_remaining -= emit
                self.total_ops += self._step_ops * emit
                if self.obs_enabled:
                    self.exec_log.append((g.rid, g.qos, per_slot,
                                          consumed))
                    self.obs_log.append(("accept", dict(
                        rid=g.rid, qos=g.qos, k=k, accepted=accepted,
                        emitted=emit,
                        draft_cycles=k * ds,
                        verify_cycles=sc + k * iv,
                        wasted_draft_cycles=(k - accepted) * ds,
                        wasted_verify_cycles=(k - accepted) * iv,
                    ), consumed))
                    if accepted < k:
                        self.obs_log.append(("rollback", dict(
                            rid=g.rid, qos=g.qos, rejected=k - accepted,
                        ), consumed))
                if g.handle.done:
                    completed.append((g, consumed))
        return consumed


class ModeledSegAdapter(_ModeledBase):
    """Tiled segmentation, priced but not executed.

    A request's micro-step is one halo tile at a fixed modeled price;
    requests drain oldest-first within the invoking class, and a request
    completes at the offset of its last tile.
    """

    kind = "seg"

    def __init__(self, *, slots: int, tile: int, tile_cycles: int,
                 tile_ops: int):
        super().__init__(slots=slots)
        self._tile = int(tile)
        self._tile_cycles = int(tile_cycles)
        self._tile_ops = int(tile_ops)

    @classmethod
    def from_geometry(cls, *, in_ch: int = 4, base: int = 8, depth: int = 2,
                      convs_per_stage: int = 1, planes: int = 8,
                      tile: int = 28, halo: int = 12, slots: int = 4):
        """Price one halo window (``tile + 2*halo`` square) through the
        U-Net conv stack at a uniform ``planes`` schedule."""
        win = tile + 2 * halo
        layers = cm.unet_conv_layers(
            (win, win), in_ch, base, depth, convs_per_stage
        )
        schedule = (planes,) * len(layers)
        return cls(
            slots=slots,
            tile=tile,
            tile_cycles=cm.unet_window_cycles(
                (win, win), in_ch, base, depth, convs_per_stage, schedule
            ),
            tile_ops=cm.model_ops(layers),
        )

    def prepare(self, payload, *, rid: int):
        if isinstance(payload, _SegJob):
            return payload  # idempotent (router-side estimates re-prepare)
        spec = payload
        n_tiles = -(-int(spec["h"]) // self._tile) * (
            -(-int(spec["w"]) // self._tile)
        )
        return _SegJob(rid=rid, tiles_remaining=n_tiles)

    def estimate_cycles(self, job: _SegJob) -> int:
        return job.tiles_remaining * self._tile_cycles

    def work(self, budget: int, qos=None, force: bool = False,
             soft_limit: int | None = None):
        consumed = 0
        completed: list[tuple] = []
        tc = self._tile_cycles
        for greq in self._order:
            if not self._matches(greq, qos) or greq.handle.done:
                continue
            job = greq.handle
            while job.tiles_remaining > 0:
                over_hard = consumed + tc > budget
                at_soft = soft_limit is not None and consumed >= soft_limit
                if (over_hard or at_soft) and not (force and consumed == 0):
                    break
                force = False
                job.tiles_remaining -= 1
                consumed += tc
                self.total_ops += self._tile_ops
                if self.obs_enabled:
                    self.exec_log.append((greq.rid, greq.qos, tc, consumed))
                if job.done:
                    completed.append((greq, consumed))
            else:
                continue
            break  # budget/boundary hit mid-request
        done = {id(g) for g, _ in completed}
        if done:
            self._order = [g for g in self._order if id(g) not in done]
        return consumed, completed, []
