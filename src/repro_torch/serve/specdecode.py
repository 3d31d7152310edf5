"""Precision-speculative decoding: truncated-plane drafts verified by the
full-digit datapath (the reference's ``serve/specdecode.py`` over the
port's engine, on the card unless ``device='cpu'``).

MSDF early termination makes truncated-plane compute a *cheap exact
prefix* of full-precision compute: a low-plane "draft" forward shares
weights, KV cache and kernels with the full-digit "verifier" — no second
model, no second cache.  One speculative round:

1. **Draft** — decode ``k`` tokens greedily under the draft plane
   schedule (one low-plane decode call per token; the chain serializes on
   the argmax feedback).  Draft KV rows land in the shared cache at the
   slot's own positions.
2. **Verify** — roll the per-slot cache index back to the round's base
   length and run the ``k+1`` now-known tokens through the *full-digit*
   schedule, one decode call each.  The verify pass overwrites every draft
   KV row with its full-precision value before anything reads it, so the
   surviving cache state is the greedy run's.
   :func:`repro_torch.core.cycle_model.lm_spec_step_cycles` prices the
   pass at one full step plus ``k`` initiation intervals (the paper's FPGA
   model: the verify tokens carry no feedback, so they pipeline through
   the layer stack).
3. **Accept** — take the longest prefix of drafts matching the verifier's
   greedy choices, emit those tokens plus the verifier's one correction,
   and roll the cache index back past the first mismatch.

On ``impl='kernel'`` every draft and verify linear is one launch of the
scaled MMA kernel, at the draft or the verify plane budget.  Greedy
equivalence is exact where each slot's numerics are its own: on the Horner
route (``impl='horner'``) activations are quantized per batch row.  The
kernel route quantizes with one scale per tensor, as the reference's does,
so rows whose drafts were rejected feed their batch mates' scale and a
spec stream may part from the greedy one there.

Both passes must run the digit-serial datapath (``quant.mode =
'mma_int8'``).  :class:`SpecLMAdapter` serves the engine behind the
gateway: a round's price is fixed before it runs (draft + verify, however
many drafts survive), so the adapter yields at quantum boundaries exactly
like the base decode loop; only emitted tokens earn op credit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cycle_model as cm
from repro_torch.core.bitplane import N_BITS
from repro_torch.obs.events import Event

from .engine import Engine, Request, shared_decode
from .gateway import LMAdapter


def _last_logits(logits) -> np.ndarray:
    """The last position's logits of every row, as float32 on the host:
    one device-to-host copy per decode call."""
    return logits[:, -1].to(torch.float32).cpu().numpy()


class SpecEngine(Engine):
    """Continuous-batching engine whose decode loop speculates.

    ``draft_schedule`` is the per-layer plane budget of the draft pass
    (``k`` tokens per round); verification always runs the engine's own
    (full) schedule.  Requires a vector-index family (the rollback is a
    per-slot cache-index rewind) and the digit-serial datapath.  ``device``
    as :class:`~repro_torch.serve.engine.Engine`: the card unless
    ``'cpu'``.
    """

    def __init__(self, cfg, params, *, batch: int, max_seq: int,
                 draft_schedule, k: int, extras=None, device=None):
        super().__init__(cfg, params, batch=batch, max_seq=max_seq,
                         extras=extras, device=device)
        if not self._vector_index:
            raise ValueError(
                f"speculative decode needs a per-slot cache-index family "
                f"(dense/moe/vlm); {cfg.family!r} has no position-addressed "
                f"state to roll back"
            )
        if cfg.quant.mode != "mma_int8":
            raise ValueError(
                "speculative decode needs the digit-serial datapath "
                "(quant.mode='mma_int8'): the draft is a bit-mask prefix "
                "of the full-digit compute, and integer accumulation is "
                "what makes acceptance bit-stable"
            )
        if int(k) < 1:
            raise ValueError(f"speculation depth k {k} < 1")
        sched = tuple(int(p) for p in draft_schedule)
        if len(sched) != cfg.n_layers:
            raise ValueError(
                f"draft schedule covers {len(sched)} layers, cfg has "
                f"{cfg.n_layers}"
            )
        for p in sched:
            if not (1 <= p <= N_BITS):
                raise ValueError(f"draft plane count {p} outside 1..{N_BITS}")
        self.k = int(k)
        self.draft_schedule = sched
        self._draft_cfg = cfg.replace(
            quant=dataclasses.replace(cfg.quant, plane_schedule=sched)
        )
        # the same weights, cache and kernels as the verifier, differing
        # only in how many MSB planes the matmuls consume
        self.draft_fn = shared_decode(self._draft_cfg, batch, max_seq, self.device)
        # one record per speculative round (k, per-slot accepted/emitted);
        # the adapter drains it for pricing + obs, standalone callers
        # (tune_spec, tests) read it directly
        self.spec_trace: list[dict] = []

    # ------------------------------------------------------------ planning

    def plan_k(self, only: set[int] | None = None) -> int:
        """The speculation depth the next :meth:`spec_step` will use for
        this slot set — deterministic *before* stepping, so the adapter
        can price the round against its quantum first.  0 means the round
        degenerates to one greedy step (no headroom to speculate)."""
        active = self.ready_slots()
        if only is not None:
            active = [(i, r) for i, r in active if i in only]
        if not active:
            return 0
        # every slot needs room for k drafts + 1 correction before the
        # sequence cap; drafting past the neediest slot's remaining
        # max_new is pure waste, so cap there too
        headroom = min(
            self.max_seq - 1 - int(self.lengths[i]) for i, _ in active
        ) - 1
        need = max(r.max_new - len(r.out) for _, r in active) - 1
        return max(min(self.k, headroom, need), 0)

    # ------------------------------------------------------------- decode

    def _call(self, fn, toks) -> np.ndarray:
        """One decode call at the slots' current lengths; the last
        position's logits of every row on the host."""
        logits, self.cache = fn(
            self.params, toks, self.cache, self.lengths.copy(), self.extras,
        )
        return _last_logits(logits)

    def spec_step(self, only: set[int] | None = None):
        """One speculative decode round for all ready slots (``only``
        scopes like :meth:`Engine.step`).  Returns ``(completed, record)``
        where ``record`` is the round's spec-trace entry — ``None`` when
        the round fell back to a plain greedy step (no speculation
        headroom)."""
        active = self.ready_slots()
        if only is not None:
            active = [(i, r) for i, r in active if i in only]
        if not active:
            return [], None
        k = self.plan_k(only)
        if k < 1:
            return super().step(only), None
        base = {i: int(self.lengths[i]) for i, _ in active}

        # 1. draft chain: k truncated-plane steps with greedy feedback
        feed = {
            i: int(np.argmax(getattr(r, "_last_logits"))) for i, r in active
        }
        drafts: dict[int, list[int]] = {i: [] for i, _ in active}
        for _ in range(k):
            toks = np.zeros((self.batch, 1), np.int32)
            for i, _ in active:
                toks[i, 0] = feed[i]
            dlast = self._call(self.draft_fn, toks)
            for i, _ in active:
                y = int(np.argmax(dlast[i]))
                drafts[i].append(y)
                feed[i] = y
                self.lengths[i] += 1

        # 2. rewind to base: draft KV rows stay in the cache but above
        # the index — the verify pass overwrites each with its
        # full-precision value before anything reads it
        for i, _ in active:
            self.lengths[i] = base[i]

        # 3. verify: k+1 known tokens through the full-digit schedule
        vlogits: dict[int, list[np.ndarray]] = {i: [] for i, _ in active}
        for t in range(k + 1):
            toks = np.zeros((self.batch, 1), np.int32)
            for i, r in active:
                if t == 0:
                    toks[i, 0] = int(np.argmax(getattr(r, "_last_logits")))
                else:
                    toks[i, 0] = drafts[i][t - 1]
            last = self._call(self.decode_fn, toks)
            for i, _ in active:
                vlogits[i].append(last[i])
            for i, _ in active:
                self.lengths[i] += 1

        # 4. accept longest matching prefix; roll back past the mismatch
        completed: list[Request] = []
        per_slot: list[dict] = []
        for i, req in active:
            v = vlogits[i]
            a = 0
            while a < k and int(np.argmax(v[a])) == drafts[i][a]:
                a += 1
            emit = [int(np.argmax(v[t])) for t in range(a + 1)]
            emit = emit[: req.max_new - len(req.out)]
            n = len(emit)  # >= 1: active implies max_new not yet reached
            req.out.extend(emit)
            req._last_logits = v[n - 1]
            self.lengths[i] = base[i] + n  # the rollback
            per_slot.append(dict(
                slot=int(i), rid=req.rid, accepted=int(a), emitted=int(n),
            ))
            if len(req.out) >= req.max_new or \
                    self.lengths[i] >= self.max_seq - 1:
                req.done = True
                self.slots.release(i)
                completed.append(req)
        record = dict(
            k=int(k),
            slots=per_slot,
            drafted=k * len(active),
            accepted=sum(s["accepted"] for s in per_slot),
            emitted=sum(s["emitted"] for s in per_slot),
        )
        self.spec_trace.append(record)
        if self.obs.enabled:
            self._obs_seq += 1
            self.obs.emit(Event(self._obs_seq, "lm-spec", dict(
                slots=len(active), k=int(k),
                accepted=record["accepted"], emitted=record["emitted"],
                completed=len(completed),
            )))
        return completed, record


class SpecLMAdapter(LMAdapter):
    """Gateway adapter serving :class:`SpecEngine` — the speculative
    engine mode.

    Draft knobs come either directly (``draft_schedule``, ``k``) or from
    a v3 :class:`~repro_torch.autotune.plan.TunedPlan` carrying
    ``spec_planes`` / ``spec_k`` (the :func:`repro_torch.autotune.tune_spec`
    output); explicit arguments win.  Everything else — admission, chunked
    prefill, QoS scoping, plan fingerprint verification, hot swap — is the
    base LM adapter, unchanged.  Each speculative round is priced with
    :func:`repro_torch.core.cycle_model.lm_spec_step_cycles`'s terms
    *before* it runs (the cost is independent of acceptance), so the
    preemptive never-overdraft invariant holds with no special cases.
    """

    def __init__(self, cfg, params, *, batch: int, max_seq: int,
                 plan=None, extras=None, preemptive: bool = True,
                 draft_schedule=None, k: int | None = None, device=None):
        if plan is not None and getattr(plan, "spec_planes", None):
            if draft_schedule is None:
                draft_schedule = plan.spec_planes
            if k is None:
                k = plan.spec_k
        if draft_schedule is None or k is None:
            raise ValueError(
                "SpecLMAdapter needs draft_schedule and k — pass them "
                "directly or via a TunedPlan with spec_planes/spec_k "
                "(autotune.tune_spec)"
            )
        self._draft_schedule = tuple(int(p) for p in draft_schedule)
        self._spec_k = int(k)
        # lifecycle annotations (draft/verify/accept/rollback) the
        # gateway drains into cycle-stamped events next to exec
        self.obs_log: list[tuple] = []
        super().__init__(cfg, params, batch=batch, max_seq=max_seq,
                         plan=plan, extras=extras, preemptive=preemptive,
                         device=device)

    def _make_engine(self, cfg):
        return SpecEngine(
            cfg, self.params, batch=self._batch, max_seq=self._max_seq,
            extras=self._extras, draft_schedule=self._draft_schedule,
            k=self._spec_k, device=self.device,
        )

    def _build(self, cfg) -> None:
        super()._build(cfg)
        kw = self._price_kw
        self._draft_step_cycles = cm.lm_step_cycles(
            cfg.d_model, cfg.d_ff, cfg.n_layers, self._draft_schedule, **kw
        )
        self._interval_cycles = max(cm.lm_layer_cycles(
            cfg.d_model, cfg.d_ff, cfg.n_layers,
            cfg.quant.plane_schedule, **kw
        ))

    def _spec_slot_cycles(self, k: int) -> int:
        """Per-slot price of one speculative round at depth ``k`` —
        fixed before the round runs, regardless of acceptance."""
        if k < 1:
            return self._step_cycles
        return (k * self._draft_step_cycles + self._step_cycles
                + k * self._interval_cycles)

    def _work_decode(self, budget: int, consumed: int, qos, force: bool,
                     soft_limit, completed) -> int:
        scoped = self.preemptive  # SpecEngine is always vector-index
        while True:
            slots = self._ready_slots(qos)
            if not slots:
                break
            decoding = slots if scoped else self.engine.ready_slots()
            only = {i for i, _ in decoding}
            k = self.engine.plan_k(only)
            per_slot = self._spec_slot_cycles(k)
            cost = per_slot * len(decoding)
            if self.preemptive:
                over_hard = consumed + cost > budget
                at_soft = soft_limit is not None and consumed >= soft_limit
                if (over_hard or at_soft) and not (force and consumed == 0):
                    break
            elif consumed >= budget:
                break
            force = False
            start = consumed
            finished, rec = self.engine.spec_step(
                only=only if scoped else None
            )
            consumed += cost
            if rec is None:
                # greedy fallback round: base-path semantics and credit
                emitted = len(decoding)
            else:
                emitted = rec["emitted"]
                slot_req = {i: r for i, r in decoding}
            # op credit for emitted tokens only; the full round price
            # (draft + verify, wasted speculation included) counts
            # toward time
            self.total_ops += self._step_ops * emitted
            if self.obs_enabled:
                for _, r in decoding:
                    g2 = self._inflight.get(id(r))
                    if g2 is not None:
                        self.exec_log.append(
                            (g2.rid, g2.qos, per_slot, consumed)
                        )
                if rec is not None:
                    self._log_round(rec, start, consumed, cost, len(decoding),
                                    slot_req)
            completed.extend(
                (self._inflight.pop(id(r)), consumed)
                for r in finished
                if id(r) in self._inflight
            )
        return consumed

    def _log_round(self, rec, start: int, consumed: int, cost: int, n: int,
                   slot_req) -> None:
        """The round's draft/verify/accept/rollback entries of ``obs_log``."""
        draft_cycles = rec["k"] * self._draft_step_cycles * n
        draft_off = start + draft_cycles
        self.obs_log.append(("draft", dict(
            k=rec["k"], slots=n, cycles=draft_cycles,
        ), draft_off))
        self.obs_log.append(("verify", dict(
            tokens=rec["k"] + 1, slots=n, cycles=cost - (draft_off - start),
        ), consumed))
        for s in rec["slots"]:
            g2 = self._inflight.get(id(slot_req[s["slot"]]))
            if g2 is None:
                continue
            # per-slot cycle split by op class: (k-a) draft steps at the
            # draft-plane rate, (k-a) pipeline intervals at full digits
            rej = rec["k"] - s["accepted"]
            self.obs_log.append(("accept", dict(
                rid=g2.rid, qos=g2.qos, k=rec["k"],
                accepted=s["accepted"], emitted=s["emitted"],
                draft_cycles=rec["k"] * self._draft_step_cycles,
                verify_cycles=self._step_cycles
                + rec["k"] * self._interval_cycles,
                wasted_draft_cycles=rej * self._draft_step_cycles,
                wasted_verify_cycles=rej * self._interval_cycles,
            ), consumed))
            if s["accepted"] < rec["k"]:
                self.obs_log.append(("rollback", dict(
                    rid=g2.rid, qos=g2.qos, rejected=rej,
                ), consumed))
