"""Batched LM serving engine: continuous batching over a slot table.

Requests enter a queue; the engine packs up to ``batch`` active slots,
prefills new prompts into their cache rows (token by token, through the
decode path), then decodes one token per step for every active slot.
Slots free as sequences hit their token budget or the cache end and are
refilled from the queue.

With cfg.quant.mode='mma_int8' the whole decode path runs the paper's
digit-serial datapath; with ``impl='kernel'`` every int8 linear is one
launch of the scaled CUDA kernel.  Precision is governed by a per-layer
:class:`~repro_torch.core.plane_schedule.PlaneSchedule`
(``cfg.quant.plane_schedule``, built from the served weights via
:func:`lm_schedule_from_params`).

Two behaviours of the reference are kept as they are: the kernel path
quantizes activations with one scale per tensor, so a slot's numerics
depend on the other rows of its batch; and the engine's cache is bf16
whatever ``quant.kv_int8`` says (only direct ``decode_step`` callers with
an int8 cache take the int8-KV branch).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.events import NULL_SINK, Event

from . import serve_step as ss
from .queue import FifoQueue, SlotTable


@functools.lru_cache(maxsize=32)
def shared_decode(cfg, batch: int, max_seq: int, device: torch.device):
    """Process-wide decode step, one per (cfg, batch, max_seq, device): a
    plain cache of decode functions (eager PyTorch has no executable to
    share; every engine at one signature runs the same function)."""
    fn, _ = ss.make_decode(cfg, batch, max_seq, device=device)
    return fn


def lm_schedule_from_params(params, cfg, target_rel_err: float):
    """Per-layer plane budgets for a block-stacked LM from its float weights.

    Uses each layer's FFN up-projection (the widest, most truncation-
    sensitive matmul of a block) as the representative weight: quantize it
    per-channel int8 and pick the fewest planes whose analytic worst-case
    relative error (``core.early_term``) meets ``target_rel_err``.  Install
    the result with ``cfg.replace(quant=dataclasses.replace(cfg.quant,
    plane_schedule=tuple(sched)))``.
    """
    from repro_torch import models
    from repro_torch.core import quant
    from repro_torch.core.plane_schedule import PlaneSchedule

    if cfg.family not in models.PLANE_SCHEDULE_FAMILIES:
        raise NotImplementedError(
            f"per-layer plane schedules need a transformer block stack "
            f"({models.PLANE_SCHEDULE_FAMILIES}); {cfg.family!r} archs "
            f"serve with the global quant.planes knob"
        )
    blocks = params["blocks"]
    if "mlp" in blocks:
        ws = blocks["mlp"]["w_up"]["w"]  # (L, d_model, d_ff), stacked
    else:  # MoE blocks: fall back to the attention query projection
        ws = blocks["attn"]["wq"]["w"]
    wq = [
        quant.quantize_weights(ws[l].to(torch.float32), channel_axis=-1).values
        for l in range(cfg.n_layers)
    ]
    return PlaneSchedule.from_weights(wq, target_rel_err)


def lm_schedule_from_plan(plan, cfg):
    """The serving-time half of the autotuner: a certified LM
    :class:`~repro_torch.autotune.plan.TunedPlan` turned back into the
    per-layer policy the engine installs.  Prefer it over the analytic
    :func:`lm_schedule_from_params` when a plan exists: the analytic
    per-layer bound compounds loosely end to end, while the plan's budgets
    were validated against the measured logits error."""
    from repro_torch.core.plane_schedule import PlaneSchedule

    if getattr(plan, "workload", None) != "lm":
        raise ValueError("lm_schedule_from_plan needs an LM TunedPlan")
    if len(plan.planes) != cfg.n_layers:
        raise ValueError(
            f"plan covers {len(plan.planes)} layers but cfg has "
            f"{cfg.n_layers}"
        )
    return PlaneSchedule(
        planes=tuple(plan.planes),
        target_rel_err=plan.target_rel_err,
        layer_bounds=plan.layer_bounds,
    )


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    done: bool = False
    prefill_pos: int = 0  # prompt tokens already prefilled into the cache

    @property
    def prefill_remaining(self) -> int:
        return max(len(self.prompt) - self.prefill_pos, 0)

    @property
    def ready(self) -> bool:
        """Prefill complete — the request may join decode micro-batches."""
        return self.prefill_pos >= len(self.prompt)


# Families whose decode path supports a per-slot cache-index vector: each
# slot writes K/V at its own length and attends only its own history.
VECTOR_INDEX_FAMILIES = ("dense", "moe", "vlm")


class Engine:
    def __init__(self, cfg, params, *, batch: int, max_seq: int, extras=None, device=None):
        from repro_torch import models

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mod = models.build(cfg)
        self.params = self.mod.params_to(params, self.device)
        self.batch = batch
        self.max_seq = max_seq
        self.extras = extras or {}
        self.decode_fn = shared_decode(cfg, batch, max_seq, self.device)
        # bf16, as the reference's engine builds it (quant.kv_int8 unread)
        self.cache = self.mod.init_cache(cfg, batch, max_seq, device=self.device)
        self.slots: SlotTable[Request] = SlotTable(batch)
        self.lengths = np.zeros(batch, np.int32)
        self._vector_index = cfg.family in VECTOR_INDEX_FAMILIES
        # telemetry: engine-local micro-step records, sequence-stamped
        self.obs = NULL_SINK
        self._obs_seq = 0

    def _index(self, slot: int):
        """The cache index argument for a call driven by ``slot``: the
        per-slot length vector (a copy) for the vector-index families, else
        that slot's own length."""
        if self._vector_index:
            return self.lengths.copy()
        return int(self.lengths[slot])

    # ---------------------------------------------------------- admission

    def admit_slot(self, req: Request) -> bool:
        """Occupy a slot for ``req`` without prefilling — the chunked-
        prefill entry point; the request joins decode batches once
        ``req.ready``."""
        slot = self.slots.occupy(req)
        if slot is None:
            return False
        if self._vector_index:
            # fresh position track: the new occupant's writes overwrite the
            # predecessor's rows before any of its own reads reach them
            self.lengths[slot] = 0
        req.prefill_pos = 0
        return True

    def prefill(self, req: Request, max_tokens: int | None = None) -> int:
        """Run up to ``max_tokens`` prompt tokens of ``req`` through the
        decode path (token by token, slot-isolated); returns how many were
        processed.  Call with ``None`` to finish the prompt."""
        active = {id(r): i for i, r in self.slots.active()}
        slot = active.get(id(req))
        if slot is None:
            raise ValueError(f"request {req.rid} holds no slot")
        n = req.prefill_remaining if max_tokens is None else min(
            int(max_tokens), req.prefill_remaining
        )
        toks = req.prompt.astype(np.int32)
        logits = None
        for _ in range(n):
            tok = np.zeros((self.batch, 1), np.int32)
            tok[slot, 0] = int(toks[req.prefill_pos])
            logits, self.cache = self.decode_fn(
                self.params, tok, self.cache, self._index(slot), self.extras,
            )
            self.lengths[slot] += 1
            req.prefill_pos += 1
        if n and req.ready:
            req._last_logits = logits[slot, -1].to(torch.float32).cpu().numpy()  # type: ignore[attr-defined]
        if n and self.obs.enabled:
            self._obs_seq += 1
            self.obs.emit(Event(self._obs_seq, "lm-prefill", dict(
                rid=req.rid, tokens=int(n), slot=int(slot),
            )))
        return n

    def admit(self, req: Request) -> bool:
        """Atomic admission: occupy a slot and prefill the whole prompt."""
        if not self.admit_slot(req):
            return False
        self.prefill(req)
        return True

    # ------------------------------------------------------------- decode

    def ready_slots(self) -> list[tuple[int, Request]]:
        """Active slots whose occupant finished prefill — the decode
        micro-batch :meth:`step` will run."""
        return [(i, r) for i, r in self.slots.active() if r.ready]

    def step(self, only: set[int] | None = None) -> list[Request]:
        """One continuous-batching decode step for all ready slots (or the
        subset ``only`` of slot indices); returns the requests that
        completed on this step (empty when idle)."""
        active = self.ready_slots()
        if only is not None:
            active = [(i, r) for i, r in active if i in only]
        if not active:
            return []
        toks = np.zeros((self.batch, 1), np.int32)
        for i, req in active:
            toks[i, 0] = int(np.argmax(getattr(req, "_last_logits")))
        if self._vector_index:
            idx = self.lengths.copy()  # per-slot positions: slot-isolated writes
        else:
            idx = int(max(self.lengths[i] for i, _ in active))
        logits, self.cache = self.decode_fn(
            self.params, toks, self.cache, idx, self.extras,
        )
        last = logits[:, -1].to(torch.float32).cpu().numpy()
        completed: list[Request] = []
        for i, req in active:
            tok = int(np.argmax(last[i]))
            req.out.append(tok)
            req._last_logits = last[i]
            self.lengths[i] += 1
            if len(req.out) >= req.max_new or self.lengths[i] >= self.max_seq - 1:
                req.done = True
                self.slots.release(i)
                completed.append(req)
        if self.obs.enabled:
            self._obs_seq += 1
            self.obs.emit(Event(self._obs_seq, "lm-step", dict(
                slots=len(active), completed=len(completed),
            )))
        return completed

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion standalone (the engine owning
        its own FIFO loop)."""
        pending: FifoQueue[Request] = FifoQueue(requests)
        done: list[Request] = []
        while pending or self.slots.any_active():
            pending.pump(self.slots, self.admit)
            done.extend(self.step())
        return done
