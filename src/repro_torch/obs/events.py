"""Structured event bus on the modeled cycle clock (a copy of the
reference's ``obs/events.py``).

Every scheduling-significant moment emits one :class:`Event` — a
``(cycle, etype, data)`` triple — into a *sink*.  The default sink is
:data:`NULL_SINK`, whose ``emit`` is a no-op and whose ``enabled`` flag
lets hot paths skip even building the event record.  The gateway emits
``submit``/``admit``/``grant``/``preempt``/``forced``/``swap-hold``/
``swap-inst``/``exec``/``tile``/``complete``/``export``/``import``, its
round clock ``round``; the engines emit sequence-stamped ``lm-prefill``,
``lm-step`` and ``seg-batch`` records (a per-engine counter in the
``cycle`` field).  The reference's module docstring holds the whole
taxonomy.  Canonical serialization (:meth:`Event.line`, sorted-key compact
JSON) is byte-identical across identically-seeded runs, and equal to the
reference's on the same run.
"""
from __future__ import annotations

import json


class Event:
    """One cycle-stamped telemetry record."""

    __slots__ = ("cycle", "etype", "data")

    def __init__(self, cycle: int, etype: str, data: dict | None = None):
        self.cycle = int(cycle)
        self.etype = str(etype)
        self.data = {} if data is None else data

    def to_obj(self):
        """JSON-ready ``[cycle, etype, data]`` triple."""
        return [self.cycle, self.etype, self.data]

    def line(self) -> str:
        """Canonical serialization: compact JSON, sorted keys — the unit
        of the byte-identical determinism guarantee."""
        return json.dumps(
            self.to_obj(), sort_keys=True, separators=(",", ":")
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event({self.cycle}, {self.etype!r}, {self.data!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Event)
            and self.cycle == other.cycle
            and self.etype == other.etype
            and self.data == other.data
        )


class NullSink:
    """The do-nothing sink. ``enabled`` is False so instrumented hot
    paths skip building event records entirely."""

    enabled = False

    def emit(self, event: Event) -> None:
        pass


#: Shared do-nothing sink — identity-compared by emitters, never mutated.
NULL_SINK = NullSink()


class RecordingSink:
    """Append-only in-memory sink (optionally filtered by etype)."""

    enabled = True

    def __init__(self, etypes=None):
        self.events: list[Event] = []
        self._etypes = None if etypes is None else frozenset(etypes)

    def emit(self, event: Event) -> None:
        if self._etypes is None or event.etype in self._etypes:
            self.events.append(event)

    def __len__(self) -> int:
        return len(self.events)

    def lines(self) -> list[str]:
        return [e.line() for e in self.events]

    def canonical_bytes(self) -> bytes:
        """The stream's canonical byte serialization (one JSON line per
        event, emission order) — equal across identically-seeded runs."""
        return ("\n".join(self.lines()) + "\n").encode() if self.events \
            else b""


class TeeSink:
    """Fan one emission out to several sinks."""

    enabled = True

    def __init__(self, sinks):
        self.sinks = [s for s in sinks if getattr(s, "enabled", True)]

    def emit(self, event: Event) -> None:
        for s in self.sinks:
            s.emit(event)


class ShardSink:
    """Wrap a base sink, tagging every event with its fabric shard index
    so per-shard streams interleave into one bus unambiguously."""

    enabled = True

    def __init__(self, base, shard: int):
        self.base = base
        self.shard = int(shard)

    def emit(self, event: Event) -> None:
        data = dict(event.data)
        data["shard"] = self.shard
        self.base.emit(Event(event.cycle, event.etype, data))


class MetricsSink:
    """Streaming metrics registry: per-etype counts and cycle sums,
    maintained incrementally so a long run never stores the stream."""

    enabled = True

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.cycles: dict[str, int] = {}

    def emit(self, event: Event) -> None:
        et = event.etype
        self.counts[et] = self.counts.get(et, 0) + 1
        c = event.data.get("cycles")
        if c:
            self.cycles[et] = self.cycles.get(et, 0) + int(c)

    def summary(self) -> dict:
        return dict(
            counts=dict(sorted(self.counts.items())),
            cycles=dict(sorted(self.cycles.items())),
        )


def payload_spec(kind: str, payload, prepare_kw: dict | None = None) -> dict:
    """Extract the workload-schema-v1 payload spec from a raw submitted
    payload *before* the adapter prepares it (preparation is lossy — e.g.
    the modeled seg adapter collapses ``{h, w}`` to a tile count).

    Handles the shapes the stack actually submits: spec dicts (modeled
    adapters / replayed traces pass them through), LM prompt arrays or
    :class:`~repro_torch.serve.engine.Request` objects (``prompt_len`` +
    ``max_new``), seg image arrays (``h`` + ``w``), and bare numeric
    costs (synthetic test adapters).  Unknown shapes degrade to ``{}``.
    Every value is a Python ``int``, a tensor payload's included.
    """
    kw = prepare_kw or {}
    if isinstance(payload, dict):
        return {
            k: v for k, v in payload.items()
            if isinstance(v, (int, float, str, bool))
        }
    if kind == "lm":
        prompt = getattr(payload, "prompt", payload)
        try:
            n = int(len(prompt))
        except TypeError:
            return {}
        max_new = getattr(payload, "max_new", None)
        if max_new is None:
            max_new = kw.get("max_new", 16)
        return dict(prompt_len=n, max_new=int(max_new))
    shape = getattr(payload, "shape", None)
    if shape is not None and len(shape) >= 2:
        return dict(h=int(shape[0]), w=int(shape[1]))
    if isinstance(payload, (int, float)):
        return dict(cost=int(payload))
    return {}
