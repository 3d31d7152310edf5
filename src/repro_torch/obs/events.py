"""Structured event bus on the modeled cycle clock (the part the
segmentation engine emits into).

Every scheduling-significant moment emits one :class:`Event` — a
``(cycle, etype, data)`` triple — into a *sink*.  The default sink is
:data:`NULL_SINK`, whose ``emit`` is a no-op and whose ``enabled`` flag
lets hot paths skip even building the event record.  The segmentation
engine emits sequence-stamped ``seg-batch`` records, one per micro-batch.
Canonical serialization (:meth:`Event.line`, sorted-key compact JSON) is
byte-identical across identically-seeded runs.
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
