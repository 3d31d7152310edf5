"""Versioned, serialized request traces — the workload artifact.

A :class:`Trace` is the unit of reproducible load: a named, seeded list of
:class:`TraceRequest` s, each carrying *what* arrives (``kind`` — the
gateway adapter — plus a compact payload **spec**, not the payload
itself), *as what* (``qos`` scheduling class), *when* (``arrival_cycle``
on the modeled clock) and *by when* (optional ``deadline_cycles``).
Payloads are materialized at replay time from the spec and the trace seed
(``repro_torch.workload.replay``), so a committed trace is a few KB of JSON, not
megabytes of tensors, and regenerating payloads is bit-reproducible.

Traces persist with the checkpoint module's crash-safety discipline
(:func:`repro_torch.checkpoint.save_json_atomic`) and carry a schema version:
a reader refuses versions newer than it understands (same posture as
``TunedPlan``), and the bench tracker (``scripts/bench_diff.py``) treats a
version bump as a target change — rows from different trace schemas are
never diffed against each other.

Payload spec conventions (enforced by :func:`validate_payload`):

``kind='lm'``   ``{"prompt_len": int, "max_new": int}``
``kind='seg'``  ``{"h": int, "w": int}``

Other kinds pass through unvalidated (synthetic adapters in tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field

# the schema name the reference writes: traces load in either package
TRACE_SCHEMA = "repro.workload.trace"
TRACE_VERSION = 1

_PAYLOAD_KEYS = {
    "lm": ("prompt_len", "max_new"),
    "seg": ("h", "w"),
}


def validate_payload(kind: str, payload: dict) -> dict:
    """Check a payload spec carries its kind's required integer fields."""
    required = _PAYLOAD_KEYS.get(kind)
    if required is None:
        return dict(payload)
    missing = [k for k in required if k not in payload]
    if missing:
        raise ValueError(
            f"{kind!r} payload spec missing {missing}: {payload}"
        )
    for k in required:
        if int(payload[k]) < 1:
            raise ValueError(f"{kind!r} payload {k}={payload[k]} < 1")
    return dict(payload)


@dataclass(frozen=True)
class TraceRequest:
    """One arrival: spec, class, stamp."""

    kind: str
    qos: str
    arrival_cycle: int
    payload: dict
    deadline_cycles: int | None = None

    def __post_init__(self):
        if self.arrival_cycle < 0:
            raise ValueError(f"arrival_cycle {self.arrival_cycle} < 0")
        if self.deadline_cycles is not None and self.deadline_cycles < 1:
            raise ValueError(f"deadline_cycles {self.deadline_cycles} < 1")
        validate_payload(self.kind, self.payload)

    def to_json(self) -> dict:
        d = dict(kind=self.kind, qos=self.qos,
                 arrival_cycle=int(self.arrival_cycle),
                 payload=dict(self.payload))
        if self.deadline_cycles is not None:
            d["deadline_cycles"] = int(self.deadline_cycles)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TraceRequest":
        return cls(
            kind=str(d["kind"]),
            qos=str(d.get("qos", d["kind"])),
            arrival_cycle=int(d["arrival_cycle"]),
            payload=dict(d["payload"]),
            deadline_cycles=(
                None if d.get("deadline_cycles") is None
                else int(d["deadline_cycles"])
            ),
        )


@dataclass(frozen=True)
class Trace:
    """A named, seeded, versioned request trace (requests sorted by
    arrival cycle at construction — replay order is the schema, not an
    accident of builder order)."""

    name: str
    seed: int
    requests: tuple[TraceRequest, ...]
    description: str = ""
    meta: dict = field(default_factory=dict)
    version: int = TRACE_VERSION

    def __post_init__(self):
        object.__setattr__(
            self, "requests",
            tuple(sorted(self.requests, key=lambda r: (r.arrival_cycle,))),
        )
        if not self.name:
            raise ValueError("a trace needs a name")

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def qos_classes(self) -> list[str]:
        """Distinct scheduling classes, in first-arrival order."""
        seen: list[str] = []
        for r in self.requests:
            if r.qos not in seen:
                seen.append(r.qos)
        return seen

    @property
    def kinds(self) -> list[str]:
        seen: list[str] = []
        for r in self.requests:
            if r.kind not in seen:
                seen.append(r.kind)
        return seen

    @property
    def span_cycles(self) -> int:
        """Cycles from 0 to the last arrival."""
        return self.requests[-1].arrival_cycle if self.requests else 0

    # --------------------------------------------------------- persistence

    def to_json(self) -> dict:
        return dict(
            schema=TRACE_SCHEMA,
            version=self.version,
            name=self.name,
            seed=int(self.seed),
            description=self.description,
            meta=dict(self.meta),
            requests=[r.to_json() for r in self.requests],
        )

    @classmethod
    def from_json(cls, d: dict) -> "Trace":
        if d.get("schema") not in (None, TRACE_SCHEMA):
            raise ValueError(f"not a workload trace: schema={d.get('schema')!r}")
        version = int(d.get("version", TRACE_VERSION))
        if version > TRACE_VERSION:
            raise ValueError(
                f"trace version {version} is newer than this code "
                f"({TRACE_VERSION}) — refusing to misread a workload"
            )
        return cls(
            name=str(d["name"]),
            seed=int(d["seed"]),
            requests=tuple(
                TraceRequest.from_json(r) for r in d["requests"]
            ),
            description=str(d.get("description", "")),
            meta=dict(d.get("meta") or {}),
            version=version,
        )

    def save(self, path) -> None:
        """Atomic JSON write (crash-safe, same discipline as checkpoints
        and tuned plans)."""
        from repro_torch.checkpoint import save_json_atomic

        save_json_atomic(path, self.to_json())

    @classmethod
    def load(cls, path) -> "Trace":
        from repro_torch.checkpoint import load_json

        return cls.from_json(load_json(path))

    def describe(self) -> str:
        per_qos = {
            q: sum(1 for r in self.requests if r.qos == q)
            for q in self.qos_classes
        }
        return (
            f"Trace[{self.name}] v{self.version} seed={self.seed} "
            f"n={len(self)} span={self.span_cycles} cycles "
            f"classes={per_qos}"
        )


def from_streams(name: str, seed: int, streams, *, description: str = "",
                 meta: dict | None = None) -> Trace:
    """Assemble a trace from labeled arrival streams.

    ``streams`` is an iterable of dicts, one per traffic class::

        dict(kind='lm', qos='interactive',
             arrivals=[...cycles...],          # e.g. from workload.arrivals
             payload={'prompt_len': 4, 'max_new': 8},   # spec or fn(i)
             deadline_cycles=None)

    ``payload`` may be a callable ``f(i) -> dict`` for per-request specs.
    """
    reqs: list[TraceRequest] = []
    for s in streams:
        payload = s["payload"]
        for i, cyc in enumerate(s["arrivals"]):
            spec = payload(i) if callable(payload) else dict(payload)
            reqs.append(
                TraceRequest(
                    kind=s["kind"],
                    qos=s.get("qos", s["kind"]),
                    arrival_cycle=int(cyc),
                    payload=spec,
                    deadline_cycles=s.get("deadline_cycles"),
                )
            )
    return Trace(name=name, seed=seed, requests=tuple(reqs),
                 description=description, meta=dict(meta or {}))
