"""Trace capture: record a live gateway/fabric's arrivals back into
workload trace schema v1 (a copy of the reference's ``obs/capture.py``; no
tensor is touched here).

The :class:`CaptureSink` listens to the event bus for ``submit`` events
(one per arrival, on whichever shard it routed to — fabric streams work
unchanged because shard routing happens *after* arrival, and the stamped
arrival cycle travels with the request).  Each record carries the raw
payload spec the gateway extracted *before* adapter preparation
(:func:`repro_torch.obs.events.payload_spec`), so :meth:`CaptureSink.to_trace`
rebuilds a schema-v1 :class:`~repro_torch.workload.trace.Trace` whose requests
reproduce the observed run:

- arrivals keep their exact modeled-cycle stamps;
- deadlines are stored relative (``deadline - arrival``), the schema's
  convention;
- the trace is marked ``meta['source'] = 'captured'`` so downstream
  tooling can tell captured traces from generated ones;
- replayed with the same seed, the trace's materializers regenerate
  bit-identical payloads: :class:`~repro_torch.workload.trace.Trace` sorts
  requests by arrival (stable — ties keep emission order, which is
  submission order), so request *indices* match the original trace and
  the ``(seed, index)`` materializer keying reproduces the same bytes.

A trace captured here equals the reference's capture of the same run, and
replaying it gives the same event stream.
"""
from __future__ import annotations

from .events import Event


class CaptureSink:
    """Record arrivals (``submit`` events) for trace reconstruction.

    Tee it with other sinks (:class:`~repro_torch.obs.events.TeeSink`) to
    capture and record/aggregate in one pass.
    """

    enabled = True

    def __init__(self):
        self.records: list[Event] = []

    def emit(self, event: Event) -> None:
        if event.etype == "submit":
            self.records.append(event)

    def __len__(self) -> int:
        return len(self.records)

    def to_trace(self, name: str, *, seed: int, description: str = "",
                 meta: dict | None = None):
        """Build a schema-v1 trace from the captured arrivals.

        ``seed`` keys payload materialization at replay: pass the
        original trace's seed to reproduce the original payload bytes
        (see module docstring), or any seed for a statistically
        equivalent workload.
        """
        from repro_torch.workload.trace import Trace, TraceRequest

        requests = []
        for e in self.records:
            d = e.data
            deadline = d.get("deadline")
            dc = None
            if deadline is not None:
                dc = int(deadline) - e.cycle
                if dc < 1:
                    dc = None  # schema requires >= 1; fall back to default
            requests.append(
                TraceRequest(
                    kind=d["kind"],
                    arrival_cycle=e.cycle,
                    payload=dict(d.get("spec") or {}),
                    qos=d.get("qos") or d["kind"],
                    deadline_cycles=dc,
                )
            )
        m = dict(meta or {})
        m["source"] = "captured"
        m.setdefault("captured_requests", len(requests))
        return Trace(
            name=name,
            seed=int(seed),
            description=description
            or f"captured from a live run ({len(requests)} arrivals)",
            requests=requests,
            meta=m,
        )
