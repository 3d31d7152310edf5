"""Workload subsystem: trace-driven open-loop load generation (a copy of
the reference's ``workload`` package: numpy and the standard library).

Three layers, one artifact:

* :mod:`repro_torch.workload.arrivals` — seeded arrival processes (deterministic
  / Poisson / Markov-modulated on-off bursts) on the modeled cycle clock,
  pure functions of ``(seed, index)`` via a counter PRNG;
* :mod:`repro_torch.workload.trace` — the versioned, serialized
  :class:`~repro_torch.workload.trace.Trace` schema (request kind + payload spec
  + QoS class + arrival cycle + deadline), persisted atomically; canonical
  traces live under ``traces/`` in the repo root;
* :mod:`repro_torch.workload.replay` — the open-loop harness that injects a
  trace's arrivals *inside* gateway rounds at their stamped cycles and
  summarizes per-class latency / GOPS-per-W in the bench tracker schema;
  :func:`~repro_torch.workload.replay.replay_stream` is its lazy twin for
  generator feeds that never materialize;
* :mod:`repro_torch.workload.diurnal` — streaming diurnal/burst generators:
  infinite prefix-stable twins of the arrival processes, day-curve
  thinning (:func:`~repro_torch.workload.diurnal.modulate`), and
  :func:`~repro_torch.workload.diurnal.stream_requests` composing them into
  the lazy feed the capacity planner drives.
"""
from . import arrivals, diurnal, replay, trace  # noqa: F401
from .replay import (  # noqa: F401
    lm_materializer,
    replay as replay_trace,
    replay_stream,
    seg_materializer,
)
from .trace import Trace, TraceRequest, from_streams  # noqa: F401
