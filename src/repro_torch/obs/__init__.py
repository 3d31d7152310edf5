"""Telemetry of the port.

Everything but :mod:`~repro_torch.obs.timeline` is a copy of the
reference's ``obs`` modules: host code on Python ints, no tensors, riding
the *modeled* cycle clock (relation-(2) cycles of
:mod:`repro_torch.core.cycle_model`), never wall time, so a telemetry stream
is exactly reproducible from the same seed and trace, and equal to the
reference's on the same run:

* :mod:`~repro_torch.obs.events` — the structured event bus and its sinks;
* :mod:`~repro_torch.obs.spans` — per-request span assembly, exact latency
  breakdowns and ledger reconciliation;
* :mod:`~repro_torch.obs.capture` — record a live gateway's or fabric's
  arrivals back into trace schema v1;
* :mod:`~repro_torch.obs.slo` — declarative per-class SLOs and the online
  :class:`~repro_torch.obs.slo.SloMonitor` (burn rates, miss counts);
* :mod:`~repro_torch.obs.attrib` — deadline-miss attribution by dominant
  span segment;
* :mod:`~repro_torch.obs.energy` — the integer-picojoule
  :class:`~repro_torch.obs.energy.EnergyMeter` (the paper's FPGA energy
  model, not a card reading) and rolling power caps.

:mod:`~repro_torch.obs.timeline` is the port's own and runs on the wall
clock: spans and counters at the program's layer boundaries (the serving
loop, the U-Net forward, the MMA kernel's launch, the training step), off
unless a ``torch.profiler`` records or ``timeline.recording()`` is open,
and stamped on the profiler's clock.
"""
from . import attrib, capture, energy, events, slo, spans, timeline  # noqa: F401
from .attrib import (  # noqa: F401
    ATTRIB_CLASSES,
    attribute,
    attribution_shares,
    classify_segments,
    span_misses,
)
from .capture import CaptureSink  # noqa: F401
from .energy import (  # noqa: F401
    EnergyLedger,
    EnergyMeter,
    PowerSpec,
    attach_joules,
    find_meter,
)
from .events import (  # noqa: F401
    NULL_SINK,
    Event,
    MetricsSink,
    NullSink,
    RecordingSink,
    ShardSink,
    TeeSink,
    payload_spec,
)
from .slo import SloMonitor, SloSpec, find_monitor  # noqa: F401
from .spans import Span, assemble, breakdown, reconcile  # noqa: F401
