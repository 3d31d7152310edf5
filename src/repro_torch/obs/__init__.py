"""Cycle-exact telemetry of the port (copies of the reference's ``obs``
modules: host code on Python ints, no tensors).

Everything here rides the *modeled* cycle clock (relation-(2) cycles of
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
  model, not a card reading) and rolling power caps;
* :mod:`~repro_torch.obs.report` — trend and breakdown tables from the
  committed ledger and ``BENCH_*.json`` artifacts.
"""
from . import attrib, capture, energy, events, report, slo, spans  # noqa: F401
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
