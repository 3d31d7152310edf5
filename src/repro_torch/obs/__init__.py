"""Telemetry of the port: the structured event bus (``events``) and
per-request span assembly with exact latency breakdowns and ledger
reconciliation (``spans``).  The rest of the reference's ``obs`` package
(``attrib``, ``slo``, ``energy``, ``capture``, ``report``) is not ported
yet."""
from . import events, spans  # noqa: F401
from .events import NULL_SINK, Event, NullSink, RecordingSink  # noqa: F401
from .spans import Span, assemble, breakdown, reconcile  # noqa: F401
