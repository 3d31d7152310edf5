"""Serving of the port.

:class:`~repro_torch.serve.gateway.Gateway` is the deployment entry point:
one admission-controlled queue fronting both engines — LM decode
(:class:`~repro_torch.serve.engine.Engine`, continuous batching over a slot
table) and tiled segmentation (``repro_torch.segserve.SegEngine``) —
co-scheduled against a shared modeled cycle budget under a pluggable policy
(FIFO / cycle-budget fair-share / EDF), with tuned-plan fingerprint
verification at admission and progressive tile streaming.  The engines, the
round clock and the shared queue/slot primitives stay importable directly
for single-workload use.  Precision-speculative decoding
(:class:`~repro_torch.serve.specdecode.SpecEngine`, served behind the
gateway by :class:`~repro_torch.serve.specdecode.SpecLMAdapter`) drafts
tokens at a truncated plane budget and verifies them at the full one.

:class:`~repro_torch.serve.fabric.Fabric` scales the gateway out: N shards
on independent :class:`~repro_torch.serve.clock.RoundClock` instances behind
a deterministic router, with work stealing and a
:class:`~repro_torch.serve.clock.FleetLedger` whose aggregates are exact to
the integer.  :mod:`repro_torch.serve.modeled` provides pricing-only
adapters, so fabric-scale benchmarks never build an engine.
"""
from . import (  # noqa: F401
    clock,
    engine,
    fabric,
    gateway,
    modeled,
    queue,
    serve_step,
    specdecode,
)
from .clock import FleetLedger, RoundClock  # noqa: F401
from .engine import Engine, Request  # noqa: F401
from .fabric import Fabric  # noqa: F401
from .gateway import (  # noqa: F401
    Gateway,
    GatewayRequest,
    LMAdapter,
    SegAdapter,
    StalePlanError,
)
from .modeled import ModeledLMAdapter, ModeledSegAdapter, modeled_materializer  # noqa: F401
from .queue import FifoQueue, SlotTable  # noqa: F401
from .specdecode import SpecEngine, SpecLMAdapter  # noqa: F401
