"""Serving of the port.

:class:`~repro_torch.serve.gateway.Gateway` is the deployment entry point:
one admission-controlled queue fronting both engines — LM decode
(:class:`~repro_torch.serve.engine.Engine`, continuous batching over a slot
table) and tiled segmentation (``repro_torch.segserve.SegEngine``) —
co-scheduled against a shared modeled cycle budget under a pluggable policy
(FIFO / cycle-budget fair-share / EDF), with tuned-plan fingerprint
verification at admission and progressive tile streaming.  The engines, the
round clock and the shared queue/slot primitives stay importable directly
for single-workload use.  The reference's fabric, modeled adapters and
speculative decoding are not ported yet.
"""
from . import clock, engine, gateway, queue, serve_step  # noqa: F401
from .clock import FleetLedger, RoundClock  # noqa: F401
from .engine import Engine, Request  # noqa: F401
from .gateway import (  # noqa: F401
    Gateway,
    GatewayRequest,
    LMAdapter,
    SegAdapter,
    StalePlanError,
)
from .queue import FifoQueue, SlotTable  # noqa: F401
