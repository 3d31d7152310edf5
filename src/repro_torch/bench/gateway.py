"""The serving gateway at full width: ``traces/gateway_burst.json`` replayed
open-loop through :class:`~repro_torch.serve.gateway.Gateway` on the card.

The configuration is ``benchmarks/gateway.py``'s headline run (``fair``,
preemptive, the trace's shares, ``LMAdapter(batch=20, max_seq=32)``,
``SegAdapter(batch=4, max_active=2)``) with the bench's smoke models
replaced by full-width ones:

* the LM is minitron_4b at full width and depth (the model every committed
  trace names), random weights drawn on the device from a seed and
  quantized layer by layer, served on ``impl='kernel'`` under the
  ``from_weights`` schedule of its ``w_up`` weights — at batch 20 every
  int8 linear is one launch of the scaled kernel with M = 20 rows;
* the U-Net is whatever the caller serves (``chip_smoke.py``: the
  calibrated U-Net with a plan tuned on the card).

The trace's arrival stamps and round budget were drawn for the smoke LM's
relation-(2) prices.  At full width one token step costs ``k`` times as
many modeled cycles, so :func:`scaled_trace` multiplies every
``arrival_cycle`` and the round budget by that integer ``k``
(:func:`clock_scale`): the traffic keeps its shape relative to the LM's
step price, and no step outgrows a round.  The cycles are the paper's FPGA
model (relation (2)), not a card number.  Deadlines scale with the stamps.

Used by ``chip_smoke.py`` (phase 8; phase 10 serves ``traces/diurnal_smoke.json``
through :func:`fabric`, a fleet of these gateways) and
``scripts/profile_port_serving.py --gateway`` / ``--fabric``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cycle_model as cm

LM_BATCH, LM_MAX_SEQ = 20, 32  # benchmarks/gateway.py's LM slots
SEG_BATCH, SEG_MAX_ACTIVE = 4, 2  # and its seg engine
SMOKE_LM = "minitron_4b"  # traces/*.json meta: "minitron_4b smoke"


def lm_step_cycles(cfg, schedule=None) -> int:
    """Relation-(2) cycles of one LM token step, priced as ``LMAdapter``
    prices it (true GQA widths, attention against an ``LM_MAX_SEQ`` cache)."""
    return cm.lm_step_cycles(
        cfg.d_model, cfg.d_ff, cfg.n_layers, schedule, n_heads=cfg.n_heads,
        head_dim=cfg.hd, n_kv_heads=cfg.n_kv_heads, context=LM_MAX_SEQ,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
    )


def clock_scale(cfg) -> int:
    """``k``: the served LM's token-step price (under its own schedule)
    over the smoke LM's at 8 planes (the prices the trace was drawn for),
    rounded."""
    from repro_torch.configs import get_smoke_config

    served = lm_step_cycles(cfg, cfg.quant.plane_schedule)
    return round(served / lm_step_cycles(get_smoke_config(SMOKE_LM)))


def scaled_trace(trace, k: int):
    """``trace`` with every arrival stamp, every set deadline and its round
    budget times ``k`` (payloads, seeds and order unchanged, so the same
    requests arrive, each with its deadline at the same place relative to
    the LM's step price)."""
    from repro_torch.workload import Trace

    if k < 1:
        raise ValueError(f"clock scale {k} < 1")
    meta = dict(trace.meta, round_budget=int(trace.meta["round_budget"]) * k)

    def scale(r):
        dc = None if r.deadline_cycles is None else r.deadline_cycles * k
        return dataclasses.replace(r, arrival_cycle=r.arrival_cycle * k,
                                   deadline_cycles=dc)

    return Trace(
        name=f"{trace.name}_clock_x{k}", seed=trace.seed,
        requests=tuple(scale(r) for r in trace.requests),
        description=trace.description, meta=meta, version=trace.version,
    )


def minitron(*, device=None):
    """Full-width minitron_4b on ``device`` (the card unless ``'cpu'``),
    random weights from seed 0: the serving config (int8 datapath,
    ``impl='kernel'``, the ``from_weights(0.05)`` schedule of the ``w_up``
    weights), its params and the schedule."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.plane_schedule import PlaneSchedule
    from repro_torch.models import transformer

    cfg = get_config("minitron_4b")
    params = transformer.init_params(0, cfg, device=device, int8_min_dim=256)
    up = params["blocks"]["mlp"]["w_up"]["w_q"]
    sched = PlaneSchedule.from_weights([up[l] for l in range(cfg.n_layers)], 0.05)
    kcfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel",
                                         plane_schedule=sched.planes))
    return kcfg, params, sched


def build(lm_cfg, lm_params, seg_cfg, seg_params, plan, trace, *, device=None, sink=None):
    """The gateway and its materializers for ``trace`` (the scaled one):
    ``(gateway, materializers)``."""
    from repro_torch.serve import Gateway, LMAdapter, SegAdapter
    from repro_torch.workload import lm_materializer, seg_materializer

    gw = Gateway(
        [LMAdapter(lm_cfg, lm_params, batch=LM_BATCH, max_seq=LM_MAX_SEQ, device=device),
         SegAdapter(seg_cfg, seg_params, plan=plan, batch=SEG_BATCH,
                    max_active=SEG_MAX_ACTIVE, device=device)],
        policy="fair", round_budget=int(trace.meta["round_budget"]),
        shares=dict(trace.meta["shares"]), sink=sink,
    )
    mats = {"lm": lm_materializer(lm_cfg.vocab), "seg": seg_materializer(seg_cfg.in_ch)}
    return gw, mats


FABRIC_SHARDS, FABRIC_ROUTER, FABRIC_SEED = 2, "deficit", 0  # the card's fabric, stealing on


def fabric(lm_cfg, lm_params, seg_cfg, seg_params, plan, trace, *, device=None, sink=None):
    """A :class:`~repro_torch.serve.fabric.Fabric` of ``FABRIC_SHARDS``
    gateways, each :func:`build`'s headline gateway over the same LM and
    U-Net parameters (the tensors are shared, never copied), behind the
    ``FABRIC_ROUTER`` router with work stealing, and the materializers for
    ``trace`` (the scaled one): ``(fabric, materializers)``.  ``sink`` is
    armed fleet-wide, shard-tagged."""
    from repro_torch.serve import Fabric

    shards, mats = [], None
    for _ in range(FABRIC_SHARDS):
        gw, mats = build(lm_cfg, lm_params, seg_cfg, seg_params, plan, trace, device=device)
        shards.append(gw)
    return Fabric(shards, router=FABRIC_ROUTER, seed=FABRIC_SEED, steal=True, sink=sink), mats
