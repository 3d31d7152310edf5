"""Tiled-segmentation serving engine: request queue + slot table +
shape/class-grouped micro-batching, with per-image energy accounting.

Requests (arbitrary-size images) wait in a FIFO, a bounded slot table caps
in-flight stitching canvases, and the unit of batched work is a micro-batch
of tiles.  Tiles are grouped by

    (input window shape, budget class, image amplitude octave, group)

and packed into fixed-size batches (padded with zero tiles).  Every tile of
a batch runs one static per-layer plane schedule, so each conv launches one
specialization of the MMA kernel (``kernels.mma_matmul.plane_variant``).
Without a tuned plan, activations are quantized with one scale over the
whole micro-batch, zero tiles included, exactly as the reference engine
does.  Under a plan each tile gets its own scale (still one kernel launch
per conv per micro-batch), so a tile's numerics do not depend on its batch
mates and the plan's per-tile certificate carries over to batched serving.

Accounting per image: relation-(2) cycles of every tile the image consumed
(halo overhead included) under its refined schedule, against the useful
whole-canvas ops, and the same work in integer picojoules.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import cycle_model as cm
from repro_torch.core import energy_model as em
from repro_torch.core.plane_schedule import PlaneSchedule
from repro_torch.device import resolve_device
from repro_torch.models import unet
from repro_torch.obs import timeline
from repro_torch.obs.events import NULL_SINK, Event
from repro_torch.serve.queue import FifoQueue, SlotTable

from . import adaptive, tiling

_IMPLIED_POWER_W = (
    cm.PAPER_TABLE1["proposed"]["gops"] / cm.PAPER_TABLE1["proposed"]["gops_w"]
)


@dataclass
class SegResult:
    """One served image: stitched logits + the modeled energy account."""

    logits: np.ndarray  # (H, W, n_classes) f32
    cycles: int
    ops: int
    n_tiles: int
    class_counts: dict[int, int]  # budget class -> tile count
    pj: int = 0  # metered active energy: tile cycles at their plane rates

    @property
    def time_ms(self) -> float:
        return self.cycles / cm.FREQ_HZ * 1e3

    @property
    def gops(self) -> float:
        return self.ops / (self.time_ms * 1e-3) / 1e9

    @property
    def gops_per_w(self) -> float:
        return self.gops / _IMPLIED_POWER_W

    @property
    def energy_mj(self) -> float:
        return _IMPLIED_POWER_W * self.time_ms

    @property
    def metered_mj(self) -> float:
        return em.pj_to_mj(self.pj)

    @property
    def metered_gops_per_w(self) -> float | None:
        return em.metered_gops_per_w(self.ops, self.pj)


@dataclass(frozen=True)
class TileEvent:
    """One emitted tile: the progressive-display unit of the streaming API.

    Under priority scheduling an image's structure-class tiles (low
    ``klass``) are emitted before its background tiles.  ``cycles`` is the
    tile's relation-(2) price at its class schedule, ``pj`` the same work in
    integer picojoules.
    """

    rid: int
    tile: int  # index into request.plan.tiles
    klass: int  # budget class (0 = structure / full amplitude)
    cycles: int
    core: tuple[int, int, int, int]  # (y0, x0, y1, x1) canvas coords
    done: bool  # this emission completed the request
    request: "SegRequest"
    pj: int = 0


@dataclass
class SegRequest:
    rid: int
    image: np.ndarray  # (H, W, C)
    # scheduling label: tiles of different groups never share a micro-batch
    group: str | None = None
    # filled at admission
    plan: tiling.TilePlan | None = None
    slot: int = -1
    canvas_in: np.ndarray | None = None
    canvas_out: np.ndarray | None = None
    remaining: int = 0
    cycles: int = 0
    pj: int = 0
    ops: int = 0
    class_counts: dict[int, int] = field(default_factory=dict)
    emitted: list[int] = field(default_factory=list)  # tile emission order
    batches: int = 0  # micro-batches that carried at least one of its tiles
    result: SegResult | None = None

    @property
    def done(self) -> bool:
        return self.result is not None

    def partial(self) -> np.ndarray:
        """The progressive stitch so far (unemitted cores are zero)."""
        if self.result is not None:
            return self.result.logits
        if self.canvas_out is None:
            raise ValueError(f"request {self.rid} not yet admitted")
        return self.canvas_out[: self.plan.h, : self.plan.w].copy()


class SegEngine:
    """Micro-batching executor for U-Net segmentation requests.

    Args:
      cfg: the :class:`~repro_torch.models.unet.UNetConfig` to serve (its
        ``plane_schedule`` / ``planes`` is the certified layer-level
        policy; ``quant_mode='none'`` serves the float datapath).
      params: U-Net params for ``cfg`` (moved to ``device``).
      tile: core stride (multiple of ``2**depth``).
      halo: exact by default (:func:`~repro_torch.segserve.tiling.halo_for`);
        0 + ``cfg.pad_mode='edge'`` is the cheap seam-tolerant mode.
      batch: fixed tile micro-batch size (short groups are zero-padded).
      max_active: slot-table capacity — concurrent stitching canvases.
      adaptive: refine the layer schedule per budget class (quantized
        datapath only).
      max_class: amplitude-octave cap for flat/empty tiles.
      plan: a :class:`~repro_torch.autotune.plan.TunedPlan` — overrides
        ``tile`` and ``halo`` with the tuned geometry (validated through
        ``cfg.validate_tile``), classifies tiles by the *calibrated*
        thresholds instead of fixed octaves, runs each class at the plan's
        measured-ratio refined schedule, and switches the quantized
        datapath to per-tile activation scales so the plan's certificate
        transfers to the batched path exactly.
      priority: pick the pending group with the lowest budget class first
        (structure before background); scheduling order only.
      device: where the forward runs — the CUDA card unless ``'cpu'``.  On
        the card the engine owns a :class:`~repro_torch.models.unet.ForwardGraphs`
        (``self.graphs``), so each micro-batch signature's forward is
        captured once and then replayed as one CUDA graph.
    """

    def __init__(
        self,
        cfg: unet.UNetConfig,
        params,
        *,
        tile: int = 32,
        halo: int | None = None,
        batch: int = 4,
        max_active: int = 4,
        adaptive: bool = True,
        max_class: int = adaptive.MAX_CLASS,
        plan=None,
        priority: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        if plan is not None:
            if getattr(plan, "workload", "unet") != "unet":
                raise ValueError(
                    f"cannot serve a {plan.workload!r} plan through the "
                    f"segmentation engine"
                )
            if len(plan.planes) != len(cfg.conv_layers()):
                raise ValueError(
                    f"plan covers {len(plan.planes)} convs but this "
                    f"geometry has {len(cfg.conv_layers())}"
                )
            # the halo walk's geometry guard, through UNetConfig validation
            tile = cfg.validate_tile(int(plan.tile), halo=int(plan.halo))
            halo = int(plan.halo)
        mult = 2**cfg.depth
        if tile < mult or tile % mult:
            raise ValueError(
                f"tile {tile} must be a positive multiple of 2**depth = {mult}"
            )
        if halo is not None and halo < 0:
            raise ValueError(f"halo {halo} < 0")
        if batch < 1:
            raise ValueError(f"batch {batch} < 1")
        self.cfg = cfg
        self.plan = plan
        self.params = unet.params_to(params, self.device)
        self.graphs = unet.ForwardGraphs() if self.device.type == "cuda" else None
        self.tile = tile
        self.halo = halo
        self.batch = batch
        self.priority = priority
        quantized = cfg.quant_mode == "mma_int8"
        self.adaptive = adaptive and quantized and (
            plan is None or plan.class_thresholds is not None
        )
        self.max_class = max_class
        # per-tile activation scales exactly when a plan drives the int8 path
        self.per_tile_quant = plan is not None and quantized
        if plan is not None and quantized:
            self.base_schedule = plan.schedule()
        elif quantized:
            self.base_schedule = cfg.schedule()
        else:
            self.base_schedule = PlaneSchedule.uniform(8, len(cfg.conv_layers()))
        self.queue: FifoQueue[SegRequest] = FifoQueue()
        self.slots: SlotTable[SegRequest] = SlotTable(max_active)
        # (in_h, in_w, class, amax_octave, group) -> [(request, tile_index), ...]
        self._tasks: dict[tuple, list] = {}
        self._cfg_for_class: dict[int, unet.UNetConfig] = {}
        self._pj_cache: dict[tuple[int, int, int], int] = {}
        self._next_rid = 0
        # telemetry: engine-local micro-batch records, sequence-stamped
        self.obs = NULL_SINK
        self._obs_seq = 0

    # ----------------------------------------------------------- schedules

    def _class_planes(self, k: int) -> tuple[int, ...]:
        """Per-layer budgets class-``k`` micro-batches run: the plan's
        calibrated table, else the octave-heuristic refinement."""
        if self.plan is not None:
            return tuple(self.plan.class_schedule(k))
        return adaptive.class_schedule(self.base_schedule, k).planes

    def class_cfg(self, k: int) -> unet.UNetConfig:
        """The static config class-``k`` batches run."""
        if k not in self._cfg_for_class:
            cfg = self.cfg
            if cfg.quant_mode == "mma_int8":
                cfg = dataclasses.replace(cfg, plane_schedule=self._class_planes(k))
            self._cfg_for_class[k] = cfg
        return self._cfg_for_class[k]

    def _tile_cycles(self, in_h: int, in_w: int, k: int) -> int:
        """Relation-(2) cycles of one (in_h, in_w) tile at class ``k``."""
        return cm.unet_window_cycles(
            (in_h, in_w), self.cfg.in_ch, self.cfg.base, self.cfg.depth,
            self.cfg.convs_per_stage, self._class_planes(k),
        )

    def _tile_pj(self, in_h: int, in_w: int, k: int) -> int:
        """Metered active energy of one (in_h, in_w) tile at class ``k``
        (integer pJ, memoized per signature)."""
        key = (in_h, in_w, k)
        pj = self._pj_cache.get(key)
        if pj is None:
            layers = cm.unet_conv_layers(
                (in_h, in_w), self.cfg.in_ch, self.cfg.base, self.cfg.depth,
                self.cfg.convs_per_stage,
            )
            pj = em.schedule_pj(layers, self._class_planes(k))
            self._pj_cache[key] = pj
        return pj

    # ------------------------------------------------------------ admission

    def submit(self, image: np.ndarray, *, group: str | None = None) -> SegRequest:
        """Enqueue one (H, W, C) image; returns its request handle."""
        image = np.asarray(image)
        if (image.ndim != 3 or image.shape[-1] != self.cfg.in_ch
                or image.shape[0] < 1 or image.shape[1] < 1):
            raise ValueError(
                f"expected (H, W, {self.cfg.in_ch}) image with H, W >= 1, "
                f"got {image.shape}"
            )
        req = SegRequest(rid=self._next_rid, image=image, group=group)
        self._next_rid += 1
        self.queue.push(req)
        return req

    def _admit(self, req: SegRequest) -> bool:
        with timeline.span("segserve.admit", rid=req.rid):
            # Plan before occupying: a planning error must not leak the slot.
            req.plan = tiling.plan_tiles(
                req.image.shape[0], req.image.shape[1], depth=self.cfg.depth,
                convs_per_stage=self.cfg.convs_per_stage, tile=self.tile,
                halo=self.halo,
            )
            slot = self.slots.occupy(req)
            if slot is None:
                return False
            req.slot = slot
            canvas = tiling.pad_canvas(req.image.astype(np.float32), req.plan)
            req.canvas_in = canvas
            req.canvas_out = np.zeros(
                (req.plan.pad_h, req.plan.pad_w, self.cfg.n_classes), np.float32
            )
            req.remaining = req.plan.n_tiles
            req.ops = cm.model_ops(
                cm.unet_conv_layers(
                    (req.plan.pad_h, req.plan.pad_w), self.cfg.in_ch,
                    self.cfg.base, self.cfg.depth, self.cfg.convs_per_stage,
                )
            )
            amax = float(np.max(np.abs(canvas)))
            if self.adaptive:
                classes = adaptive.classify_tiles(
                    canvas, req.plan, max_class=self.max_class, amax=amax,
                    thresholds=(
                        None if self.plan is None else self.plan.class_thresholds
                    ),
                )
            else:
                classes = [0] * req.plan.n_tiles
            # The octave key keeps batch-shared dynamic scales compatible; under
            # a plan every tile has its own scale, so it would only fragment
            # the packing — collapse it.
            if self.plan is not None:
                octave = 0
            else:
                octave = int(math.floor(math.log2(amax))) if amax > 0 else 0
            for ti, (spec, k) in enumerate(zip(req.plan.tiles, classes)):
                key = (spec.in_h, spec.in_w, k, octave, req.group)
                self._tasks.setdefault(key, []).append((req, ti))
                req.class_counts[k] = req.class_counts.get(k, 0) + 1
            return True

    # ------------------------------------------------------------- stepping

    def has_work(self, group: str | None = ...) -> bool:
        """Admitted tiles are waiting to run (``group=...`` means any)."""
        if group is ...:
            return bool(self._tasks)
        return any(key[4] == group for key in self._tasks)

    def pending(self, group: str | None = ...) -> int:
        """How many admitted tiles are waiting to run."""
        return sum(
            len(g) for key, g in self._tasks.items()
            if group is ... or key[4] == group
        )

    def _next_key(self, group=...):
        keys = (
            list(self._tasks) if group is ...
            else [k for k in self._tasks if k[4] == group]
        )
        if not keys:
            return None
        if self.priority:
            return min(keys, key=lambda g: g[2])
        return keys[0]

    def next_cost(self, group: str | None = ...) -> int:
        """Relation-(2) price of the micro-batch :meth:`step` would run
        next (0 when idle)."""
        key = self._next_key(group)
        if key is None:
            return 0
        n = min(len(self._tasks[key]), self.batch)
        return n * self._tile_cycles(key[0], key[1], key[2])

    def step(self, group: str | None = ...) -> list[TileEvent]:
        """Run one micro-batch and return its tile emissions (empty when
        idle).  Group choice is the prioritization point: lowest budget
        class first (FIFO among equals) under ``priority=True``, admission
        order otherwise; group membership and packing are fixed at
        admission."""
        with timeline.span("segserve.step"):
            key = self._next_key(group)
            if key is None:
                return []
            task_group = self._tasks[key]
            taken, self._tasks[key] = task_group[: self.batch], task_group[self.batch :]
            if not self._tasks[key]:
                del self._tasks[key]
            in_h, in_w, k = key[0], key[1], key[2]
            with timeline.span("segserve.pack"):
                x = np.zeros((self.batch, in_h, in_w, self.cfg.in_ch), np.float32)
                for b, (req, ti) in enumerate(taken):
                    spec = req.plan.tiles[ti]
                    x[b] = req.canvas_in[spec.y0 : spec.y1, spec.x0 : spec.x1]
            out = unet.forward(self.params, x, self.class_cfg(k),
                               per_sample_scale=self.per_tile_quant, device=self.device,
                               graphs=self.graphs)
            with timeline.span("segserve.fetch"):
                out = out.cpu().numpy()  # on the card, a graph's output: copy it now
            with timeline.span("segserve.stitch"):
                return self._stitch(taken, out, in_h, in_w, k)

    def _stitch(self, taken: list, out: np.ndarray, in_h: int, in_w: int,
                k: int) -> list[TileEvent]:
        """Write a micro-batch's cores into their canvases, account them,
        finish the requests it completes and emit their tile events."""
        for req in {id(r): r for r, _ in taken}.values():
            req.batches += 1
        events: list[TileEvent] = []
        cyc = self._tile_cycles(in_h, in_w, k)  # one price, both accounts
        pj = self._tile_pj(in_h, in_w, k)
        for b, (req, ti) in enumerate(taken):
            spec = req.plan.tiles[ti]
            cy, cx = spec.crop
            req.canvas_out[
                spec.core_y0 : spec.core_y1, spec.core_x0 : spec.core_x1
            ] = out[b][cy, cx]
            req.cycles += cyc
            req.pj += pj
            req.remaining -= 1
            req.emitted.append(ti)
            if req.remaining == 0:
                self._finish(req)
            events.append(
                TileEvent(
                    rid=req.rid, tile=ti, klass=k, cycles=cyc,
                    core=(spec.core_y0, spec.core_x0, spec.core_y1, spec.core_x1),
                    done=req.done, request=req, pj=pj,
                )
            )
        if self.obs.enabled:
            self._obs_seq += 1
            self.obs.emit(Event(self._obs_seq, "seg-batch", dict(
                klass=int(k), tiles=len(taken), cycles=int(cyc * len(taken)),
                pj=int(pj * len(taken)),
            )))
        return events

    def _finish(self, req: SegRequest) -> None:
        req.result = SegResult(
            logits=req.canvas_out[: req.plan.h, : req.plan.w].copy(),
            cycles=req.cycles,
            ops=req.ops,
            n_tiles=req.plan.n_tiles,
            class_counts=dict(sorted(req.class_counts.items())),
            pj=req.pj,
        )
        self.slots.release(req.slot)
        req.canvas_in = None
        req.canvas_out = None
        timeline.count("segserve.requests")
        timeline.count("segserve.request_batches", req.batches)

    # ------------------------------------------------------------ the loop

    def run(self, images: list[np.ndarray]) -> list[SegResult]:
        """Serve a batch of images to completion, in submission order."""
        reqs = [self.submit(im) for im in images]
        self.flush()
        return [r.result for r in reqs]

    def flush(self) -> None:
        """Drain the queue and every in-flight request."""
        for _ in self.serve_stream([]):
            pass

    def serve_stream(self, images: list[np.ndarray]):
        """Progressive serving: yield :class:`TileEvent` s as tiles finish.
        Equivalent to :meth:`run` in final outputs."""
        for im in images:
            self.submit(im)
        while self.queue or self.slots.any_active() or self._tasks:
            self.queue.pump(self.slots, self._admit)
            events = self.step()
            if not events and not self.queue:
                break
            yield from events
