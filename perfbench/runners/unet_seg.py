"""Runner of the tiled U-Net segmentation service (``repro_torch.segserve``).

Set-up draws the U-Net's weights on the device from the seed, builds the
program's ``SegEngine`` as the configuration states (its plane schedule
worked out by the program from the weights), warms it up on images of the
cell's own mix drawn from a stream the window does not use, and draws the
window's pool of images.

The window is a closed loop: ``clients`` callers each submit one image and
submit their next when its result comes back, through ``SegEngine.submit``
and the engine's own loop (``serve_stream``, which pumps the queue and runs
``SegEngine.step``).  Throughput counts the images whose stitched logits
came back in the window; latency is from each image's submit to its
result, for all of them.

With ``tracing`` the harness records spans around ``SegEngine.step`` and
``models.unet.forward`` (the forward's span ends when its device work has:
the step copies its output to the host right after it), and the engine's
``seg-batch`` counters through a sink on ``engine.obs``.

After the window a sample of the finished images, drawn from the seed, is
compared with the plain reference (``reference/unet_seg.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import unet_seg as ref
from perfbench.roofline import mma_tc_horner_kernel as mma


def draw_params(geom: dict, seed: int, dev: torch.device) -> dict:
    """The U-Net's weights in the program's tree (HWIO), drawn on ``dev`` from
    the seed in two calls: conv weights normal, clipped to [-2, 2] and
    scaled by 1/sqrt(fan-in); biases normal times ``bias_std``."""
    shapes = [(3, 3, ci, co) for *_, ci, co in ref.conv_layers(
        8, 8, geom["in_ch"], geom["base"], geom["depth"], geom["convs_per_stage"])]
    shapes.append((1, 1, geom["base"], geom["n_classes"]))
    g = torch.Generator(device=dev).manual_seed(int(seed) % 2**63)
    n_w = sum(math.prod(s) for s in shapes)
    w_all = torch.randn(n_w, generator=g, device=dev).clamp_(-2.0, 2.0)
    b_all = torch.randn(sum(s[-1] for s in shapes), generator=g, device=dev)
    b_all *= float(geom["bias_std"])
    convs, wo, bo = [], 0, 0
    for s in shapes:
        n = math.prod(s)
        w = w_all[wo:wo + n].reshape(s) / math.sqrt(s[0] * s[1] * s[2])
        convs.append({"w": w, "b": b_all[bo:bo + s[-1]].clone()})
        wo, bo = wo + n, bo + s[-1]
    depth, cps = geom["depth"], geom["convs_per_stage"]
    it = iter(convs)
    return {
        "enc": [[next(it) for _ in range(cps)] for _ in range(depth)],
        "bottleneck": [next(it) for _ in range(cps)],
        "dec": [[next(it) for _ in range(cps)] for _ in range(depth)],
        "head": next(it),
    }


class UNetSeg:
    def __init__(self, config: dict, mix: dict, seed: int, dev: torch.device, spans):
        self.geom, self.serving = config["model"], config["serving"]
        self.limits = config["check"]
        self.mix, self.seed, self.dev, self.spans = mix, int(seed), dev, spans
        self.clients = int(mix["clients"])
        self.images = traffic.ImageStream(mix, seed, traffic.WINDOW)
        self.done: dict[int, np.ndarray] = {}  # image -> served logits, in finishing order

    # ------------------------------------------------------------- set-up

    def setup(self):
        from repro_torch.models import unet
        from repro_torch.segserve import SegEngine

        g = self.geom
        self.params = draw_params(g, self.seed, self.dev)
        base = unet.UNetConfig(
            hw=g["hw"], in_ch=g["in_ch"], base=g["base"], depth=g["depth"],
            convs_per_stage=g["convs_per_stage"], n_classes=g["n_classes"],
            quant_mode=g["quant_mode"], impl=g["impl"], pad_mode=g["pad_mode"])
        sched = unet.schedule_from_params(self.params, self.serving["target_rel_err"])
        self.cfg = dataclasses.replace(base, plane_schedule=sched.planes)
        s = self.serving
        self.engine = SegEngine(
            self.cfg, self.params, tile=s["tile"], halo=None, batch=s["batch"],
            max_active=s["max_active"], adaptive=s["adaptive"], max_class=s["max_class"],
            priority=s["priority"], device=self.dev)
        warm = traffic.ImageStream(self.mix, self.seed, traffic.WARMUP)
        self._closed_loop(warm, float("inf"), limit=int(self.mix["warmup_images"]))
        self.done.clear()
        self.images.draw()

    # ------------------------------------------------------------- window

    def _closed_loop(self, images, seconds: float, limit: int | None = None):
        """Serve ``images`` 0, 1, ... in a closed loop of ``clients`` for
        ``seconds``; returns the latencies of the images done, the loop's
        length and how many were still in flight.  With ``limit`` (the
        warm-up) the clients send ``limit`` images in all and the loop runs
        until every one is done, which leaves the engine empty."""
        eng, submitted, lat = self.engine, {}, []
        for i in range(self.clients):
            submitted[eng.submit(images[i]).rid] = (i, time.perf_counter())
        nxt = self.clients
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for ev in eng.serve_stream([]):
            if ev.done:
                now = time.perf_counter()
                i, t_sub = submitted.pop(ev.rid)
                lat.append(now - t_sub)
                self.done[i] = ev.request.result.logits
                if now >= deadline:
                    break
                if limit is None or nxt < limit:
                    submitted[eng.submit(images[nxt]).rid] = (nxt, time.perf_counter())
                    nxt += 1
            elif time.perf_counter() >= deadline:
                break
        return lat, time.perf_counter() - t0, len(submitted)

    def window(self, seconds: float, tracing: bool) -> dict:
        from repro_torch.kernels import mma_matmul as mk
        from repro_torch.models import unet
        from repro_torch.obs.events import NULL_SINK, RecordingSink

        eng, steps = self.engine, []
        inner_step, inner_fwd = eng.step, unet.forward
        if tracing:
            eng.obs = RecordingSink(["seg-batch"])

            def step(*a, **kw):
                with self.spans.span("seg.step"):
                    evs = inner_step(*a, **kw)
                if evs:
                    steps.append(evs[0].request.plan.tiles[evs[0].tile].in_shape)
                return evs

            def forward(*a, **kw):
                with self.spans.span("seg.forward"):
                    out = inner_fwd(*a, **kw)
                    if out.is_cuda:
                        torch.cuda.synchronize(out.device)
                return out

            eng.step, unet.forward = step, forward
        mk.launches = 0
        try:
            lat, elapsed, in_flight = self._closed_loop(self.images, seconds)
        finally:
            if tracing:
                del eng.step
                unet.forward = inner_fwd
                batches = list(eng.obs.events)
                eng.obs = NULL_SINK
        n = len(lat)
        metrics = {"seg_images_per_s": n / elapsed}
        if n:
            metrics["seg_latency_p95_ms"] = float(np.percentile(np.array(lat) * 1e3, 95))
        counters = {}
        if tracing:
            g, b = self.geom, self.serving["batch"]
            launches = [(b * h * w, 9 * ci, co) for ih, iw in steps for h, w, ci, co in
                        ref.conv_layers(ih, iw, g["in_ch"], g["base"], g["depth"],
                                        g["convs_per_stage"])]
            m, useful = 2 ** g["depth"], 0
            for logits in self.done.values():
                h, w = logits.shape[:2]
                useful += ref.useful_ops(-(-h // m) * m, -(-w // m) * m, g["in_ch"], g["base"],
                                         g["depth"], g["convs_per_stage"])
            counters = {
                "batch": b, "steps": len(steps),
                "tiles": sum(e.data["tiles"] for e in batches), "seg_batches": len(batches),
                "mma_launches": launches, "mma_launch_count": mk.launches,
                "mma_least_s": sum(mma.least_seconds_of(*s) for s in launches),
                "useful_ops": useful, "window_s": elapsed,
            }
        return {"metrics": metrics, "window_s": elapsed, "attempted": n + in_flight,
                "failed": 0, "counters": counters}

    # ------------------------------------------------------------- checks

    def release(self):
        del self.engine  # the reference reads the benchmark's own weights, self.params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        """The finished images compared: ``checked_images`` of them drawn
        from the seed, and the one with the most pixels."""
        done = sorted(self.done)
        if not done:
            return []
        rng = traffic.rng_for(self.seed, 2, 0)
        k = min(len(done), int(self.mix["checked_images"]))
        pick = {done[j] for j in rng.choice(len(done), size=k, replace=False)}
        pick.add(max(done, key=lambda i: self.done[i].shape[0] * self.done[i].shape[1]))
        return sorted(pick)

    def gaps(self, want: list[int], **fault) -> dict[int, float]:
        """Per image: the widest gap of its logits from the reference's, over
        the reference's largest logit.  Without ``fault`` the logits are the
        served ones; with it, the reference's own under that fault put in
        the program's place (``qmax=7``: the int4 control; ``per_row`` or
        ``shift``: see ``reference.unet_seg.served_logits``)."""
        args = (self.params, self.images, self.clients, self.serving, self.geom, set(want))
        reference = ref.served_logits(*args)
        served = ref.served_logits(*args, **fault) if fault else {i: self.done[i] for i in want}
        return {i: float(np.max(np.abs(served[i] - reference[i]))
                         / max(float(np.max(np.abs(reference[i]))), 1e-30)) for i in want}

    def readings(self) -> dict:
        """The program's number and the control's and faults' (calibrate.py)."""
        want = self.sample()
        return {"images": len(want), "program": max(self.gaps(want).values()),
                "control_int4": max(self.gaps(want, qmax=7).values()),
                "fault_no_batch_mates": max(self.gaps(want, per_row=True).values()),
                "fault_one_class_lower": max(self.gaps(want, shift=1).values())}

    def check(self) -> list[dict]:
        want = self.sample()
        if not want:
            return [{"name": "images_checked", "value": 0, "limit": -1}]
        gap = max(self.gaps(want).values())
        return [{"name": "logit_gap", "value": gap, "limit": self.limits["logit_gap"]}]


def make(config, mix, seed, dev, spans):
    return UNetSeg(config, mix, seed, dev, spans)
