"""The port's wall-clock recorder (``repro_torch.obs.timeline``) on the CPU:
off by default at the cost of two flag reads, on under ``torch.profiler``
and inside ``timeline.recording()``, its spans nested where the program
does the work (the serving loop, the U-Net forward, the training step), each
one a range of the profiler's own trace on the same clock, and nothing the
program computes changed by it."""
import dataclasses
import statistics

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.kernels import mma_matmul as mk
from repro_torch.models import transformer, unet
from repro_torch.obs import timeline
from repro_torch.obs.events import RecordingSink
from repro_torch.optim import adamw
from repro_torch.segserve import SegEngine
from repro_torch.segserve.synth import phantom_image
from repro_torch.train import train_step as ts

CPU = [torch.profiler.ProfilerActivity.CPU]
SEG_SPANS = ("segserve.step", "segserve.pack", "segserve.fetch", "segserve.stitch",
             "unet.forward")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seg():
    base = unet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8")
    params = unet.init_params(3, base, device="cpu")
    cfg = dataclasses.replace(base, plane_schedule=unet.schedule_from_params(params, 0.05).planes)
    images = [phantom_image(48, 48, 3, seed=0), phantom_image(32, 48, 3, seed=1),
              phantom_image(31, 27, 3, seed=2)]
    return cfg, params, images


def serve(seg):
    """Serve the three images; the engine's logits by rid and its
    ``seg-batch`` events."""
    cfg, params, images = seg
    eng = SegEngine(cfg, params, tile=16, batch=2, max_active=2, device="cpu")
    eng.obs = RecordingSink(["seg-batch"])
    results = {e.rid: e.request.result.logits for e in eng.serve_stream(images) if e.done}
    assert len(results) == len(images)
    return results, list(eng.obs.events)


def lm_cfg():
    return get_smoke_config("yi_6b").replace(
        microbatches=2, remat="full", quant=QuantConfig(mode="mma_int8", impl="kernel"))


def train(cfg):
    """One step of the smoke LM at 2 microbatches: loss, gradients' first
    moments and the new master weights."""
    params = transformer.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 2, 17), dtype=np.int32)}
    new, m = ts.train_step({"params": params, "opt": adamw.init(params)}, batch, cfg,
                           device="cpu")
    return [m["loss"], *tree_leaves(new["opt"].m), *tree_leaves(new["opt"].master)]


def parents_nest(rec):
    """Every span lies inside its parent, which is in the same thread."""
    for s in rec.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)


def names_of(rec, name):
    return [rec.spans[s.parent].name if s.parent is not None else None
            for s in rec.spans if s.name == name]


def test_off_reads_no_clock_and_opens_no_profiler_range(seg, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("traced while off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(timeline, "_now", boom)
    with timeline.recording():
        pass  # an empty recording: what last() returns below unless something records
    before = timeline.last()
    serve(seg)
    train(lm_cfg())
    with timeline.span("x", rid=1):
        timeline.count("y")
    rec = timeline.last()
    assert rec is before and rec.spans == [] and rec.counts == {}


def test_recording_without_the_profiler_opens_no_range(seg, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a profiler range without the profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with timeline.recording() as rec:
        _, batches = serve(seg)
    assert rec is timeline.last()
    assert len(rec.named("segserve.pack")) == len(batches) > 0
    parents_nest(rec)


def test_serving_spans_under_the_profiler(seg):
    cfg, _, images = seg
    launches = mk.launches
    with torch.profiler.profile(activities=CPU) as prof:
        _, batches = serve(seg)
    rec = timeline.last()
    parents_nest(rec)
    admits = rec.named("segserve.admit")
    assert sorted(s.rid for s in admits) == list(range(len(images)))
    assert set(names_of(rec, "segserve.admit")) == {None}
    for name in SEG_SPANS:
        assert len(rec.named(name)) == len(batches) > 1, name
    for name in ("segserve.pack", "segserve.fetch", "segserve.stitch"):
        assert set(names_of(rec, name)) == {"segserve.step"}, name
    assert set(names_of(rec, "unet.forward")) == {"segserve.step"}
    convs = len(cfg.conv_layers())
    assert len(rec.named("unet.conv")) == convs * len(batches)
    assert set(names_of(rec, "unet.conv")) == {"unet.forward"}
    for name in ("quant.acts", "quant.weights", "conv.im2col", "conv.epilogue"):
        assert len(rec.named(name)) == convs * len(batches), name
        assert set(names_of(rec, name)) == {"unet.conv"}, name
    assert set(names_of(rec, "unet.resample")) == set(names_of(rec, "unet.head")) == {
        "unet.forward"}
    # on the CPU the kernel's plain version runs: no launch, no launch span
    assert len(rec.named("mma.launch")) == mk.launches - launches
    assert rec.counts == {"segserve.requests": len(images),
                          "segserve.request_batches": rec.counts["segserve.request_batches"]}
    assert len(images) <= rec.counts["segserve.request_batches"] <= len(batches) * 2

    # each span is a range of the profiler's trace, on the profiler's clock:
    # the record holds its range (the record is stamped just outside it; a
    # preemption between the two stamps only widens the record), and the
    # starts agree to well under 1 ms
    ranges: dict = {}
    for ev in prof.profiler.kineto_results.events():
        ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    slack = 100_000  # the profiler converts its own clock to epoch ns
    for name in {s.name for s in rec.spans}:
        theirs = sorted(ranges[name])
        mine = sorted((s.start_ns, s.end_ns) for s in rec.named(name))
        assert len(theirs) == len(mine), name
        for (a, b), (c, d) in zip(theirs, mine):
            assert a - c > -slack and d - b > -slack, (name, a - c, d - b)
        assert statistics.median(a - c for (a, _), (c, _) in zip(theirs, mine)) < 1_000_000, name


def test_request_batches_count_the_micro_batches_of_each_image(seg):
    """The counter against the tile events: per finished image, the
    micro-batches (steps) that emitted one of its tiles."""
    cfg, params, images = seg
    eng = SegEngine(cfg, params, tile=16, batch=2, max_active=2, device="cpu")
    inner, steps = eng.step, []

    def step(*a, **kw):
        events = inner(*a, **kw)
        steps.append({e.rid for e in events})
        return events

    eng.step = step
    with timeline.recording() as rec:
        list(eng.serve_stream(images))
    assert rec.counts["segserve.requests"] == len(images)
    assert rec.counts["segserve.request_batches"] == sum(len(rids) for rids in steps)
    assert rec.counts["segserve.request_batches"] > len(images)


def test_training_spans():
    cfg = lm_cfg()
    with torch.profiler.profile(activities=CPU):
        train(cfg)
    rec = timeline.last()
    parents_nest(rec)
    steps = rec.named("train_step")
    assert len(steps) == 1
    mbs = rec.named("train_step.microbatch")
    assert [s.rid for s in mbs] == [0, 1]
    for name in ("lm.tokens", "train_step.forward", "train_step.backward",
                 "train_step.accumulate"):
        assert len(rec.named(name)) == 2, name
    for mb in mbs:
        i = rec.spans.index(mb)
        inside = {rec.spans[j].name for j in range(len(rec.spans)) if _under(rec, j, i)}
        assert {"lm.tokens", "train_step.forward", "train_step.backward",
                "train_step.accumulate"} <= inside
    assert set(names_of(rec, "lm.tokens")) == {"train_step.forward"}
    assert set(names_of(rec, "adamw.update")) == {"train_step"}


def _under(rec, j, i) -> bool:
    p = rec.spans[j].parent
    while p is not None:
        if p == i:
            return True
        p = rec.spans[p].parent
    return False


def test_tracing_changes_no_result(seg):
    plain_seg, _ = serve(seg)
    plain_lm = train(lm_cfg())
    with torch.profiler.profile(activities=CPU):
        traced_seg, _ = serve(seg)
        traced_lm = train(lm_cfg())
    with timeline.recording():
        recorded_seg, _ = serve(seg)
    assert plain_seg.keys() == traced_seg.keys() == recorded_seg.keys()
    for rid in plain_seg:
        assert np.array_equal(plain_seg[rid], traced_seg[rid])
        assert np.array_equal(plain_seg[rid], recorded_seg[rid])
    assert len(plain_lm) == len(traced_lm)
    for a, b in zip(plain_lm, traced_lm):
        assert torch.equal(a, b)


def test_last_holds_only_the_latest_recording():
    with timeline.recording() as first:
        with timeline.span("a"):
            timeline.count("n", 2)
    assert timeline.last() is first and first.counts == {"n": 2}
    with torch.profiler.profile(activities=CPU):
        with timeline.span("b"):
            pass
    second = timeline.last()
    assert second is not first and [s.name for s in second.spans] == ["b"]
    assert second.counts == {} and timeline.last() is second
    with torch.profiler.profile(activities=CPU):
        with timeline.span("c", rid=7):
            timeline.count("n")
    third = timeline.last()
    assert [(s.name, s.rid) for s in third.spans] == [("c", 7)] and third.counts == {"n": 1}
    with pytest.raises(RuntimeError):
        with timeline.recording():
            with timeline.recording():
                pass
