"""The port's tiled segmentation serving against the JAX reference engine:
same weights, same images, same engine settings.

The accounting (cycles, ops, pJ, tile and class counts) and the tile
emission order are pure Python on both sides and must be equal.  Logits
agree within ``LOGIT_ATOL``: the quantized convs are integer-exact with
bitwise-equal scales, and only float sums (the 1x1 head; every conv in float
mode) run in another order.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import unet as junet
from repro.obs.events import RecordingSink as JSink
from repro.segserve import SegEngine as JEngine
from repro.segserve import adaptive as jadaptive
from repro.segserve import tiling as jtiling
from repro_torch.models import unet
from repro_torch.obs import timeline
from repro_torch.obs.events import RecordingSink
from repro_torch.segserve import SegEngine, adaptive, tiling
from repro_torch.segserve.synth import phantom_image

LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def net():
    jcfg = junet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8", impl="xla")
    jparams = junet.init_params(jax.random.PRNGKey(1), jcfg)
    sched = junet.schedule_from_params(jparams, 0.05).planes
    jcfg = dataclasses.replace(jcfg, plane_schedule=sched)
    tparams = unet.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tcfg = unet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8",
                           plane_schedule=sched)
    return jcfg, jparams, tcfg, tparams


# Window shapes repeat across these images (28 and 40 px at tile 16), which
# keeps the reference engine's compile count, and so the test time, small.
IMAGES = [phantom_image(48, 48, 3, seed=0), phantom_image(32, 48, 3, seed=1),
          phantom_image(31, 27, 3, seed=2)]


def _event_key(e):
    return (e.rid, e.tile, e.klass, e.cycles, e.core, e.done, e.pj)


def _serve_both(net, images, *, quant_mode="mma_int8", pad_mode="zero", **kw):
    jcfg, jparams, tcfg, tparams = net
    jeng = JEngine(dataclasses.replace(jcfg, quant_mode=quant_mode, pad_mode=pad_mode),
                   jparams, **kw)
    teng = SegEngine(dataclasses.replace(tcfg, quant_mode=quant_mode, pad_mode=pad_mode),
                     tparams, device="cpu", **kw)
    jeng.obs, teng.obs = JSink(), RecordingSink()
    jev, tev = list(jeng.serve_stream(images)), list(teng.serve_stream(images))
    assert [_event_key(e) for e in tev] == [_event_key(e) for e in jev]
    assert teng.obs.canonical_bytes() == jeng.obs.canonical_bytes()
    jres = [e.request.result for e in jev if e.done]
    tres = [e.request.result for e in tev if e.done]
    assert len(tres) == len(images)
    for a, b in zip(jres, tres):
        assert (b.cycles, b.ops, b.pj, b.n_tiles, b.class_counts) == \
            (a.cycles, a.ops, a.pj, a.n_tiles, a.class_counts)
        assert (b.time_ms, b.gops_per_w, b.metered_gops_per_w) == \
            (a.time_ms, a.gops_per_w, a.metered_gops_per_w)
        np.testing.assert_allclose(b.logits, a.logits, atol=LOGIT_ATOL)
    return jres, tres


def test_tiling_and_classes_equal_reference():
    for depth, cps in [(1, 1), (2, 1), (3, 1), (2, 2)]:
        assert tiling.halo_for(depth, cps) == jtiling.halo_for(depth, cps)
    for h, w, halo in [(48, 48, None), (33, 20, None), (40, 36, 0)]:
        plan = tiling.plan_tiles(h, w, depth=2, tile=16, halo=halo)
        jplan = jtiling.plan_tiles(h, w, depth=2, tile=16, halo=halo)
        assert [dataclasses.astuple(t) for t in plan.tiles] == \
            [dataclasses.astuple(t) for t in jplan.tiles]
        canvas = tiling.pad_canvas(phantom_image(h, w, 3), plan)
        assert adaptive.classify_tiles(canvas, plan) == jadaptive.classify_tiles(canvas, jplan)
    for r in (1.0, 0.6, 0.26, 0.01, 0.0):
        assert adaptive.budget_class(r) == jadaptive.budget_class(r)


def test_engine_quantized_adaptive_equals_reference(net):
    _, tres = _serve_both(net, IMAGES, tile=16)
    assert any(len(r.class_counts) > 1 for r in tres)  # adaptivity exercised


def test_engine_float_equals_reference(net):
    _serve_both(net, IMAGES[1:], quant_mode="none", tile=16)


def test_engine_fifo_order_small_slot_table(net):
    _serve_both(net, IMAGES[:2], tile=16, max_active=1, priority=False)


def test_engine_zero_halo_edge_mode_equals_reference_outputs(net):
    """The cheap halo-free mode, held to the reference engine's outputs."""
    yy, xx = np.mgrid[0:48, 0:48].astype(np.float32) / 48.0
    image = np.stack([1.0 + yy, 1.0 + xx, 1.5 + yy * xx], axis=-1)
    for quant_mode in ("none", "mma_int8"):
        _serve_both(net, [image], quant_mode=quant_mode, pad_mode="edge", tile=8, halo=0)


def test_run_equals_serve_stream_and_tiled_forward(net):
    _, _, tcfg, tparams = net
    ran = SegEngine(tcfg, tparams, tile=16, device="cpu").run(IMAGES[:2])
    done = [e.request for e in
            SegEngine(tcfg, tparams, tile=16, device="cpu").serve_stream(IMAGES[:2]) if e.done]
    streamed = [r.result for r in sorted(done, key=lambda r: r.rid)]
    for a, b in zip(ran, streamed):
        np.testing.assert_array_equal(a.logits, b.logits)
    fcfg = dataclasses.replace(tcfg, quant_mode="none")
    whole, _ = tiling.tiled_forward(tparams, IMAGES[1], fcfg, tile=16, device="cpu")
    served = SegEngine(fcfg, tparams, tile=16, device="cpu").run([IMAGES[1]])[0]
    np.testing.assert_allclose(served.logits, whole, atol=LOGIT_ATOL)


def test_engine_validates_inputs(net):
    _, _, tcfg, tparams = net
    for kw in (dict(tile=6), dict(tile=8, halo=-4), dict(tile=8, batch=0)):
        with pytest.raises(ValueError):
            SegEngine(tcfg, tparams, device="cpu", **kw)
    eng = SegEngine(tcfg, tparams, tile=8, device="cpu")
    for bad in (np.zeros((8, 8, 4), np.float32), np.zeros((8, 8), np.float32),
                np.zeros((0, 8, 3), np.float32)):
        with pytest.raises(ValueError):
            eng.submit(bad)
    assert eng.next_cost() == 0 and eng.step() == [] and not eng.has_work()


def test_engine_without_device_raises_without_a_card(net):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, tcfg, tparams = net
    with pytest.raises(RuntimeError, match="CUDA card"):
        SegEngine(tcfg, tparams)


def test_engine_passes_its_graph_cache_to_the_forward(net):
    """The engine holds a graph cache on the card only and hands it to
    ``unet.forward``; given one on the CPU, every micro-batch still runs
    eagerly (counted, never replayed) with the same logits."""
    _, _, tcfg, tparams = net
    assert SegEngine(tcfg, tparams, tile=16, device="cpu").graphs is None
    want = SegEngine(tcfg, tparams, tile=16, device="cpu").run(IMAGES[:2])
    eng = SegEngine(tcfg, tparams, tile=16, device="cpu")
    eng.graphs = unet.ForwardGraphs()
    eng.obs = RecordingSink(["seg-batch"])
    with timeline.recording() as rec:
        got = eng.run(IMAGES[:2])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.logits, b.logits)
    graph_counts = {k: v for k, v in rec.counts.items() if k.startswith("unet.graph")}
    assert graph_counts == {"unet.graph_forwards": len(eng.obs)} and len(eng.obs) > 0
    assert len(eng.graphs) == 0


def test_classes_with_equal_schedules_share_a_graph_signature(net):
    """The signature is the class's refined schedule, not the class: the
    engine's classes give as many signatures as distinct schedules, and
    here some classes coincide."""
    _, _, tcfg, tparams = net
    eng = SegEngine(tcfg, tparams, tile=16, device="cpu")
    classes = range(adaptive.MAX_CLASS + 1)
    keys = {unet.ForwardGraphs.key((4, 40, 40, 3), eng.class_cfg(k), False) for k in classes}
    schedules = {eng.class_cfg(k).schedule().planes for k in classes}
    assert len(keys) == len(schedules) < len(classes)
