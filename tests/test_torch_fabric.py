"""The port's serving fabric and modeled adapters against the JAX
reference's.

The fabric, its routers, work stealing and the fleet ledger are host code on
Python ints and floats in both packages, so everything is compared exactly:
the canonical bytes of the event stream (``RecordingSink.canonical_bytes``),
``fab.stats()`` (with its ``slo`` and ``energy`` blocks), every shard's
``stats()``, the replay summary and each request's lifecycle stamps.

- Modeled adapters (``serve/modeled.py``): ``traces/gateway_burst.json``,
  ``gateway_burst_x10.json`` and ``diurnal_smoke.json`` replayed through both
  packages' ``Fabric`` on every router, with stealing on and off, at 1, 4
  and 16 shards; ``ModeledSpecLMAdapter`` under an ``EnergyMeter``; a
  hypothesis sweep of ``tests/test_fabric.py``'s additivity property over
  synthetic shards.
- Real adapters: a 2-shard fabric of ``benchmarks/gateway.py``'s smoke
  models (the reference's weights carried over with ``params_from_jax``;
  the LM quantized and served on the Horner route, the reference's decode
  rebuilt through ``_exact_jit``) replays ``diurnal_smoke`` with a
  ``RecordingSink``, ``SloMonitor``, ``EnergyMeter`` and ``CaptureSink``
  armed, as ``chip_smoke.py`` phase 10 does at full width on the card:
  token streams exact, seg logits within 1e-5.
- ``bench/gateway.scaled_trace`` scales deadlines with arrival stamps.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_gateway import SynthAdapter, _exact_jit, _lifecycle, _np_tree

from benchmarks import capacity as jcapacity_bench
from benchmarks import gateway as jbench
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import energy_model as jem
from repro.core import quant as jquant
from repro.obs import capture as jcapture
from repro.obs import energy as jenergy
from repro.obs import events as jevents
from repro.obs import slo as jslo
from repro.obs import spans as jspans
from repro.serve import fabric as jfabric
from repro.serve import gateway as jgateway
from repro.serve import modeled as jmodeled
from repro.serve import serve_step as jserve_step
from repro.workload import Trace as JTrace
from repro.workload import lm_materializer as jlm_materializer
from repro.workload import replay as jreplay
from repro.workload import seg_materializer as jseg_materializer
from repro_torch.autotune.plan import TunedPlan
from repro_torch.bench import capacity as tcapacity_bench
from repro_torch.bench import gateway as tbench
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import energy_model as tem
from repro_torch.models import transformer, unet
from repro_torch.obs import capture, energy, events, slo, spans
from repro_torch.serve import fabric, gateway, modeled
from repro_torch.workload import Trace, lm_materializer, seg_materializer
from repro_torch.workload import replay

LOGIT_ATOL = 1e-5
TRACES = {name: f"traces/{name}.json" for name in ("gateway_burst", "gateway_burst_x10",
                                                    "diurnal_smoke")}
PKG = {
    "ref": types.SimpleNamespace(
        gateway=jgateway, fabric=jfabric, modeled=jmodeled, events=jevents, slo=jslo,
        energy=jenergy, spans=jspans, capture=jcapture, replay=jreplay, Trace=JTrace,
        em=jem, cfg=jget_smoke_config),
    "port": types.SimpleNamespace(
        gateway=gateway, fabric=fabric, modeled=modeled, events=events, slo=slo,
        energy=energy, spans=spans, capture=capture, replay=replay, Trace=Trace,
        em=tem, cfg=get_smoke_config),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _sinks(p, *, spec=False):
    """A recording sink teed with an ``SloMonitor`` (the capacity bench's
    specs) and an ``EnergyMeter`` (8-plane rates; 2-plane drafts)."""
    rec = p.events.RecordingSink()
    mon = p.slo.SloMonitor([
        p.slo.SloSpec("interactive", pct=99, latency_target_ms=6.0, miss_budget=0.05),
        p.slo.SloSpec("batch", pct=99, miss_budget=0.15),
        p.slo.SloSpec("seg", pct=99, miss_budget=0.25)], windows=(3_200_000, 16_000_000))
    meter = p.energy.EnergyMeter(
        {"lm": p.em.active_rate_pj(8), "seg": p.em.active_rate_pj(8)},
        draft_rates={"lm": p.em.active_rate_pj(2)} if spec else None,
        power=p.energy.PowerSpec(watts=3.2))
    return p.events.TeeSink([rec, mon, meter]), rec, mon, meter


def _same_fleet(jfab, tfab, jrec, trec):
    """Both fabrics produced the same run: event bytes, fleet and shard
    stats, request stamps."""
    jb, tb = jrec.canonical_bytes(), trec.canonical_bytes()
    if jb != tb:  # name the first line that differs
        for i, (a, b) in enumerate(zip(jrec.lines(), trec.lines())):
            assert b == a, f"event {i}"
    assert tb == jb
    assert tfab.stats() == jfab.stats()
    for j, t in zip(jfab.shards, tfab.shards):
        assert t.stats() == j.stats()
        assert _lifecycle(t) == _lifecycle(j)


def _check_fleet(fab, rec, mon, meter):
    """The gates phase 10 runs on the card: additivity, span/ledger, SLO
    and picojoule reconciliation."""
    assert fab.additivity()["holds"]
    sp = spans.assemble(rec.events)
    r = spans.reconcile(rec.events, [g.round_clock for g in fab.shards], ledger=fab.ledger)
    assert r["holds"], r
    assert mon.reconcile(sp)["holds"]
    e = meter.reconcile(energy.attach_joules(sp, meter))
    assert e["holds"], e["checks"]


# ----------------------------------------------------- modeled adapters


def _modeled_fabric(p, trace, *, n_shards, router, steal, spec=False, sink=None, seed=7):
    cfg = p.cfg("minitron_4b")
    shards = []
    for _ in range(n_shards):
        if spec:
            lm = p.modeled.ModeledSpecLMAdapter.from_config(cfg, batch=20, max_seq=96,
                                                            draft_schedule=(2,), k=4)
        else:
            lm = p.modeled.ModeledLMAdapter.from_config(cfg, batch=20, max_seq=96)
        shards.append(p.gateway.Gateway(
            [lm, p.modeled.ModeledSegAdapter.from_geometry()], policy="fair",
            round_budget=int(trace.meta["round_budget"]), shares=dict(trace.meta["shares"])))
    return p.fabric.Fabric(shards, router=router, seed=seed, steal=steal, sink=sink)


def _modeled_replay(trace_name, *, spec=False, **kw):
    out = {}
    for name in ("ref", "port"):
        p = PKG[name]
        trace = p.Trace.load(TRACES[trace_name])
        sink, rec, mon, meter = _sinks(p, spec=spec)
        fab = _modeled_fabric(p, trace, spec=spec, sink=sink, **kw)
        summary = p.replay.replay(fab, trace, {k: p.modeled.modeled_materializer()
                                               for k in trace.kinds})
        out[name] = (fab, rec, mon, meter, summary)
    return out


_GRID = (
    [(t, r, s, 4) for t in TRACES for r in ("class", "p2c", "deficit") for s in (True, False)]
    + [("gateway_burst_x10", r, True, n) for r in ("class", "p2c", "deficit") for n in (1, 16)]
)


@pytest.mark.parametrize("trace_name,router,steal,n_shards", _GRID,
                         ids=[f"{t}-{r}-{'steal' if s else 'nosteal'}-s{n}"
                              for t, r, s, n in _GRID])
def test_modeled_fabric_replay_equals_the_reference(trace_name, router, steal, n_shards):
    """Every committed trace on every router, stealing on and off: the same
    events, stats (with ``slo``/``energy`` blocks), shard stats, stamps and
    replay summary; every request completes and every ledger reconciles."""
    runs = _modeled_replay(trace_name, router=router, steal=steal, n_shards=n_shards)
    jfab, jrec, _, _, jsum = runs["ref"]
    tfab, trec, mon, meter, tsum = runs["port"]
    _same_fleet(jfab, tfab, jrec, trec)
    assert tsum == jsum
    assert {"slo", "energy"} <= set(tsum) and {"slo", "energy"} <= set(tfab.shards[0].stats())
    assert all(g.done for g in tfab.requests)
    assert len(tfab.requests) == tsum["trace"]["n_requests"]
    if not steal:
        assert tfab.stolen == 0
    _check_fleet(tfab, trec, mon, meter)


@pytest.mark.parametrize("trace_name,router", [("gateway_burst", "deficit"),
                                               ("diurnal_smoke", "p2c"),
                                               ("gateway_burst_x10", "class")])
def test_modeled_spec_fabric_under_a_meter_equals_the_reference(trace_name, router):
    """``ModeledSpecLMAdapter`` shards under an ``EnergyMeter`` with a
    2-plane draft rate: the same run, the spec account closes (useful +
    wasted = draft + verify pJ, slot cycles = round cycles) and draft
    rebates keep every invariant exact."""
    runs = _modeled_replay(trace_name, spec=True, router=router, steal=True, n_shards=4)
    jfab, jrec, jmon, jmeter, jsum = runs["ref"]
    tfab, trec, mon, meter, tsum = runs["port"]
    _same_fleet(jfab, tfab, jrec, trec)
    assert tsum == jsum
    assert {"draft", "verify", "accept"} <= {e.etype for e in trec.events}
    s = meter.spec_summary()
    assert s == jmeter.spec_summary() and s["rounds"] > 0
    assert s["useful_pj"] + s["wasted_pj"] == s["draft_pj"] + s["verify_pj"]
    rec = meter.reconcile()
    assert rec == jmeter.reconcile() and all(v["cycles_close"] for v in rec["spec"].values())
    _check_fleet(tfab, trec, mon, meter)


def test_modeled_adapters_price_as_the_reference():
    """``from_config``/``from_geometry`` prices at several plane schedules
    and geometries, and the materializer's pass-through."""
    for planes in (None, (4,), (8, 2)):
        out = []
        for p in (PKG["ref"], PKG["port"]):
            cfg = p.cfg("minitron_4b")
            if planes:
                cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
                    cfg.quant, plane_schedule=planes))
            lm = p.modeled.ModeledLMAdapter.from_config(cfg, batch=8, max_seq=64)
            sp = p.modeled.ModeledSpecLMAdapter.from_config(cfg, batch=8, max_seq=64,
                                                            draft_schedule=(3,), k=2)
            seg = p.modeled.ModeledSegAdapter.from_geometry(planes=planes[0] if planes else 8)
            out.append((vars(lm)["_step_cycles"], vars(lm)["_step_ops"],
                        {k: v for k, v in vars(sp).items() if isinstance(v, (int, tuple))},
                        {k: v for k, v in vars(seg).items() if isinstance(v, (int, tuple))}))
        assert out[1] == out[0]
    mat = modeled.modeled_materializer()
    treq = types.SimpleNamespace(payload={"prompt_len": 4, "max_new": 8})
    assert mat(treq, 0, 0) == ({"prompt_len": 4, "max_new": 8}, {})


def test_fabric_validation_messages_equal_the_reference():
    def errors(p):
        cfg = p.cfg("minitron_4b")

        def gw(budget=800_000, kinds=("lm", "seg"), shares=None):
            ads = {"lm": p.modeled.ModeledLMAdapter.from_config(cfg, batch=2, max_seq=32),
                   "seg": p.modeled.ModeledSegAdapter.from_geometry()}
            return p.gateway.Gateway([ads[k] for k in kinds], round_budget=budget,
                                     shares=shares or {"lm": 0.5, "seg": 0.5})

        late = gw()
        late.step_round()
        msgs = []
        for make in (lambda: p.fabric.Fabric([]),
                     lambda: p.fabric.Fabric([gw()], router="random"),
                     lambda: p.fabric.Fabric([gw(), gw(budget=1_000)]),
                     lambda: p.fabric.Fabric([gw(), gw(kinds=("lm",))]),
                     lambda: p.fabric.Fabric([gw(), gw(shares={"lm": 0.5, "seg": 0.3,
                                                               "x": 0.2})]),
                     lambda: p.fabric.Fabric([gw(), late])):
            with pytest.raises(ValueError) as ei:
                make()
            msgs.append(str(ei.value))
        for make in (lambda: p.modeled.ModeledLMAdapter(batch=0, step_cycles=1, step_ops=1),):
            with pytest.raises(ValueError) as ei:
                make()
            msgs.append(str(ei.value))
        return msgs

    assert errors(PKG["port"]) == errors(PKG["ref"])


def _synth_fleet(p, costs, router, n_shards, seed):
    sink = p.events.RecordingSink()
    fab = p.fabric.Fabric(
        [p.gateway.Gateway([SynthAdapter("a", slots=2), SynthAdapter("b", slots=2)],
                           policy="fair", round_budget=4_000, shares={"a": 0.5, "b": 0.5})
         for _ in range(n_shards)], router=router, seed=seed, sink=sink)
    arr = ([(i * 500, "a", int(c), dict(qos="a")) for i, c in enumerate(costs[::2])]
           + [(250 + i * 500, "b", int(c), dict(qos="b")) for i, c in enumerate(costs[1::2])])
    arr.sort(key=lambda a: a[0])
    i = 0
    while i < len(arr) or fab.pending():
        end = fab.clock + fab.round_budget
        due = []
        while i < len(arr) and arr[i][0] < end:
            due.append(arr[i])
            i += 1
        fab.step_round(arrivals=due)
    return fab, sink


@given(
    st.lists(st.integers(200, 5_000), min_size=1, max_size=24),
    st.sampled_from(["class", "p2c", "deficit"]),
    st.integers(1, 4),
    st.integers(0, 50),
)
@settings(max_examples=25, deadline=None)
def test_synthetic_fabric_sweep_equals_the_reference(costs, router, n_shards, seed):
    """``tests/test_fabric.py``'s additivity sweep on both packages'
    fabrics of synthetic shards: the same run, and the fleet ledger equals
    the direct per-shard sums exactly (1 op per cycle: both equal the
    offered cycles)."""
    jfab, jrec = _synth_fleet(PKG["ref"], costs, router, n_shards, seed)
    tfab, trec = _synth_fleet(PKG["port"], costs, router, n_shards, seed)
    _same_fleet(jfab, tfab, jrec, trec)
    add = tfab.additivity()
    assert add["holds"] and add["ledger_total_ops"] == add["ledger_total_worked"] == sum(costs)
    assert sum(1 for g in tfab.requests if g.done) == len(costs)


def test_fabric_drains_and_advances_as_the_reference():
    """``advance_to`` and ``drain`` (and its round cap) outside the replay
    harness, on a streamed diurnal feed through ``replay_stream``."""
    out = {}
    for name in ("ref", "port"):
        p = PKG[name]
        trace = p.Trace.load(TRACES["gateway_burst"])
        fab = _modeled_fabric(p, trace, n_shards=3, router="deficit", steal=True,
                              sink=p.events.RecordingSink())
        fab.advance_to(3_000_000)
        fab.step_round(arrivals=[(fab.clock + i, r.kind, dict(r.payload), dict(qos=r.qos))
                                 for i, r in enumerate(trace.requests)])
        with pytest.raises(RuntimeError) as ei:
            fab.drain(max_rounds=fab.rounds)
        fab.drain()
        bench = tcapacity_bench if name == "port" else jcapacity_bench
        feed = bench.mk_feed(dict(bench.WORKLOAD, span=4_800_000))
        fab2 = _modeled_fabric(p, trace, n_shards=2, router="p2c", steal=True)
        stream = p.replay.replay_stream(fab2, feed, label="s")
        out[name] = (str(ei.value), fab.sink.canonical_bytes(), fab.stats(), stream)
    assert out["port"] == out["ref"]


# ----------------------------------------------------------- real adapters


@functools.lru_cache(maxsize=None)
def _shared_exact_decode(cfg, batch, max_seq):
    return _exact_jit(jserve_step.make_decode(cfg, batch, max_seq)[0])


def _exact_shard_engines(adapter):
    """``_exact_engines`` with one compiled decode shared by every shard's
    engine of the same shape (each shard builds its own engine)."""
    make = adapter._make_engine

    def exact(cfg):
        eng = make(cfg)
        eng.decode_fn = _shared_exact_decode(cfg, eng.batch, eng.max_seq)
        return eng

    adapter._make_engine = exact
    adapter._build(adapter.cfg)
    return adapter


@pytest.fixture(scope="module")
def fleet_models():
    """``benchmarks/gateway.py``'s smoke models for ``diurnal_smoke`` in
    both packages: its U-Net and pinned plan, and its minitron_4b smoke LM
    quantized to int8 (``w_q`` leaves where both dims >= 128) on the Horner
    route; the reference's weights carried over."""
    trace = JTrace.load(TRACES["diurnal_smoke"])
    _, _, seg_cfg, seg_params, plan = jbench._build_models(trace)
    jcfg = jget_smoke_config("minitron_4b").replace(quant=JQuantConfig(mode="mma_int8"))
    from repro.models import transformer as jtransformer

    jqp = jquant.quantize_params_int8(
        jtransformer.init_params(jax.random.PRNGKey(0), jcfg), min_dim=128)
    port = (
        get_smoke_config("minitron_4b").replace(quant=QuantConfig(mode="mma_int8")),
        transformer.params_from_jax(_np_tree(jqp), device="cpu"),
        unet.UNetConfig(hw=seg_cfg.hw, in_ch=seg_cfg.in_ch, base=seg_cfg.base,
                        depth=seg_cfg.depth, convs_per_stage=seg_cfg.convs_per_stage,
                        n_classes=seg_cfg.n_classes, quant_mode="mma_int8",
                        plane_schedule=seg_cfg.plane_schedule),
        unet.params_from_jax(_np_tree(seg_params), device="cpu"),
        TunedPlan.from_json(plan.to_json()),
    )
    return (jcfg, jqp, seg_cfg, seg_params, plan), port


def _real_fleet(name, models, trace):
    """Phase 10's fabric at the smoke size: 2 shards of the bench's headline
    gateway (fair, preemptive, the trace's shares), ``deficit`` routing with
    stealing, seed 0, every sink armed."""
    p = PKG[name]
    lm_cfg, lm_params, seg_cfg, seg_params, plan = models
    dev = {} if name == "ref" else {"device": "cpu"}
    shards = []
    for _ in range(2):
        lm = p.gateway.LMAdapter(lm_cfg, lm_params, batch=tbench.LM_BATCH,
                                 max_seq=tbench.LM_MAX_SEQ, **dev)
        if name == "ref":
            lm = _exact_shard_engines(lm)
        seg = p.gateway.SegAdapter(seg_cfg, seg_params, plan=plan, batch=tbench.SEG_BATCH,
                                   max_active=tbench.SEG_MAX_ACTIVE, **dev)
        shards.append(p.gateway.Gateway([lm, seg], policy="fair",
                                        round_budget=int(trace.meta["round_budget"]),
                                        shares=dict(trace.meta["shares"])))
    sink, rec, mon, meter = _sinks(p)
    fab = p.fabric.Fabric(shards, router="deficit", seed=0, steal=True, sink=sink)
    cap = p.capture.CaptureSink()
    mats = {"lm": (jlm_materializer if name == "ref" else lm_materializer)(lm_cfg.vocab),
            "seg": (jseg_materializer if name == "ref" else seg_materializer)(seg_cfg.in_ch)}
    summary = p.replay.replay(fab, trace, mats, max_rounds=10_000, capture=cap)
    return fab, rec, mon, meter, cap, summary


def test_real_fabric_replay_equals_the_reference(fleet_models):
    """``diurnal_smoke`` (51 requests with deadlines) through 2 shards of
    real engines: event bytes (engine micro-steps included), fleet and shard
    stats with ``slo``/``energy`` blocks, replay summary and stamps equal;
    every LM request's tokens equal the reference's; seg logits within
    1e-5; the captured trace equals the reference's and the replayed one;
    every ledger reconciles."""
    jmodels, tmodels = fleet_models
    jt = JTrace.load(TRACES["diurnal_smoke"])
    tt = Trace.load(TRACES["diurnal_smoke"])
    jfab, jrec, _, _, jcap, jsum = _real_fleet("ref", jmodels, jt)
    tfab, trec, mon, meter, cap, tsum = _real_fleet("port", tmodels, tt)
    _same_fleet(jfab, tfab, jrec, trec)
    assert tsum == jsum
    st_ = tfab.stats()
    assert st_["dispatched"][0] > 0 and st_["dispatched"][1] > 0
    assert {"slo", "energy"} <= set(st_) and all(
        {"slo", "energy"} <= set(g.stats()) for g in tfab.shards)
    assert {"lm-prefill", "lm-step", "seg-batch", "tile", "exec", "route"} <= \
        {e.etype for e in trec.events}
    reqs = list(zip(tfab.requests, jfab.requests))
    assert len(reqs) == 51 and all(t.done for t, _ in reqs)
    lm = [(t, j) for t, j in reqs if t.kind == "lm"]
    assert [t.handle.out for t, _ in lm] == [j.handle.out for _, j in lm]
    assert all(len(t.handle.out) == t.handle.max_new for t, _ in lm)
    seg = [(t, j) for t, j in reqs if t.kind == "seg"]
    assert len(seg) == 5
    for t, j in seg:
        np.testing.assert_allclose(t.handle.result.logits, np.asarray(j.handle.result.logits),
                                   atol=LOGIT_ATOL, rtol=0)
    back = cap.to_trace("captured", seed=tt.seed, meta=dict(tt.meta))
    assert back.to_json() == jcap.to_trace("captured", seed=jt.seed, meta=dict(jt.meta)).to_json()
    assert [(r.kind, r.qos, r.arrival_cycle, r.payload, r.deadline_cycles)
            for r in back.requests] == \
        [(r.kind, r.qos, r.arrival_cycle, r.payload, r.deadline_cycles) for r in tt.requests]
    _check_fleet(tfab, trec, mon, meter)


# ------------------------------------------------------------ scaled traces


@pytest.mark.parametrize("k", [1, 3, 6672])
def test_scaled_trace_scales_deadlines_with_the_clock(k):
    """``bench.gateway.scaled_trace``: arrival stamps, every set deadline
    and the round budget times ``k``; unset deadlines stay unset; payloads,
    classes, seed and order unchanged; the source trace untouched."""
    for name in ("diurnal_smoke", "gateway_burst"):
        tr = Trace.load(TRACES[name])
        before = tr.to_json()
        sc = tbench.scaled_trace(tr, k)
        assert tr.to_json() == before
        assert sc.meta["round_budget"] == tr.meta["round_budget"] * k
        assert sc.seed == tr.seed and len(sc) == len(tr)
        for a, b in zip(tr.requests, sc.requests):
            assert (b.kind, b.qos, b.payload) == (a.kind, a.qos, a.payload)
            assert b.arrival_cycle == a.arrival_cycle * k
            assert b.deadline_cycles == (None if a.deadline_cycles is None
                                         else a.deadline_cycles * k)
        assert sum(r.deadline_cycles is not None for r in sc.requests) == \
            (51 if name == "diurnal_smoke" else 0)
    with pytest.raises(ValueError, match="clock scale 0"):
        tbench.scaled_trace(tr, 0)


def test_scaled_trace_keeps_deadline_misses_at_scale():
    """A modeled fabric replaying ``diurnal_smoke`` with every cycle price
    times ``k`` (the modeled LM's and seg's step prices, the trace's stamps,
    deadlines and round budget) misses the same deadlines as the unscaled
    run: scaling the deadlines keeps them where they were relative to the
    work."""
    def misses(k):
        tr = tbench.scaled_trace(Trace.load(TRACES["diurnal_smoke"]), k)
        cfg = get_smoke_config("minitron_4b")
        shards = []
        for _ in range(2):
            lm = modeled.ModeledLMAdapter.from_config(cfg, batch=20, max_seq=32)
            lm._step_cycles *= k
            seg = modeled.ModeledSegAdapter.from_geometry()
            seg._tile_cycles *= k
            shards.append(gateway.Gateway([lm, seg], policy="fair",
                                          round_budget=int(tr.meta["round_budget"]),
                                          shares=dict(tr.meta["shares"])))
        fab = fabric.Fabric(shards, router="deficit", seed=0)
        s = replay.replay(fab, tr, {kk: modeled.modeled_materializer() for kk in tr.kinds})
        return {q: c["deadline_misses"] for q, c in s["per_class"].items()}, s["rounds"]

    base = misses(1)
    assert misses(5) == base
    assert sum(base[0].values()) > 0
