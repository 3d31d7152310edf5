"""The port's telemetry layer against the JAX reference's: SLO monitoring,
deadline-miss attribution, integer-picojoule energy metering, trace capture,
the ledger report and the three fleet bench twins.

None of these modules touches a tensor: the port's are copies of the
reference's, so everything is compared exactly.

- Sinks alone: one reference event stream (a reference fabric of modeled
  adapters replaying ``traces/gateway_burst_x10.json``) is fed to both
  packages' ``SloMonitor`` and ``EnergyMeter``; their summaries, attribution
  histograms, burn rates, spec accounts and reconciliations are equal, and
  so are ``attrib``'s histograms on the same spans and ``PowerSpec`` cap
  violations.
- A single gateway with a monitor or meter armed directly, teed or both:
  ``stats()`` carries equal ``slo`` and ``energy`` blocks.
- Capture: ``CaptureSink.to_trace`` gives the reference's trace, and
  replaying it gives the captured run's event stream again.
- Report: ``build_report`` over the committed ``BENCH_LEDGER.jsonl`` and
  ``BENCH_*.json`` gives the reference's markdown and JSON string for
  string.
- Bench twins: ``repro_torch.bench.{fabric,capacity,energy}.run`` return the
  payload the reference benches write, on their full grids and on the cut
  grids the reference's own tests use.  (The committed ``BENCH_fabric.json``
  predates the per-class ``deadline_misses`` field; the twin is held to the
  reference bench's run, not to that file.)
"""
import dataclasses
import glob
import json
import types

import pytest

from benchmarks import capacity as jcapacity_bench
from benchmarks import energy as jenergy_bench
from benchmarks import fabric as jfabric_bench
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import energy_model as jem
from repro.obs import attrib as jattrib
from repro.obs import capture as jcapture
from repro.obs import energy as jenergy
from repro.obs import events as jevents
from repro.obs import report as jreport
from repro.obs import slo as jslo
from repro.obs import spans as jspans
from repro.serve import fabric as jfabric
from repro.serve import gateway as jgateway
from repro.serve import modeled as jmodeled
from repro.workload import Trace as JTrace
from repro.workload import replay as jreplay
from repro_torch.bench import capacity as tcapacity_bench
from repro_torch.bench import energy as tenergy_bench
from repro_torch.bench import fabric as tfabric_bench
from repro_torch.configs import get_smoke_config
from repro_torch.core import energy_model as tem
from repro_torch.obs import attrib, capture, energy, events, report, slo, spans
from repro_torch.serve import fabric, gateway, modeled
from repro_torch.workload import Trace
from repro_torch.workload import replay

PKG = {
    "ref": types.SimpleNamespace(
        gateway=jgateway, fabric=jfabric, modeled=jmodeled, events=jevents, slo=jslo,
        energy=jenergy, spans=jspans, attrib=jattrib, capture=jcapture, replay=jreplay,
        Trace=JTrace, em=jem, cfg=jget_smoke_config),
    "port": types.SimpleNamespace(
        gateway=gateway, fabric=fabric, modeled=modeled, events=events, slo=slo,
        energy=energy, spans=spans, attrib=attrib, capture=capture, replay=replay,
        Trace=Trace, em=tem, cfg=get_smoke_config),
}
TRACES = {name: f"traces/{name}.json" for name in ("gateway_burst", "gateway_burst_x10",
                                                    "diurnal_smoke")}
WINDOWS = (3_200_000, 16_000_000)


def _specs(p):
    return [p.slo.SloSpec("interactive", pct=99, latency_target_ms=6.0, miss_budget=0.05),
            p.slo.SloSpec("batch", pct=99, miss_budget=0.15),
            p.slo.SloSpec("seg", pct=99, miss_budget=0.25)]


def _modeled_gateway(p, trace, *, spec=False, sink=None):
    """``benchmarks/fabric.py``'s modeled gateway in package ``p`` (with
    ``spec``: 2-plane speculative drafts, k = 4, as the energy bench)."""
    cfg = p.cfg("minitron_4b")
    if spec:
        lm = p.modeled.ModeledSpecLMAdapter.from_config(cfg, batch=20, max_seq=96,
                                                        draft_schedule=(2,), k=4)
    else:
        lm = p.modeled.ModeledLMAdapter.from_config(cfg, batch=20, max_seq=96)
    return p.gateway.Gateway([lm, p.modeled.ModeledSegAdapter.from_geometry()],
                             policy="fair", round_budget=int(trace.meta["round_budget"]),
                             shares=dict(trace.meta["shares"]), sink=sink)


def _meter(p, *, spec=False, watts=None):
    rates = {"lm": p.em.active_rate_pj(8), "seg": p.em.active_rate_pj(8)}
    draft = {"lm": p.em.active_rate_pj(2)} if spec else None
    power = None if watts is None else p.energy.PowerSpec(watts=watts, window=800_000,
                                                          buckets=8)
    return p.energy.EnergyMeter(rates, draft_rates=draft, power=power)


def _reference_stream(trace_name="gateway_burst_x10", *, n_shards=4, spec=False):
    """The events of a reference fabric of modeled adapters replaying a
    committed trace (``deficit`` router, stealing on)."""
    p = PKG["ref"]
    trace = JTrace.load(TRACES[trace_name])
    sink = jevents.RecordingSink()
    fab = jfabric.Fabric([_modeled_gateway(p, trace, spec=spec) for _ in range(n_shards)],
                         router="deficit", seed=7, sink=sink)
    jreplay.replay(fab, trace, {k: jmodeled.modeled_materializer() for k in trace.kinds})
    return sink.events


def _port_events(jevs):
    return [events.Event(e.cycle, e.etype, dict(e.data)) for e in jevs]


# ------------------------------------------------------------ sinks alone


@pytest.mark.parametrize("spec", [False, True], ids=["greedy", "spec"])
def test_monitor_and_meter_on_one_stream_equal_the_reference(spec):
    """One reference event stream into both packages' ``SloMonitor`` and
    ``EnergyMeter``: every query equal, per shard and fleet-wide, and both
    reconcile against their own package's spans of that stream."""
    jevs = _reference_stream(spec=spec)
    out = {}
    for name, evs in (("ref", jevs), ("port", _port_events(jevs))):
        p = PKG[name]
        mon = p.slo.SloMonitor(_specs(p), windows=WINDOWS)
        meter = _meter(p, spec=spec, watts=3.2)
        tee = p.events.TeeSink([mon, meter])
        for e in evs:
            tee.emit(e)
        sp = p.energy.attach_joules(p.spans.assemble(evs), meter)
        scopes = mon.scopes()
        out[name] = dict(
            scopes=scopes,
            summary={str(s): mon.summary(scope=s) for s in scopes},
            counts={str(s): mon.counts(s) for s in scopes},
            attribution={str(s): mon.attribution(s) for s in scopes},
            burn={(str(s), q): mon.burn_rates(q, scope=s) for s in scopes
                  for q in ("interactive", "batch", "seg")},
            slo_reconcile=mon.reconcile(sp),
            meter_scopes=meter.ledger.scopes(),
            meter_summary={str(s): meter.summary(scope=s) for s in meter.ledger.scopes()},
            spec_summary={str(s): meter.spec_summary(s) for s in meter.ledger.scopes()},
            meter_reconcile=meter.reconcile(sp),
            cap_events=list(meter.cap_events),
            span_pj=[(s.shard, s.rid, s.pj) for s in sp],
        )
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port["slo_reconcile"]["holds"] and port["meter_reconcile"]["holds"]
    assert sum(port["slo_reconcile"]["online"].values()) > 0  # x10 misses deadlines
    assert (port["spec_summary"]["fleet"] is not None) == spec
    if spec:
        s = port["spec_summary"]["fleet"]
        assert s["useful_pj"] + s["wasted_pj"] == s["draft_pj"] + s["verify_pj"]


def test_attribution_histograms_equal_the_reference():
    """``attrib`` on the same spans: per-span classes, miss counts,
    histograms and shares equal."""
    jevs = _reference_stream("diurnal_smoke", n_shards=2)
    jsp, tsp = jspans.assemble(jevs), spans.assemble(_port_events(jevs))
    assert [dataclasses.astuple(s) for s in tsp] == [dataclasses.astuple(s) for s in jsp]
    assert attrib.ATTRIB_CLASSES == jattrib.ATTRIB_CLASSES
    assert [attrib.classify(s) for s in tsp if s.done] == \
        [jattrib.classify(s) for s in jsp if s.done]
    assert attrib.span_misses(tsp) == jattrib.span_misses(jsp)
    hist = attrib.attribute(tsp)
    assert hist == jattrib.attribute(jsp) and hist
    for q, h in hist.items():
        assert attrib.attribution_shares(h) == jattrib.attribution_shares(h)
    for seg in [(0, 0, 0), (5, 1, 1), (1, 5, 1), (1, 1, 5), (3, 3, 3), (0, 4, 4)]:
        assert attrib.classify_segments(*seg) == jattrib.classify_segments(*seg)


@pytest.mark.parametrize("watts", [0.5, 1.5, 3.2, 100.0])
def test_power_cap_violations_equal_the_reference(watts):
    """Rolling per-shard power caps: violation edges, the ``power-cap``
    events a side sink receives, peak watts and the fleet power block."""
    jevs = _reference_stream("gateway_burst", n_shards=2)
    out = {}
    for name, evs in (("ref", jevs), ("port", _port_events(jevs))):
        p = PKG[name]
        side = p.events.RecordingSink()
        meter = p.energy.EnergyMeter({"lm": p.em.active_rate_pj(8)},
                                     power=p.energy.PowerSpec(watts=watts, window=400_000,
                                                              buckets=4), sink=side)
        for e in evs:
            meter.emit(e)
        out[name] = (meter.cap_events, side.canonical_bytes(),
                     [meter.summary(scope=s)["power"] for s in meter.ledger.scopes()])
    assert out["port"] == out["ref"]
    assert (len(out["port"][0]) > 0) == (watts < 100.0)


def test_spec_validation_messages_equal_the_reference():
    def errors(p):
        msgs = []
        for make in (lambda: p.slo.SloSpec("a", pct=0), lambda: p.slo.SloSpec("a", miss_budget=2),
                     lambda: p.slo.SloSpec("a", latency_target_ms=-1),
                     lambda: p.energy.PowerSpec(watts=0),
                     lambda: p.energy.PowerSpec(watts=1, window=0),
                     lambda: p.energy.PowerSpec(watts=1, buckets=0),
                     lambda: p.energy.EnergyMeter(static_pj=-1)):
            with pytest.raises(ValueError) as ei:
                make()
            msgs.append(str(ei.value))
        return msgs

    assert errors(PKG["port"]) == errors(PKG["ref"])
    assert slo.SloSpec("x", latency_target_ms=6.0).latency_target_cycles == \
        jslo.SloSpec("x", latency_target_ms=6.0).latency_target_cycles


# ------------------------------------------------------ a gateway's stats()


def _armed(p, how):
    mon = p.slo.SloMonitor(_specs(p), windows=WINDOWS)
    meter = _meter(p, spec=True)
    rec = p.events.RecordingSink()
    sink = {"monitor": mon, "meter": meter,
            "teed": p.events.TeeSink([rec, mon, meter]),
            "shard-wrapped": p.events.ShardSink(p.events.TeeSink([rec, meter, mon]), 3)}[how]
    return sink, mon, meter


@pytest.mark.parametrize("how", ["monitor", "meter", "teed", "shard-wrapped"])
def test_gateway_stats_slo_and_energy_blocks_equal_the_reference(how):
    """A single modeled gateway (speculative LM) replaying ``diurnal_smoke``
    with a monitor and/or meter armed directly, teed or shard-wrapped: its
    ``stats()`` (with ``slo``/``energy`` blocks and ``metered_gops_w``) and
    the replay summary equal the reference's."""
    out = {}
    for name in ("ref", "port"):
        p = PKG[name]
        trace = p.Trace.load(TRACES["diurnal_smoke"])
        sink, mon, meter = _armed(p, how)
        gw = _modeled_gateway(p, trace, spec=True, sink=sink)
        summary = p.replay.replay(gw, trace, {k: p.modeled.modeled_materializer()
                                              for k in trace.kinds})
        out[name] = (gw.stats(), summary)
    assert out["port"] == out["ref"]
    st = out["port"][0]
    assert ("slo" in st) == (how != "meter") and ("energy" in st) == (how != "monitor")
    if "energy" in st:
        e = st["energy"]
        assert e["analytic_gops_w"] == st["gops_w"]
        assert e["metered_gops_w"] == tem.metered_gops_per_w(st["total_ops"], e["total_pj"])
        assert e["spec"] is not None and out["port"][1]["energy"] == e


# ---------------------------------------------------------------- capture


@pytest.mark.parametrize("trace_name", ["gateway_burst", "diurnal_smoke"])
def test_capture_round_trip_equals_the_reference(trace_name):
    """A modeled gateway replays a committed trace with a ``CaptureSink``
    teed beside a ``RecordingSink``: the captured trace equals the
    reference's (and the original's requests), and replaying it gives the
    captured run's event stream again, in both packages."""
    out = {}
    for name in ("ref", "port"):
        p = PKG[name]
        trace = p.Trace.load(TRACES[trace_name])
        mats = {k: p.modeled.modeled_materializer() for k in trace.kinds}

        def run(tr, cap=None):
            gw = _modeled_gateway(p, tr, sink=p.events.RecordingSink())
            summary = p.replay.replay(gw, tr, mats, capture=cap)
            return gw.sink, summary

        cap = p.capture.CaptureSink()
        tee, summary = run(trace, cap)
        rec = tee.sinks[0]
        assert len(cap) == len(trace)
        back = cap.to_trace(f"{trace_name}_captured", seed=trace.seed, meta=dict(trace.meta))
        rec2, summary2 = run(back)
        assert rec2.canonical_bytes() == rec.canonical_bytes()
        # a request without a deadline is captured with the gateway's default
        assert [(r.kind, r.qos, r.arrival_cycle, r.payload) for r in back.requests] == \
            [(r.kind, r.qos, r.arrival_cycle, r.payload) for r in trace.requests]
        assert all(b.deadline_cycles == r.deadline_cycles for b, r in
                   zip(back.requests, trace.requests) if r.deadline_cycles is not None)
        out[name] = (back.to_json(), rec.canonical_bytes(), summary, summary2)
    assert out["port"] == out["ref"]


def test_capture_through_a_modeled_fabric_fails_as_the_reference():
    """A fabric prepares each arrival before routing it, so a modeled
    shard's ``submit`` carries the prepared job, whose payload spec is
    empty: the reference's ``to_trace`` then raises, and the port's raises
    the same error (real adapters' prepared requests keep their spec; the
    fabric tests capture through those)."""
    msgs = []
    for name in ("ref", "port"):
        p = PKG[name]
        trace = p.Trace.load(TRACES["gateway_burst"])
        fab = p.fabric.Fabric([_modeled_gateway(p, trace) for _ in range(2)], router="p2c")
        cap = p.capture.CaptureSink()
        p.replay.replay(fab, trace, {k: p.modeled.modeled_materializer() for k in trace.kinds},
                        capture=cap)
        assert len(cap) == len(trace)
        with pytest.raises(ValueError) as ei:
            cap.to_trace("x", seed=trace.seed)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_capture_relative_deadlines_and_defaults_equal_the_reference():
    """Deadlines stored relative, a deadline at or before arrival dropped,
    and the captured-trace metadata, against the reference."""
    evs = [(100, dict(kind="lm", qos="interactive", deadline=500,
                      spec=dict(prompt_len=4, max_new=2))),
           (200, dict(kind="seg", deadline=200, spec=dict(h=8, w=8))),
           (300, dict(kind="seg", spec=dict(h=16, w=8)))]
    out = {}
    for name in ("ref", "port"):
        p = PKG[name]
        cap = p.capture.CaptureSink()
        for cyc, d in evs:
            cap.emit(p.events.Event(cyc, "submit", d))
            cap.emit(p.events.Event(cyc, "admit", d))
        out[name] = cap.to_trace("t", seed=5, description="", meta={"x": 1}).to_json()
    assert out["port"] == out["ref"]


# ----------------------------------------------------------------- report


def test_build_report_equals_the_reference():
    """The committed ledger and bench payloads: markdown and JSON equal,
    string for string (and the trend series)."""
    benches = sorted(glob.glob("BENCH_*.json"))
    assert len(benches) >= 7
    tmd, tpayload = report.build_report("BENCH_LEDGER.jsonl", benches)
    jmd, jpayload = jreport.build_report("BENCH_LEDGER.jsonl", benches)
    assert tmd == jmd
    assert json.dumps(tpayload, sort_keys=True) == json.dumps(jpayload, sort_keys=True)
    assert tpayload["schema"] == "repro.obs.report"
    ledger = report.read_ledger("BENCH_LEDGER.jsonl")
    assert ledger == jreport.read_ledger("BENCH_LEDGER.jsonl") and ledger
    assert report.trend(ledger) == jreport.trend(ledger)
    assert report.read_benches(benches) == jreport.read_benches(benches)


def test_build_report_on_fresh_bench_payloads_equals_the_reference(tmp_path):
    """The report over the twins' payloads (written by this run) and a
    missing ledger: equal output, and every table section present."""
    paths = []
    for name, mod in (("fabric", tfabric_bench), ("energy", tenergy_bench)):
        path = tmp_path / f"BENCH_{name}.json"
        path.write_text(json.dumps(mod.run(), indent=2) + "\n")
        paths.append(str(path))
    missing = str(tmp_path / "no_ledger.jsonl")
    tmd, tpayload = report.build_report(missing, paths)
    jmd, jpayload = jreport.build_report(missing, paths)
    assert tmd == jmd and tpayload == jpayload
    assert set(tpayload["benches"]) == {"fabric", "energy"}


# ------------------------------------------------------------ bench twins


def _reference_payload(mod, tmp_path, **kw):
    path = tmp_path / "ref.json"
    mod.run(json_path=str(path), **kw)
    return json.loads(path.read_text())


@pytest.mark.parametrize("bench", ["fabric", "capacity", "energy"])
def test_bench_twin_equals_the_reference_bench(bench, tmp_path):
    """Each twin's payload on its full grid equals what the reference bench
    writes (the JSON round trip included)."""
    jmod, tmod = {"fabric": (jfabric_bench, tfabric_bench),
                  "capacity": (jcapacity_bench, tcapacity_bench),
                  "energy": (jenergy_bench, tenergy_bench)}[bench]
    payload = tmod.run()
    assert payload["bench"] == bench and payload["gate"]["holds"]
    assert json.loads(json.dumps(payload)) == _reference_payload(jmod, tmp_path)


def test_committed_capacity_and_energy_payloads_equal_the_twins():
    """The committed ``BENCH_capacity.json`` and ``BENCH_energy.json`` are
    what the twins return."""
    for name, mod in (("capacity", tcapacity_bench), ("energy", tenergy_bench)):
        with open(f"BENCH_{name}.json") as fh:
            assert json.loads(json.dumps(mod.run())) == json.load(fh), name


@pytest.mark.parametrize("bench,kw", [
    ("capacity", dict(shard_counts=(2, 4), routers=("deficit",), policies=("fair",),
                      plans=("uniform8",))),
    ("capacity", dict(shard_counts=(2, 4), routers=("p2c", "deficit"), policies=("fair",),
                      plans=("uniform8", "tuned4"))),
    ("energy", dict(shard_counts=(2,), policies=("fair",),
                    workload=dict(jenergy_bench.WORKLOAD, span=9_600_000))),
    ("energy", dict(shard_counts=(2, 4), policies=("edf",), plans=("uniform8", "spec2"))),
], ids=["capacity-tiny", "capacity-plans", "energy-tiny", "energy-spec"])
def test_bench_twin_on_a_cut_grid_equals_the_reference(bench, kw, tmp_path):
    """The cut grids of the reference's own bench tests (and two more): the
    same payload, the reconciliation point moved the same way."""
    jmod, tmod = {"capacity": (jcapacity_bench, tcapacity_bench),
                  "energy": (jenergy_bench, tenergy_bench)}[bench]
    payload = tmod.run(**kw)
    assert payload["gate"]["reconcile"]["holds"]
    assert json.loads(json.dumps(payload)) == _reference_payload(jmod, tmp_path, **kw)


@pytest.mark.parametrize("bench,kw", [
    ("capacity", dict(plans=("uniform9",))),
    ("energy", dict(plans=("uniform9",))),
    ("capacity", dict(shard_counts=(2,), routers=("deficit",), policies=("fair",),
                      plans=("uniform8",),
                      workload=dict(jcapacity_bench.WORKLOAD, span=4_800_000,
                                    interactive=dict(jcapacity_bench.WORKLOAD["interactive"],
                                                     peak_interval=8_000)))),
], ids=["capacity-plan", "energy-plan", "capacity-no-frontier"])
def test_bench_twin_raises_where_the_reference_raises(bench, kw, tmp_path):
    """An unknown plan, and a load no grid point meets the SLOs under: the
    twin raises the reference's exception with its message."""
    jmod, tmod = {"capacity": (jcapacity_bench, tcapacity_bench),
                  "energy": (jenergy_bench, tenergy_bench)}[bench]
    with pytest.raises(Exception) as je:
        jmod.run(json_path=str(tmp_path / "x.json"), **kw)
    with pytest.raises(type(je.value)) as te:
        tmod.run(**kw)
    assert str(te.value) == str(je.value)
