"""The port's workload layer (arrival processes, trace schema, diurnal
streams, materializers, open-loop replay) and the rest of its event bus
against the JAX reference's.

Both are numpy and the standard library in both packages, so every arrival
stamp, trace document, payload and summary is compared exactly.  The seeds
are those of ``scripts/make_traces.py``, which wrote the committed traces.
"""
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import events as jevents
from repro.serve.engine import Request as JRequest
from repro.serve.gateway import Gateway as JGateway
from repro.workload import Trace as JTrace
from repro.workload import TraceRequest as JTraceRequest
from repro.workload import arrivals as jarrivals
from repro.workload import diurnal as jdiurnal
from repro.workload import lm_materializer as jlm_materializer
from repro.workload import replay_stream as jreplay_stream
from repro.workload import seg_materializer as jseg_materializer
from repro.workload import trace as jtrace
from repro_torch.obs import events
from repro_torch.serve.engine import Request
from repro_torch.serve.gateway import Gateway
from repro_torch.workload import Trace, TraceRequest, arrivals, diurnal, from_streams
from repro_torch.workload import lm_materializer, replay_stream, seg_materializer
from repro_torch.workload import trace as ttrace

TRACES = ("gateway_burst", "gateway_burst_x10", "gateway_burst_x100", "diurnal_smoke")
BURST_SEED, DIURNAL_SEED = 20260729, 20260808
# gateway_burst and its x10/x100 variants (seed + factor), then diurnal_smoke
SEEDS = (BURST_SEED, BURST_SEED + 10, BURST_SEED + 100)


def _path(name):
    return f"traces/{name}.json"


# --------------------------------------------------------------- arrivals


def test_counter_uniform_equals_the_reference():
    for seed, counters in itertools.product((0, 7, BURST_SEED, 2**64 + 3),
                                            ((), (1,), (0x9015504E, 5), (2, 3, 2**63))):
        assert arrivals.counter_uniform(seed, *counters) == \
            jarrivals.counter_uniform(seed, *counters)


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_processes_equal_the_reference(seed):
    """``make_traces.py``'s streams at each scale factor: the Poisson
    interactive stream, the on-off batch bursts, the deterministic seg
    minority, and ``generate``'s dispatch."""
    factor = seed - BURST_SEED or 1
    kw = [
        ("poisson", 20 * factor, dict(mean_interval=400_000 / factor, seed=seed, start=50_000)),
        ("on_off", 12 * factor, dict(seed=seed + 1, burst_interval=120_000 / factor,
                                     on_mean=800_000, off_mean=1_600_000, start=150_000)),
        ("deterministic", 3 * factor, dict(interval=max(2_500_000 // factor, 1), start=600_000)),
    ]
    for process, n, k in kw:
        got = arrivals.generate(process, n, **k)
        assert got == jarrivals.generate(process, n, **k)
        assert got == getattr(arrivals, process)(n, **k) and len(got) == n
    with pytest.raises(ValueError, match="unknown arrival process"):
        arrivals.generate("lifo", 3)
    for bad in (lambda m: m.poisson(-1, mean_interval=1, seed=0),
                lambda m: m.poisson(2, mean_interval=0, seed=0),
                lambda m: m.deterministic(2, interval=0),
                lambda m: m.on_off(2, seed=0, burst_interval=1, on_mean=0, off_mean=1)):
        for mod in (arrivals, jarrivals):
            with pytest.raises(ValueError):
                bad(mod)


def test_diurnal_streams_equal_the_reference():
    """The generators behind ``diurnal_smoke`` (seed 20260808) and their
    prefix identity with the list builders."""
    seed, period = DIURNAL_SEED, 9_600_000
    for mod in (diurnal, jdiurnal):
        assert mod.take(mod.iter_poisson(seed=seed, mean_interval=150_000), 50) == \
            jarrivals.poisson(50, mean_interval=150_000, seed=seed)
    for cyc in (0, 1, period // 4, period // 2, 3 * period, 12_345_678):
        for floor, phase in ((0.15, 0.0), (0.2, 0.25), (1.0, 0.5)):
            assert diurnal.day_curve(cyc, period=period, floor=floor, phase=phase) == \
                jdiurnal.day_curve(cyc, period=period, floor=floor, phase=phase)

    def streams(mod):
        return [
            list(mod.take_until(mod.diurnal(seed=seed, peak_interval=150_000, period=period,
                                            floor=0.2, start=50_000), period)),
            list(mod.take_until(mod.modulate(
                mod.iter_on_off(seed=seed + 1, burst_interval=250_000, on_mean=800_000,
                                off_mean=1_600_000, start=150_000),
                seed=seed + 1, period=period, floor=0.2), period)),
            list(mod.take_until(mod.iter_poisson(seed=seed + 2, mean_interval=2_000_000,
                                                 start=600_000), period)),
            mod.take(mod.iter_on_off(seed=3, burst_interval=10, on_mean=100, off_mean=50), 40),
            list(mod.merge([1, 5, 9], [1, 2, 12], [])),
        ]

    got = streams(diurnal)
    assert got == streams(jdiurnal)
    assert got[3] == jarrivals.on_off(40, seed=3, burst_interval=10, on_mean=100, off_mean=50)
    for mod in (diurnal, jdiurnal):
        with pytest.raises(ValueError):
            mod.day_curve(0, period=0)
        with pytest.raises(ValueError):
            next(mod.iter_poisson(seed=0, mean_interval=-1))


def _feeds(mod):
    return [
        dict(kind="lm", qos="interactive", payload=dict(prompt_len=4, max_new=8),
             arrivals=mod.diurnal(seed=DIURNAL_SEED, peak_interval=150_000,
                                  period=9_600_000, floor=0.2), deadline_cycles=400_000),
        dict(kind="seg", arrivals=mod.iter_poisson(seed=DIURNAL_SEED + 2,
                                                   mean_interval=2_000_000),
             payload=lambda i: dict(h=96 + 8 * i, w=80)),
    ]


def test_stream_requests_equal_the_reference():
    for kw in (dict(until=9_600_000), dict(limit=17), dict(until=5_000_000, limit=1_000)):
        got = list(diurnal.stream_requests(_feeds(diurnal), **kw))
        assert got == list(jdiurnal.stream_requests(_feeds(jdiurnal), **kw))
        assert got == sorted(got, key=lambda r: r[0])
    with pytest.raises(ValueError, match="kind/arrivals/payload"):
        list(diurnal.stream_requests([dict(kind="lm")]))


# ------------------------------------------------------------------ trace


@pytest.mark.parametrize("name", TRACES)
def test_committed_traces_load_as_the_reference(name):
    got, want = Trace.load(_path(name)), JTrace.load(_path(name))
    assert got.to_json() == want.to_json()
    with open(_path(name)) as f:
        assert got.to_json() == json.load(f)  # the committed document, whole
    assert (got.describe(), got.qos_classes, got.kinds, got.span_cycles, len(got)) == \
        (want.describe(), want.qos_classes, want.kinds, want.span_cycles, len(want))


def test_burst_trace_rebuilds_from_the_port_streams():
    """``make_traces.py``'s ``gateway_burst`` rebuilt from the port's own
    arrival processes and ``from_streams``: the committed trace."""
    seed = BURST_SEED
    trace = from_streams(
        "gateway_burst", seed,
        [dict(kind="lm", qos="interactive", payload=dict(prompt_len=4, max_new=8),
              arrivals=arrivals.poisson(20, mean_interval=400_000, seed=seed, start=50_000)),
         dict(kind="lm", qos="batch", payload=dict(prompt_len=24, max_new=4),
              arrivals=arrivals.on_off(12, seed=seed + 1, burst_interval=120_000,
                                       on_mean=800_000, off_mean=1_600_000, start=150_000)),
         dict(kind="seg", qos="seg", payload=dict(h=96, w=80),
              arrivals=arrivals.deterministic(3, interval=2_500_000, start=600_000))],
        description=Trace.load(_path("gateway_burst")).description,
        meta=Trace.load(_path("gateway_burst")).meta,
    )
    assert trace.to_json() == Trace.load(_path("gateway_burst")).to_json()


def test_trace_files_cross_load(tmp_path):
    """A trace saved by either package loads in the other, unchanged."""
    src = Trace.load(_path("diurnal_smoke"))
    src.save(tmp_path / "port.json")
    assert JTrace.load(tmp_path / "port.json").to_json() == src.to_json()
    JTrace.load(_path("gateway_burst")).save(tmp_path / "ref.json")
    assert Trace.load(tmp_path / "ref.json").to_json() == \
        Trace.load(_path("gateway_burst")).to_json()
    # written through a temporary file and renamed: none is left behind
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.json", "ref.json"]


def test_trace_validation_equals_the_reference():
    def errors(tmod, treq, trace):
        bad = [
            lambda: tmod.validate_payload("lm", {"prompt_len": 4}),
            lambda: tmod.validate_payload("seg", {"h": 0, "w": 3}),
            lambda: treq(kind="lm", qos="x", arrival_cycle=-1, payload={"prompt_len": 1,
                                                                          "max_new": 1}),
            lambda: treq(kind="x", qos="x", arrival_cycle=0, payload={}, deadline_cycles=0),
            lambda: trace(name="", seed=0, requests=()),
            lambda: trace.from_json({"schema": "other", "name": "n", "seed": 0, "requests": []}),
            lambda: trace.from_json({"version": 99, "name": "n", "seed": 0, "requests": []}),
        ]
        out = []
        for make in bad:
            with pytest.raises(ValueError) as exc:
                make()
            out.append(str(exc.value))
        out.append(tmod.validate_payload("x", {"any": 1}))
        return out

    assert errors(ttrace, TraceRequest, Trace) == errors(jtrace, JTraceRequest, JTrace)
    r = TraceRequest.from_json({"kind": "lm", "arrival_cycle": 5,
                                "payload": {"prompt_len": 2, "max_new": 3}})
    assert r.qos == "lm" and r.to_json() == JTraceRequest.from_json(r.to_json()).to_json()


# ----------------------------------------------------------- materializers


@pytest.mark.parametrize("name", TRACES)
def test_materialized_payloads_equal_the_reference(name):
    """Every request of the committed trace: the same prompt tokens and the
    same phantom image, bit for bit, and the same submit keywords."""
    trace = Trace.load(_path(name))
    mats = {"lm": lm_materializer(512), "seg": seg_materializer(4)}
    jmats = {"lm": jlm_materializer(512), "seg": jseg_materializer(4)}
    for i, treq in enumerate(trace.requests):
        got, kw = mats[treq.kind](treq, trace.seed, i)
        want, jkw = jmats[treq.kind](treq, trace.seed, i)
        assert kw == jkw
        assert got.dtype == np.asarray(want).dtype and np.array_equal(got, np.asarray(want))
        if treq.kind == "seg":
            assert got.shape == (treq.payload["h"], treq.payload["w"], 4)


# --------------------------------------------------------- streamed replay


class CostAdapter:
    """Payload spec ``{"cost": c}``: c cycles in 1,000-cycle steps."""

    obs_enabled = False
    obs_sink = None

    def __init__(self, kind):
        self.kind, self.total_ops, self._left, self._g = kind, 0, {}, {}

    def prepare(self, payload, *, rid):
        return int(payload.get("cost", 1_500 + 10 * payload.get("h", 0)))

    def free_slots(self):
        return 4 - len(self._left)

    def estimate_cycles(self, payload):
        return payload

    def verify_info(self):
        return None

    def admit(self, greq):
        self._left[greq.rid], self._g[greq.rid] = greq.payload, greq
        return 0

    def has_work(self, qos=None):
        return any(qos is None or self._g[r].qos == qos for r in self._left)

    def work(self, budget, qos=None, force=False, soft_limit=None):
        used, done = 0, []
        for rid in [r for r in self._left if qos is None or self._g[r].qos == qos]:
            while self._left[rid] and (used + 1_000 <= budget or (force and not used)):
                if soft_limit is not None and used >= soft_limit:
                    break
                force = False
                step = min(1_000, self._left[rid])
                self._left[rid] -= step
                used += step
                self.total_ops += step
            if not self._left[rid]:
                del self._left[rid]
                done.append((self._g.pop(rid), used))
        return used, done, []


def test_replay_stream_equals_the_reference():
    """A lazy diurnal feed streamed through each package's gateway: the
    same summary, event bytes and stats."""
    out = []
    for mod, gw_cls, sink in ((diurnal, Gateway, events.RecordingSink()),
                              (jdiurnal, JGateway, jevents.RecordingSink())):
        feed = [(c, "lm" if k == "lm" else "seg", p if k == "seg" else {"cost": 2_500}, kw)
                for c, k, p, kw in mod.stream_requests(_feeds(mod), until=9_600_000)]
        gw = gw_cls([CostAdapter("lm"), CostAdapter("seg")], policy="fair", round_budget=800_000,
                    shares={"interactive": 0.6, "seg": 0.3}, sink=sink)
        summary = (replay_stream if gw_cls is Gateway else jreplay_stream)(gw, iter(feed),
                                                                            label="day")
        out.append((summary, sink.canonical_bytes(), gw.stats()))
    assert out[0] == out[1]
    assert out[0][0]["stream"]["n_requests"] > 20 and out[0][0]["overall"]["completed"] > 20


# ------------------------------------------------------ the rest of events


def test_sinks_equal_the_reference():
    evs = [(0, "submit", dict(rid=0, cycles=5)), (3, "exec", dict(rid=0, cycles=7)),
           (3, "exec", dict(rid=1)), (9, "round", dict(round=0, cycles=0))]
    out = []
    for mod in (events, jevents):
        rec, metrics = mod.RecordingSink(), mod.MetricsSink()
        shard = mod.RecordingSink(etypes={"exec"})
        tee = mod.TeeSink([rec, metrics, mod.NULL_SINK, mod.ShardSink(shard, 2)])
        assert len(tee.sinks) == 3  # the null sink is dropped
        for cycle, etype, data in evs:
            tee.emit(mod.Event(cycle, etype, data))
        out.append((rec.canonical_bytes(), shard.canonical_bytes(), metrics.summary()))
    assert out[0] == out[1]
    assert out[0][2] == dict(counts={"exec": 2, "round": 1, "submit": 1},
                             cycles={"exec": 7, "submit": 5})


def test_payload_spec_equals_the_reference():
    """Specs of the payloads the stack submits, a tensor's included: the
    reference's values, as Python ints."""
    prompt = np.arange(5)
    cases = [
        ("lm", prompt, torch.arange(5), jnp.arange(5), {"max_new": 3}),
        ("lm", Request(rid=0, prompt=prompt, max_new=2), Request(rid=0, prompt=prompt, max_new=2),
         JRequest(rid=0, prompt=prompt, max_new=2), None),
        ("lm", prompt, prompt, prompt, None),
        ("seg", np.zeros((6, 5, 4)), torch.zeros(6, 5, 4), jnp.zeros((6, 5, 4)), None),
        ("seg", {"h": 9, "w": 7, "x": [1]}, {"h": 9, "w": 7, "x": [1]},
         {"h": 9, "w": 7, "x": [1]}, None),
        ("a", 1500.7, 1500.7, 1500.7, None),
        ("a", object(), object(), object(), None),
        ("lm", 5, 5, 5, None),
    ]
    for kind, _, port_payload, ref_payload, kw in cases:
        got = events.payload_spec(kind, port_payload, kw)
        assert got == jevents.payload_spec(kind, ref_payload, kw)
        assert all(type(v) is int for v in got.values())
