"""The port's serving gateway against the JAX reference's.

The gateway, its policies, its round clock and its accounting are host code
on Python ints and floats in both packages, so everything they produce is
compared exactly: the canonical bytes of the event stream
(``RecordingSink.canonical_bytes``), ``stats()``, the replay summary and each
request's lifecycle stamps.

- Synthetic adapters: one duck-typed adapter class (below), instantiated
  once for each package's gateway, with no model in the loop — every policy
  with preemptive and atomic execution, a hypothesis sweep of costs and
  budgets, work stealing (``export_queued``/``import_queued``), plan hot
  swaps and the bounded tile-event window.
- Real adapters: ``traces/gateway_burst.json`` replayed with
  ``benchmarks/gateway.py``'s own setup (the float minitron_4b smoke LM at
  batch 20, the base-8 depth-2 U-Net with its pinned plan), the reference's
  weights carried over with ``params_from_jax``.  The float LM's token
  values are not compared: the reference compiled by plain ``jax.jit``
  skips bf16 roundings its source writes (see ``test_torch_lm.py``), which
  moves near-tie argmaxes; the event bytes hold each request's token count.
  Token values are held exactly on the quantized LM (``mma_int8``, Horner
  route, the reference under ``_exact_jit``), served through an LM
  ``TunedPlan``.  Seg logits agree within ``LOGIT_ATOL``.
- Plan checks at admission: stale-plan rejection and fallback on both
  adapters.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from benchmarks import gateway as jbench
from repro.autotune.calibrate import params_fingerprint as jparams_fingerprint
from repro.autotune.plan import TunedPlan as JTunedPlan
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quant as jquant
from repro.models import transformer as jtransformer
from repro.models import unet as junet
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import clock as jclock
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro.serve import serve_step as jserve_step
from repro.workload import Trace as JTrace
from repro.workload import lm_materializer as jlm_materializer
from repro.workload import replay_trace as jreplay
from repro.workload import seg_materializer as jseg_materializer
from repro_torch.autotune.api import apply_plan_lm
from repro_torch.autotune.calibrate import params_fingerprint
from repro_torch.autotune.plan import TunedPlan
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.models import transformer, unet
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import clock
from repro_torch.serve import engine as tengine
from repro_torch.serve import gateway as tgateway
from repro_torch.workload import Trace, lm_materializer, seg_materializer
from repro_torch.workload import replay_trace as replay

LOGIT_ATOL = 1e-5
TRACE = "traces/gateway_burst.json"
PACKAGES = {"ref": (jgateway, JRecordingSink), "port": (tgateway, RecordingSink)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _np_tree(tree):
    """The reference's leaves as numpy: bf16 as float32 (exact)."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree
    )


def _exact_jit(fn):
    """``fn`` jitted without excess precision or algebraic simplification
    (as ``test_torch_lm.py``), compiled at its first call's shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                {"xla_allow_excess_precision": False, "xla_disable_hlo_passes": "algsimp"}))
        return compiled[0](*args)

    return call


def _exact_engines(adapter):
    """Every engine the reference ``adapter`` builds, now and after
    ``install_fallback``/``install_plan``, decodes through ``_exact_jit``."""
    make = adapter._make_engine

    def exact(cfg):
        eng = make(cfg)
        eng.decode_fn = _exact_jit(jserve_step.make_decode(cfg, eng.batch, eng.max_seq)[0])
        return eng

    adapter._make_engine = exact
    adapter._build(adapter.cfg)
    return adapter


def _lifecycle(gw):
    return [(g.rid, g.kind, g.qos, g.est_cycles, g.deadline, g.arrival, g.admitted, g.finished,
             g.arrival_round, g.admitted_round, g.finished_round) for g in gw.requests]


def _same_run(jgw, tgw):
    """Both gateways produced the same run: event bytes, stats, stamps."""
    jb, tb = jgw.sink.canonical_bytes(), tgw.sink.canonical_bytes()
    if jb != tb:  # name the first line that differs
        for i, (a, b) in enumerate(zip(jgw.sink.lines(), tgw.sink.lines())):
            assert b == a, f"event {i}"
    assert tb == jb
    assert tgw.stats() == jgw.stats()
    assert _lifecycle(tgw) == _lifecycle(jgw)


# ------------------------------------------------------ synthetic adapter

Tile = collections.namedtuple("Tile", "rid tile klass cycles done")


class SynthAdapter:
    """A pure cycle-accounting engine: each request is ``cost`` modeled
    cycles of divisible work, served oldest-admitted-first in ``unit``-cycle
    micro-steps.  ``preemptive=False`` is the atomic path: a quarter of each
    request is charged at admission (like atomic LM prefill) and steps run
    while ``consumed < budget``.  ``tiles`` emits one tile record per step.
    ``params`` are what a plan's fingerprint binds to."""

    obs_enabled = False
    obs_sink = None

    def __init__(self, kind, *, slots=2, unit=1_000, preemptive=True, tiles=False):
        self.kind = kind
        self.slots = slots
        self.unit = unit
        self.preemptive = preemptive
        self.tiles = tiles
        self.params = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(4, np.int8)}
        self.plan = None
        self.installed = []
        self.fallback_reason = None
        self._inflight = {}
        self._remaining = {}
        self._steps = {}
        self.total_ops = 0
        self.exec_log = []

    def prepare(self, payload, *, rid):
        return int(payload)

    def free_slots(self):
        return self.slots - len(self._inflight)

    def estimate_cycles(self, payload):
        return int(payload)

    def verify_info(self):
        return None

    def install_plan(self, plan):
        assert not self.has_work()
        self.plan = plan
        self.installed.append(plan.fingerprint)

    def admit(self, greq):
        assert self.free_slots() > 0
        greq.handle = greq
        self._inflight[greq.rid] = greq
        charge = 0 if self.preemptive else greq.payload // 4
        self._remaining[greq.rid] = greq.payload - charge
        self._steps[greq.rid] = 0
        self.total_ops += charge
        return charge

    def has_work(self, qos=None):
        return any(qos is None or self._inflight[rid].qos == qos for rid in self._remaining)

    def work(self, budget, qos=None, force=False, soft_limit=None):
        consumed, completed, events = 0, [], []
        while True:
            rids = [rid for rid in self._remaining
                    if qos is None or self._inflight[rid].qos == qos]
            if not rids:
                break
            rid = rids[0]
            chunk = min(self.unit, self._remaining[rid])
            if self.preemptive:
                at_soft = soft_limit is not None and consumed >= soft_limit
                if (consumed + chunk > budget or at_soft) and not (force and consumed == 0):
                    break
            elif consumed >= budget:
                break
            force = False
            self._remaining[rid] -= chunk
            consumed += chunk
            self.total_ops += chunk
            if self.obs_enabled:
                self.exec_log.append((rid, self._inflight[rid].qos, chunk, consumed))
            done = self._remaining[rid] == 0
            if self.tiles:
                events.append(Tile(rid, self._steps[rid], self._steps[rid] % 3, chunk, done))
            self._steps[rid] += 1
            if done:
                del self._remaining[rid]
                completed.append((self._inflight.pop(rid), consumed))
        return consumed, completed, events


SHARES = {"a": 0.3, "b": 0.2, "gold": 0.3}


def _synthetic_run(pkg, policy, preemptive):
    """Both adapters, a QoS label on some traffic, explicit and default
    deadlines, a backlog at cycle 0, then mid-round open-loop arrivals."""
    mod, sink = PACKAGES[pkg]
    gw = mod.Gateway(
        [SynthAdapter("a", slots=2, unit=700, preemptive=preemptive, tiles=True),
         SynthAdapter("b", slots=1, unit=1_100, preemptive=preemptive)],
        policy=policy, round_budget=3_000, shares=SHARES, sink=sink(), deadline_factor=3.0,
    )
    for i, cost in enumerate((4_000, 900, 2_500, 6_100, 1_300)):
        gw.submit("a", cost, qos="gold" if i % 2 else None)
    gw.submit("b", 5_000, deadline_cycles=2_000)
    gw.submit("b", 800)
    gw.step_round()
    arrivals = [(gw.clock + 400, "b", 1_700, {}), (gw.clock + 1_900, "a", 2_200, {"qos": "gold"}),
                (gw.clock + 2_950, "a", 300, {"deadline_cycles": 100})]
    gw.step_round(arrivals=arrivals)
    gw.advance_to(gw.clock + 2 * gw.round_budget)
    gw.drain(max_rounds=200)
    return gw


@pytest.mark.parametrize("preemptive", [True, False])
@pytest.mark.parametrize("policy", ["fifo", "fair", "edf"])
def test_synthetic_policies_equal_the_reference(policy, preemptive):
    jgw = _synthetic_run("ref", policy, preemptive)
    tgw = _synthetic_run("port", policy, preemptive)
    _same_run(jgw, tgw)
    assert all(g.done for g in tgw.requests)
    etypes = {e.etype for e in tgw.sink.events}
    assert {"submit", "admit", "exec", "tile", "complete", "round"} <= etypes
    assert ("grant" in etypes) == (policy == "fair")


@given(
    st.lists(st.integers(100, 5_000), min_size=1, max_size=12),
    st.lists(st.integers(100, 5_000), min_size=1, max_size=12),
    st.integers(500, 4_000),
    st.sampled_from(["fifo", "fair", "edf"]),
    st.sampled_from([True, False]),
    st.sampled_from([500, 2_000, 6_000]),
)
@settings(max_examples=40, deadline=None)
def test_synthetic_sweep_equals_the_reference(costs_a, costs_b, budget, policy, preemptive,
                                               unit):
    """The sweep of ``test_gateway.py::test_fair_share_never_starves_a_class``
    over every policy, both execution modes and micro-steps up to larger
    than a round: the same run in both packages, the starvation escape's
    forced overdraft steps included."""
    runs = []
    for pkg in ("ref", "port"):
        mod, sink = PACKAGES[pkg]
        gw = mod.Gateway(
            [SynthAdapter("a", slots=2, unit=unit, preemptive=preemptive),
             SynthAdapter("b", slots=2, unit=unit, preemptive=preemptive)],
            policy=policy, round_budget=budget, sink=sink(),
        )
        for c in costs_a:
            gw.submit("a", c)
        for c in costs_b:
            gw.submit("b", c)
        gw.drain(max_rounds=10_000)
        runs.append(gw)
    _same_run(*runs)
    assert all(g.done for g in runs[1].requests)


def test_work_stealing_equals_the_reference():
    """``export_queued`` from one gateway into another (re-keyed rids, the
    original arrival stamp travelling), both drained: each side's events and
    stats equal the reference's, and a foreign kind or class is refused."""
    runs = {}
    for pkg in ("ref", "port"):
        mod, sink = PACKAGES[pkg]
        donor = mod.Gateway([SynthAdapter("a", slots=1)], policy="fair", round_budget=2_000,
                            shares={"a": 0.5, "gold": 0.5}, sink=sink())
        thief = mod.Gateway([SynthAdapter("a", slots=2)], policy="edf", round_budget=2_000,
                            shares={"a": 0.5, "gold": 0.5}, sink=sink())
        for i in range(6):
            donor.submit("a", 1_500 + 100 * i, qos="gold" if i % 3 == 0 else None)
        donor.step_round()
        thief.step_round()
        moved = donor.export_queued(3)
        assert [g.rid for g in moved] == [3, 4, 5] and len(donor.queue) == 2
        thief.import_queued(moved)
        assert [g.rid for g in moved] == [0, 1, 2]
        with pytest.raises(ValueError, match="not served here"):
            mod.Gateway([SynthAdapter("b")]).import_queued(moved)
        with pytest.raises(ValueError, match="undeclared"):
            mod.Gateway([SynthAdapter("a")]).import_queued(moved)
        donor.drain()
        thief.drain()
        runs[pkg] = (donor, thief)
    for j, t in zip(runs["ref"], runs["port"]):
        _same_run(j, t)
    assert {"export", "import"} <= {e.etype for g in runs["port"] for e in g.sink.events}


class _Plan:
    def __init__(self, fingerprint, params_fingerprint):
        self.fingerprint = fingerprint
        self.params_fingerprint = params_fingerprint


def test_plan_hot_swap_equals_the_reference():
    """``swap_plan``: a stale plan is refused at once naming both
    fingerprints; a fresh one holds admission to its kind while requests
    drain and installs at the first idle round boundary.  The served
    fingerprint of numpy weights is the reference's digest."""
    fp = jparams_fingerprint(SynthAdapter("a").params)
    assert params_fingerprint(SynthAdapter("a").params) == fp
    runs = []
    for pkg in ("ref", "port"):
        mod, sink = PACKAGES[pkg]
        a, b = SynthAdapter("a", slots=1), SynthAdapter("b", slots=1)
        gw = mod.Gateway([a, b], policy="fifo", round_budget=2_000, sink=sink())
        with pytest.raises(mod.StalePlanError, match="0" * 64):
            gw.swap_plan("a", _Plan("s" * 64, "0" * 64))
        with pytest.raises(ValueError, match="unknown kind"):
            gw.swap_plan("zzz", _Plan("s" * 64, fp))
        for cost in (3_000, 2_000):
            gw.submit("a", cost)
        gw.submit("b", 1_000)
        gw.step_round()
        gw.swap_plan("a", _Plan("p" * 64, fp))  # 'a' is busy: held
        late = gw.submit("a", 500)
        gw.step_round()
        assert a.installed == [] and not late.admitted_round
        gw.drain()
        assert a.installed == ["p" * 64] and late.done
        assert late.admitted_round >= gw.plan_swaps[0]["round"]
        runs.append(gw)
    _same_run(*runs)
    assert {"swap-hold", "swap-inst"} <= {e.etype for e in runs[1].sink.events}


def test_bounded_tile_events_equal_the_reference():
    seen = {}
    runs = []
    for pkg in ("ref", "port"):
        mod, sink = PACKAGES[pkg]
        seen[pkg] = []
        gw = mod.Gateway([SynthAdapter("a", slots=2, tiles=True)], policy="fair",
                         round_budget=4_000, max_kept_events=3, on_event=seen[pkg].append,
                         sink=sink())
        gw.submit("a", 4_000)
        gw.submit("a", 4_000)
        gw.drain(max_rounds=50)
        assert list(gw.tile_events) == seen[pkg][-3:]
        runs.append(gw)
        with pytest.raises(ValueError):
            mod.Gateway([SynthAdapter("a")], max_kept_events=0)
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 8
    _same_run(*runs)
    st_ = runs[1].stats()
    assert (st_["tile_events_seen"], st_["tile_events_kept"], st_["tile_events_dropped"]) == (8, 3, 5)


def test_validation_messages_equal_the_reference():
    def errors(mod):
        out = []
        for make in (lambda: mod.Gateway([SynthAdapter("a")], policy="lifo"),
                     lambda: mod.Gateway([]),
                     lambda: mod.Gateway([SynthAdapter("a")], round_budget=0),
                     lambda: mod.Gateway([SynthAdapter("a")], on_stale="ignore"),
                     lambda: mod.Gateway([SynthAdapter("a"), SynthAdapter("b")],
                                         shares={"a": 0.9, "b": 0.9}),
                     lambda: mod.Gateway([SynthAdapter("a")], shares={"a": 1.0}).submit("a", 1, qos="x"),
                     lambda: mod.Gateway([SynthAdapter("a")]).submit("zzz", 1),
                     lambda: mod.Gateway([SynthAdapter("a")]).step_round([(10**9, "a", 1, {})])):
            with pytest.raises(ValueError) as exc:
                make()
            out.append(str(exc.value))
        gw = mod.Gateway([SynthAdapter("a", slots=1)], policy="fair_share", round_budget=10)
        gw.submit("a", 10**6)
        with pytest.raises(RuntimeError, match="did not drain"):
            gw.drain(max_rounds=3)
        return out + [gw.policy]

    assert errors(tgateway) == errors(jgateway)


# ------------------------------------------------------------- the clock


def test_clock_equals_the_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        vals = rng.normal(size=n).tolist()
        for pct in (0, 1, 50, 99, 99.9, 100):
            assert clock.exact_percentile(vals, pct) == jclock.exact_percentile(vals, pct)
    clocks = []
    for mod, sink in ((jclock, JRecordingSink()), (clock, RecordingSink())):
        c = mod.RoundClock()
        c.obs = sink
        for r in range(3):
            c.begin_round()
            c.record_spent(100 * r)
            c.record_work(250 + r, "x" if r % 2 else None)
            c.record_work(40, "y")
            c.idle_to(900)
            c.end_round(1_000)
        ledger = mod.FleetLedger(2)
        ledger.record_round(0, d_ops=5, d_worked=c.worked_total,
                            d_class_worked=c.class_worked_total)
        ledger.record_round(1, d_ops=0, d_worked=0)
        with pytest.raises(ValueError):
            ledger.record_round(1, d_ops=-1, d_worked=0)
        with pytest.raises(ValueError):
            mod.FleetLedger(0)
        clocks.append((c.snapshot(), sink.canonical_bytes(),
                       ledger.additivity([5, 0], [c, mod.RoundClock()])))
    assert clocks[1] == clocks[0]
    assert clocks[1][2]["holds"]


# ------------------------------------------------------- real adapters


@pytest.fixture(scope="module")
def bench_models():
    """``benchmarks/gateway.py``'s models for the committed trace, in both
    packages: the reference's weights and pinned plan carried over."""
    trace = JTrace.load(TRACE)
    lm_cfg, lm_params, seg_cfg, seg_params, plan = jbench._build_models(trace)
    port = (
        get_smoke_config("minitron_4b"),
        transformer.params_from_jax(_np_tree(lm_params), device="cpu"),
        unet.UNetConfig(hw=seg_cfg.hw, in_ch=seg_cfg.in_ch, base=seg_cfg.base,
                        depth=seg_cfg.depth, convs_per_stage=seg_cfg.convs_per_stage,
                        n_classes=seg_cfg.n_classes, quant_mode="mma_int8",
                        plane_schedule=seg_cfg.plane_schedule),
        unet.params_from_jax(_np_tree(seg_params), device="cpu"),
        TunedPlan.from_json(plan.to_json()),
    )
    return (lm_cfg, lm_params, seg_cfg, seg_params, plan), port


def _bench_gateway(pkg, models):
    """The bench's headline configuration: fair, preemptive, traced."""
    mod, sink = PACKAGES[pkg]
    lm_cfg, lm_params, seg_cfg, seg_params, plan = models
    dev = {} if pkg == "ref" else {"device": "cpu"}
    return mod.Gateway(
        [mod.LMAdapter(lm_cfg, lm_params, batch=jbench.LM_BATCH, max_seq=jbench.LM_MAX_SEQ, **dev),
         mod.SegAdapter(seg_cfg, seg_params, plan=plan, batch=4, max_active=2, **dev)],
        policy="fair", round_budget=jbench.ROUND_BUDGET,
        shares=dict(JTrace.load(TRACE).meta["shares"]), sink=sink(),
    )


def test_bench_replay_equals_the_reference(bench_models):
    """All of ``gateway_burst`` in the bench's configuration: the same
    events byte for byte (engine micro-steps included), stats, replay
    summary and per-request token counts; seg logits within 1e-5."""
    jmodels, tmodels = bench_models
    jgw = _bench_gateway("ref", jmodels)
    jsum = jreplay(jgw, JTrace.load(TRACE), {"lm": jlm_materializer(jmodels[0].vocab),
                                             "seg": jseg_materializer(jmodels[2].in_ch)},
                   max_rounds=10_000)
    tgw = _bench_gateway("port", tmodels)
    tsum = replay(tgw, Trace.load(TRACE), {"lm": lm_materializer(tmodels[0].vocab),
                                           "seg": seg_materializer(tmodels[2].in_ch)},
                  max_rounds=10_000)
    _same_run(jgw, tgw)
    assert tsum == jsum
    assert tsum["forced"] == 0 and tsum["trace"]["n_requests"] == 35
    assert {"lm-prefill", "lm-step", "seg-batch", "tile", "exec"} <= \
        {e.etype for e in tgw.sink.events}
    lm = [(t, j) for t, j in zip(tgw.requests, jgw.requests) if t.kind == "lm"]
    assert [len(t.handle.out) for t, _ in lm] == [len(j.handle.out) for _, j in lm]
    assert all(len(t.handle.out) == t.handle.max_new for t, _ in lm)
    seg = [(t, j) for t, j in zip(tgw.requests, jgw.requests) if t.kind == "seg"]
    assert len(seg) == 3
    for t, j in seg:
        np.testing.assert_allclose(t.handle.result.logits, np.asarray(j.handle.result.logits),
                                   atol=LOGIT_ATOL, rtol=0)
        assert (t.handle.result.cycles, t.handle.result.pj) == \
            (j.handle.result.cycles, j.handle.result.pj)
    # what benchmarks/gateway.py reconciles through obs.spans: the exec
    # attribution sums to the round clock's worked cycles exactly
    exec_cycles = sum(e.data["cycles"] for e in tgw.sink.events if e.etype == "exec")
    assert exec_cycles == tgw.round_clock.worked_total > 0


# ------------------------------------------- the quantized LM, exact tokens


def _qlm():
    """The minitron_4b smoke LM on the int8 datapath (``w_q`` leaves where
    both dims >= 128, the other linears through ``mma_linear``)."""
    jcfg = jget_smoke_config("minitron_4b").replace(quant=JQuantConfig(mode="mma_int8"))
    jqp = jquant.quantize_params_int8(
        jtransformer.init_params(jax.random.PRNGKey(0), jcfg), min_dim=128)
    tcfg = get_smoke_config("minitron_4b").replace(quant=QuantConfig(mode="mma_int8"))
    return jcfg, jqp, tcfg, transformer.params_from_jax(_np_tree(jqp), device="cpu")


@pytest.fixture(scope="module")
def qlm():
    return _qlm()


def _lm_plan(cls, fingerprint, planes=(6, 5)):
    return cls(workload="lm", geometry={}, planes=planes, target_rel_err=0.05,
               certificate={}, fingerprint="f" * 64, params_fingerprint=fingerprint)


def test_quantized_replay_token_streams_equal_the_reference(qlm):
    """The trace's 32 LM requests on the quantized LM, served through an LM
    plan (``apply_plan_lm``): the reference under ``_exact_jit`` on its
    Horner route (``impl='xla'``), the port on its (``impl='horner'``),
    which quantizes activations per row, so each slot's tokens are its own.
    Every token stream is equal, as are the events and stats."""
    jcfg, jqp, tcfg, tqp = qlm
    fp = jparams_fingerprint(jqp)
    assert params_fingerprint(tqp) == fp  # bf16 leaves hash as the reference's
    full = JTrace.load(TRACE)
    lm_only = dict(name=full.name, seed=full.seed, meta=full.meta,
                   requests=[r for r in full.requests if r.kind == "lm"])
    shares = {"interactive": 0.4, "batch": 0.3}
    ja = _exact_engines(jgateway.LMAdapter(jcfg, jqp, batch=20, max_seq=32,
                                           plan=_lm_plan(JTunedPlan, fp)))
    ta = tgateway.LMAdapter(tcfg, tqp, batch=20, max_seq=32, plan=_lm_plan(TunedPlan, fp),
                            device="cpu")
    assert ta.cfg.quant.plane_schedule == ja.cfg.quant.plane_schedule == (6, 5)
    assert ta.engine.device == torch.device("cpu") and ta._step_cycles == ja._step_cycles
    jgw = jgateway.Gateway([ja], policy="fair", round_budget=800_000, shares=shares,
                           sink=JRecordingSink())
    jsum = jreplay(jgw, JTrace(**lm_only), {"lm": jlm_materializer(jcfg.vocab)})
    tgw = tgateway.Gateway([ta], policy="fair", round_budget=800_000, shares=shares,
                           sink=RecordingSink())
    tsum = replay(tgw, Trace(**lm_only), {"lm": lm_materializer(tcfg.vocab)})
    _same_run(jgw, tgw)
    assert tsum == jsum
    streams = [g.handle.out for g in tgw.requests]
    assert len(streams) == 32 and sum(map(len, streams)) == 208
    assert streams == [g.handle.out for g in jgw.requests]


def test_lm_plan_installation_equals_the_reference(qlm):
    jcfg, jqp, tcfg, _ = qlm
    from repro.autotune.api import apply_plan_lm as japply_plan_lm

    plan, jplan = _lm_plan(TunedPlan, "x"), _lm_plan(JTunedPlan, "x")
    got, want = apply_plan_lm(tcfg, plan), japply_plan_lm(jcfg, jplan)
    assert (got.quant.mode, got.quant.plane_schedule) == (want.quant.mode, want.quant.plane_schedule)
    got, want = tengine.lm_schedule_from_plan(plan, tcfg), jengine.lm_schedule_from_plan(jplan, jcfg)
    assert (got.planes, got.target_rel_err, got.layer_bounds) == \
        (want.planes, want.target_rel_err, want.layer_bounds) == ((6, 5), 0.05, None)
    unet_plan = dataclasses.replace(plan, workload="unet", tile=28, halo=12,
                                    geometry=dict(depth=2, convs_per_stage=1))
    with pytest.raises(ValueError, match="cannot apply"):
        apply_plan_lm(tcfg, unet_plan)
    with pytest.raises(ValueError, match="LM TunedPlan"):
        tengine.lm_schedule_from_plan(unet_plan, tcfg)
    with pytest.raises(ValueError, match="layers"):
        tengine.lm_schedule_from_plan(_lm_plan(TunedPlan, "x", planes=(6,)), tcfg)


# ------------------------------------------- plan checks at admission


def test_lm_stale_plan_rejected_and_fallback_equal_the_reference(qlm):
    """A hand-built LM plan bound to other weights: ``reject`` refuses the
    submission with the reference's message (both fingerprints named);
    ``fallback`` rebuilds the engine on the uniform 8-plane schedule and
    serves the request to the same tokens and events."""
    jcfg, jqp, tcfg, tqp = qlm
    stale = "0" * 64
    msgs = []
    for mod, cfg, params, plan_cls, dev in ((jgateway, jcfg, jqp, JTunedPlan, {}),
                                            (tgateway, tcfg, tqp, TunedPlan, {"device": "cpu"})):
        gw = mod.Gateway([mod.LMAdapter(cfg, params, batch=2, max_seq=16,
                                        plan=_lm_plan(plan_cls, stale), **dev)],
                         policy="fifo", on_stale="reject")
        with pytest.raises(mod.StalePlanError) as exc:
            gw.submit("lm", np.arange(3))
        assert not gw.requests
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
    assert stale in msgs[1] and params_fingerprint(tqp) in msgs[1]

    runs = []
    prompts = np.random.default_rng(5).integers(0, 512, (3, 4))
    for pkg, cfg, params, plan_cls, dev in (("ref", jcfg, jqp, JTunedPlan, {}),
                                            ("port", tcfg, tqp, TunedPlan, {"device": "cpu"})):
        mod, sink = PACKAGES[pkg]
        adapter = mod.LMAdapter(cfg, params, batch=2, max_seq=16,
                                plan=_lm_plan(plan_cls, stale), **dev)
        if pkg == "ref":
            _exact_engines(adapter)
        gw = mod.Gateway([adapter], policy="fair", on_stale="fallback",
                         round_budget=200_000, sink=sink())
        reqs = [gw.submit("lm", p, max_new=3) for p in prompts]
        gw.drain()
        assert adapter.plan is None and "stale" in adapter.fallback_reason
        assert adapter.cfg.quant.plane_schedule is None and adapter.cfg.quant.planes == 8
        assert all(len(r.handle.out) == 3 for r in reqs)
        runs.append((gw, [r.handle.out for r in reqs]))
    _same_run(runs[0][0], runs[1][0])
    assert runs[1][1] == runs[0][1]
    assert "lm" in runs[1][0].stats()["fallbacks"]


@pytest.fixture(scope="module")
def small_unet():
    jcfg = junet.UNetConfig(hw=32, in_ch=2, base=4, depth=2, convs_per_stage=1, n_classes=3,
                            quant_mode="mma_int8", impl="xla")
    jparams = junet.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = unet.UNetConfig(hw=32, in_ch=2, base=4, depth=2, convs_per_stage=1, n_classes=3,
                           quant_mode="mma_int8")
    return jcfg, jparams, tcfg, unet.params_from_jax(_np_tree(jparams), device="cpu")


def _unet_plan(cls, fingerprint):
    return cls(workload="unet", geometry=dict(depth=2, convs_per_stage=1), planes=(6,) * 5,
               target_rel_err=0.1, certificate=dict(cert=0.05), fingerprint="f" * 64,
               params_fingerprint=fingerprint, tile=28, halo=12)


def test_seg_stale_plan_rejected_and_fallback_equal_the_reference(small_unet):
    """The seg side, as ``test_gateway.py`` drives it: a stale plan is
    refused with the reference's message; under ``fallback`` the adapter
    quarantines it and serves the uniform 8-plane schedule at the smallest
    viable tile, to the reference's logits and events; a fresh plan serves."""
    jcfg, jparams, tcfg, tparams = small_unet
    fp = jparams_fingerprint(jparams)
    assert params_fingerprint(tparams) == fp
    img = np.linspace(0, 1, 32 * 32 * 2, dtype=np.float32).reshape(32, 32, 2)
    msgs, runs = [], []
    for pkg, cfg, params, plan_cls, dev in (("ref", jcfg, jparams, JTunedPlan, {}),
                                            ("port", tcfg, tparams, TunedPlan, {"device": "cpu"})):
        mod, sink = PACKAGES[pkg]
        gw = mod.Gateway([mod.SegAdapter(cfg, params, plan=_unet_plan(plan_cls, "0" * 64),
                                         batch=2, **dev)], policy="fifo")
        with pytest.raises(mod.StalePlanError) as exc:
            gw.submit("seg", img)
        msgs.append(str(exc.value))
        out = []
        for fp_, on_stale in (("0" * 64, "fallback"), (fp, "reject")):
            adapter = mod.SegAdapter(cfg, params, plan=_unet_plan(plan_cls, fp_), batch=2, **dev)
            gw = mod.Gateway([adapter], policy="fair", on_stale=on_stale,
                             round_budget=50_000_000, sink=sink())
            r = gw.submit("seg", img)
            gw.drain()
            assert r.done
            out.append((gw, r.handle.result, adapter))
        fallback = out[0][2]
        assert fallback.plan is None and "stale" in fallback.fallback_reason
        assert fallback.engine.base_schedule.planes == (8,) * 5
        assert fallback.engine.tile == cfg.min_viable_tile()
        assert out[1][2].plan is not None and out[1][0].stats()["fallbacks"] == {}
        runs.append(out)
    assert msgs[1] == msgs[0]
    for (jgw, jres, _), (tgw, tres, _) in zip(*runs):
        _same_run(jgw, tgw)
        np.testing.assert_allclose(tres.logits, np.asarray(jres.logits), atol=LOGIT_ATOL, rtol=0)


def test_adapters_default_to_the_card(qlm, small_unet):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, tcfg, tqp = qlm
    _, _, ucfg, uparams = small_unet
    with pytest.raises(RuntimeError, match="CUDA card"):
        tgateway.LMAdapter(tcfg, tqp, batch=2, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tgateway.SegAdapter(ucfg, uparams, batch=2)
