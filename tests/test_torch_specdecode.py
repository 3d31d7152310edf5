"""The port's precision-speculative decoding and LM tuning against the JAX
reference's.

Model: ``tests/test_specdecode.py``'s 2-layer minitron_4b smoke config on
the int8 MMA datapath (float weights through ``mma_linear``, one activation
scale per batch row: the Horner route, ``impl='horner'`` in the port and
``'xla'`` in the reference), the reference's ``jax.random`` weights carried
over with ``transformer.params_from_jax``.  The reference decodes through
``_exact_jit`` (XLA's excess precision and algebraic simplifier off, as in
``test_torch_lm.py``): under plain ``jax.jit`` it skips bf16 roundings its
source writes, which moves near-tie argmaxes.  ``monkeypatch`` points the
reference's ``shared_decode`` at that build for the whole test, so engines
the reference builds inside its own functions (``tune_spec``,
``SpecLMAdapter``) decode through it too; the reference's files are not
touched.

Held exactly: the port's speculative streams against its greedy ones;
token streams and every ``spec_trace`` record against the reference's up
to its first near tie (the identity sweep) or throughout, the config
rejections' messages, ``lm_spec_step_cycles``, gateway event bytes,
``stats()`` and lifecycle stamps, ``tune_spec`` grids, ``obs.spans`` on the
same events, and the bench twin's blocks.  ``tune_lm``'s planes and repairs
are held to the reference's repair loop replayed with each forward under
``_exact_jit``, its ``measured_rel_err`` and ``cert`` within 1e-5.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from benchmarks import specdecode as jbench
from repro import models as jmodels
from repro.autotune import api as japi
from repro.autotune.calibrate import params_fingerprint as jparams_fingerprint
from repro.autotune.plan import TunedPlan as JTunedPlan
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import cycle_model as jcm
from repro.obs import spans as jspans
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro.serve import serve_step as jserve_step
from repro.serve import specdecode as jspec
from repro.serve.modeled import ModeledLMAdapter, ModeledSegAdapter, modeled_materializer
from repro.workload import Trace as JTrace
from repro.workload import replay_trace as jreplay
from repro_torch import autotune
from repro_torch.autotune.calibrate import params_fingerprint
from repro_torch.autotune.plan import TunedPlan
from repro_torch.bench import specdecode as tbench
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import cycle_model as cm
from repro_torch.core import quant
from repro_torch.models import transformer
from repro_torch.obs import spans
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Gateway, Request, SpecEngine, SpecLMAdapter
from repro_torch.serve import engine as tengine

if HAVE_HYPOTHESIS:
    from hypothesis import example
else:
    def example(**kw):
        """The shim's stand-in for ``hypothesis.example`` (applied below
        ``@given``): the example runs before the first drawn one."""
        def deco(fn):
            ran = []

            @functools.wraps(fn)
            def with_example(*args, **kwargs):
                if not ran:
                    ran.append(True)
                    fn(**kw)
                return fn(*args, **kwargs)
            return with_example
        return deco

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Decode logits against the reference's, relative to the call's largest
# logit: the tolerance of test_torch_gpu.py's card-vs-CPU engine test and of
# the other families' port tests.  The two packages' RMSNorm can round a row
# one bf16 ulp apart (XLA's CPU rsqrt is an approximation, and its float32
# mean sums in another order); after int8 requantization that is about 0.01.
LOGIT_REL = 0.05
BATCH = 2
MAX_SEQ = 24
# tests/test_specdecode.py's pool of draft schedules
DRAFT_SCHEDULES = ((1, 1), (2, 2), (4, 4), (2, 6))
TUNE_LM_TOL = 1e-5


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


@functools.lru_cache(maxsize=None)
def _exact_decode(cfg, batch, max_seq):
    """The reference's ``shared_decode`` under ``_exact_jit``: one build per
    signature, shared like the reference's own cache."""
    return _exact_jit(jserve_step.make_decode(cfg, batch, max_seq)[0])


@pytest.fixture(autouse=True, scope="module")
def _exact_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "shared_decode", _exact_decode)
        mp.setattr(jspec, "shared_decode", _exact_decode)
        yield


def _jcfg():
    cfg = jget_smoke_config("minitron_4b").replace(n_layers=2)
    return cfg.replace(quant=JQuantConfig(mode="mma_int8", planes=8,
                                          plane_schedule=(8,) * cfg.n_layers))


def _tcfg():
    cfg = get_smoke_config("minitron_4b").replace(n_layers=2)
    return cfg.replace(quant=QuantConfig(mode="mma_int8", planes=8,
                                         plane_schedule=(8,) * cfg.n_layers))


@functools.lru_cache(maxsize=None)
def _model():
    """The reference test's model in both packages."""
    jcfg = _jcfg()
    jparams = jmodels.build(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, _tcfg(), transformer.params_from_jax(_np_tree(jparams), device="cpu")


def _prompts(seed, vocab, n=2, length=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length).astype(np.int32) for _ in range(n)]


def _drain(eng, req_cls, prompts, max_new, spec, calls=None):
    """Serve ``prompts`` to completion; the token streams.  With ``calls``
    (a list), every decode call the engine makes (prefill, step, draft,
    verify) appends ``(logits, draft, streams, rounds, consumed)``: the last
    position's logits of every row as float32 numpy, whether it is a draft
    call, the streams and the count of ``spec_trace`` records before the
    call, and the rows whose argmax the engine reads from this call."""
    pending = [req_cls(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    reqs = list(pending)
    if calls is not None:
        _record_calls(eng, reqs, calls)
    while pending or eng.ready_slots():
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        if not eng.ready_slots():
            break
        eng.spec_step() if spec else eng.step()
    return [list(r.out) for r in reqs]


def _consumed_rows(eng):
    """The rows whose argmax the engine reads from its next decode call: in
    a prefill call (``admit`` prefills a whole prompt before any step) the
    prefilling slot's row at its last prompt token, else none; in a step,
    draft or verify call every active slot's row."""
    active = eng.slots.active()
    filling = [(i, r) for i, r in active if not r.ready]
    if filling:
        return [i for i, r in filling if r.prefill_pos == len(r.prompt) - 1]
    return [i for i, _ in active]


def _record_calls(eng, reqs, calls):
    def recording(fn, draft):
        def call(params, toks, cache, index, extras):
            before = ([list(r.out) for r in reqs], len(getattr(eng, "spec_trace", ())),
                      _consumed_rows(eng))
            logits, cache = fn(params, toks, cache, index, extras)
            last = logits[:, -1]
            last = (last.to(torch.float32).numpy() if isinstance(last, torch.Tensor)
                    else np.asarray(last.astype(jnp.float32)))
            calls.append((last, draft) + before)
            return logits, cache
        return call

    eng.decode_fn = recording(eng.decode_fn, False)
    if hasattr(eng, "draft_fn"):
        eng.draft_fn = recording(eng.draft_fn, True)


def _greedy(prompts, max_new=8):
    _, _, tcfg, tparams = _model()
    eng = Engine(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ, device="cpu")
    return _drain(eng, Request, prompts, max_new, spec=False)


def _spec_runs(prompts, sched, k, max_new=8):
    """The reference's and the port's ``SpecEngine`` on ``prompts``:
    ``[(streams, spec_trace, calls)]`` for each (``calls`` as ``_drain``
    records them)."""
    jcfg, jparams, tcfg, tparams = _model()
    runs = []
    for eng, req_cls in (
        (jspec.SpecEngine(jcfg, jparams, batch=BATCH, max_seq=MAX_SEQ, draft_schedule=sched,
                          k=k), jengine.Request),
        (SpecEngine(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ, draft_schedule=sched, k=k,
                    device="cpu"), Request),
    ):
        calls = []
        streams = _drain(eng, req_cls, prompts, max_new, spec=True, calls=calls)
        runs.append((streams, eng.spec_trace, calls))
    return runs


def _near_tie(logits, row) -> bool:
    """A top-2 margin of at most ``LOGIT_REL`` of the call's largest logit."""
    top2 = np.sort(logits[row])[-2:]
    return bool(top2[1] - top2[0] <= LOGIT_REL * np.abs(logits).max())


# --------------------------------------------------------------- identity


@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10**6),
    sched=st.sampled_from(DRAFT_SCHEDULES),
    k=st.integers(min_value=1, max_value=3),
)
@example(seed=256000, sched=(1, 1), k=1)
def test_spec_streams_and_traces_equal_the_reference(seed, sched, k):
    """``tests/test_specdecode.py``'s identity sweep, in both packages.

    The port's speculative streams equal the port's greedy streams exactly
    (the spec invariant).  Against the reference, call by call, up to the
    first call at which the reference has a near tie (a top-2 margin within
    ``LOGIT_REL`` of the call's largest logit) on a row the engine reads:
    the same streams and ``spec_trace`` records before the call and its
    logits within ``LOGIT_REL``.  Past that call the same holds for every
    full-precision call (prefill, verify) as long as the engines read the
    same argmaxes, and a full-precision call may part from the reference
    only at a near tie.  Their RMSNorm's float32 ``rsqrt`` differs by an
    ulp on some rows (XLA's CPU ``rsqrt`` is an approximation): one bf16
    ulp after rounding, about 0.01 of the largest logit after int8
    requantization.  A draft call at 1-2 planes can turn that ulp into a
    whole plane of an activation (0.19 of the largest logit measured), so
    past the first near tie its logits are not bounded, and the
    comparison ends where its drafts part.  Where nothing parts,
    everything is equal."""
    prompts = _prompts(seed, 512)
    (jstreams, jtrace, jcalls), (tstreams, ttrace, tcalls) = _spec_runs(prompts, sched, k)
    assert tstreams == _greedy(prompts)
    for rec in ttrace:
        assert 1 <= rec["k"] <= k
        for s in rec["slots"]:
            assert 0 <= s["accepted"] <= rec["k"]
            assert 1 <= s["emitted"] <= s["accepted"] + 1
        assert rec["drafted"] == rec["k"] * len(rec["slots"])
    first_tie = parted = None
    for n, ((tl, *tbefore), (jl, draft, *jbefore)) in enumerate(zip(tcalls, jcalls)):
        assert tbefore == [draft] + jbefore, f"call {n}: streams, rounds or rows differ before it"
        rows = jbefore[2]
        gap = float(np.abs(tl - jl).max() / np.abs(jl).max())
        if first_tie is None or not draft:
            assert gap <= LOGIT_REL, f"call {n}: logits differ by {gap} of the largest"
        if first_tie is None and any(_near_tie(jl, i) for i in rows):
            first_tie = n
        apart = [i for i in rows if tl[i].argmax() != jl[i].argmax()]
        if apart:
            assert draft or all(_near_tie(jl, i) for i in apart), \
                f"call {n}: rows {apart} part from the reference without a near tie"
            parted = n
            break
    if parted is None:
        assert len(tcalls) == len(jcalls)
        assert tstreams == jstreams
        assert ttrace == jtrace
    else:
        assert ttrace[:jcalls[parted][3]] == jtrace[:jcalls[parted][3]]
    print(f"seed {seed}, draft schedule {sched}, k {k}: {len(jcalls)} decode calls, the "
          f"reference's first near tie at call {first_tie}, the engines part at call {parted}"
          + (" (a draft)" if parted is not None and jcalls[parted][1] else ""))


def test_spec_rollback_leaves_the_greedy_cache():
    """After the last round each slot's length and its live cache rows
    (below its index) equal a greedy engine's bit for bit: draft rows
    above the index were overwritten before anything read them."""
    _, _, tcfg, tparams = _model()
    prompts = _prompts(11, 512, n=2, length=4)
    engines = []
    for spec in (False, True):
        eng = (SpecEngine(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ, draft_schedule=(2, 2),
                          k=2, device="cpu") if spec
               else Engine(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ, device="cpu"))
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.admit(r)
        while eng.ready_slots():
            eng.spec_step() if spec else eng.step()
        engines.append((eng, [r.out for r in reqs]))
    (g, gout), (s, sout) = engines
    assert sout == gout
    assert any(rec["accepted"] < rec["drafted"] for rec in s.spec_trace)  # a rollback ran
    assert np.array_equal(s.lengths, g.lengths)
    for i, n in enumerate(g.lengths):
        for key in ("k", "v"):
            assert torch.equal(s.cache[key][:, i, :n], g.cache[key][:, i, :n])


def test_spec_engine_rejects_bad_configs_like_the_reference():
    jcfg, jparams, tcfg, tparams = _model()
    cases = [
        (dict(quant_none=True), dict(draft_schedule=(2, 2), k=2)),
        ({}, dict(draft_schedule=(2,), k=2)),
        ({}, dict(draft_schedule=(2, 9), k=2)),
        ({}, dict(draft_schedule=(2, 0), k=2)),
        ({}, dict(draft_schedule=(2, 2), k=0)),
    ]
    for how, kw in cases:
        msgs = []
        for cls, cfg, params, qcls, dev in (
            (jspec.SpecEngine, jcfg, jparams, JQuantConfig, {}),
            (SpecEngine, tcfg, tparams, QuantConfig, {"device": "cpu"}),
        ):
            if how:
                cfg = cfg.replace(quant=qcls(mode="none"))
            with pytest.raises(ValueError) as exc:
                cls(cfg, params, batch=BATCH, max_seq=MAX_SEQ, **kw, **dev)
            msgs.append(str(exc.value))
        assert msgs[1] == msgs[0], kw


# --------------------------------------------------------- cycle account


@settings(max_examples=25, deadline=None)
@given(
    k=st.integers(min_value=0, max_value=6),
    data=st.data(),
)
def test_spec_cycle_account_equals_the_reference(k, data):
    """``lm_spec_step_cycles`` (the port's copy) equals the reference's on
    every acceptance outcome, draft budget and mode, and closes
    integer-exactly."""
    accepted = data.draw(st.integers(min_value=0, max_value=k))
    draft = data.draw(st.sampled_from(((2, 2, 2, 2), (1, 3, 2, 4), (4,))))
    mode = data.draw(st.sampled_from(("pipelined", "as_printed")))
    kw = dict(k=k, draft_schedule=draft, schedule=(8, 8, 7, 8), accepted=accepted, mode=mode,
              n_heads=4, head_dim=16, n_kv_heads=2, context=32)
    got = cm.lm_spec_step_cycles(64, 128, 4, **kw)
    assert got == jcm.lm_spec_step_cycles(64, 128, 4, **kw)
    assert all(type(v) is int for v in got.values())
    assert got["useful_cycles"] + got["wasted_cycles"] == got["total_cycles"]
    assert got["total_cycles"] == (k * got["draft_step_cycles"] + got["full_step_cycles"]
                                   + k * got["interval_cycles"])


def test_spec_cycle_account_validates_like_the_reference():
    for kw in (dict(k=2, accepted=3), dict(k=-1)):
        msgs = []
        for mod in (jcm, cm):
            with pytest.raises(ValueError) as exc:
                mod.lm_spec_step_cycles(64, 128, 4, draft_schedule=(2,) * 4, **kw)
            msgs.append(str(exc.value))
        assert msgs[1] == msgs[0]


# ------------------------------------------------------- adapter + gateway


def _gateway_run(pkg, prompts, **adapter_kw):
    jcfg, jparams, tcfg, tparams = _model()
    if pkg == "ref":
        mod, cfg, params, sink, dev = jgateway, jcfg, jparams, JRecordingSink(), {}
        adapter = jspec.SpecLMAdapter(cfg, params, batch=BATCH, max_seq=MAX_SEQ, **adapter_kw)
    else:
        mod, cfg, params, sink, dev = None, tcfg, tparams, RecordingSink(), {"device": "cpu"}
        adapter = SpecLMAdapter(cfg, params, batch=BATCH, max_seq=MAX_SEQ, **adapter_kw, **dev)
    gw = (mod.Gateway if mod else Gateway)([adapter], policy="fair", round_budget=60_000,
                                           sink=sink)
    reqs = [gw.submit("lm", p, max_new=8) for p in prompts]
    gw.drain(max_rounds=1_000)
    return gw, adapter, [list(r.handle.out) for r in reqs]


def _lifecycle(gw):
    return [(g.rid, g.kind, g.qos, g.est_cycles, g.deadline, g.arrival, g.admitted, g.finished,
             g.arrival_round, g.admitted_round, g.finished_round) for g in gw.requests]


def test_spec_adapter_through_the_gateway_equals_the_reference():
    """``SpecLMAdapter`` behind ``Gateway`` (fair, preemptive, a round budget
    that preempts rounds): the same event bytes (draft, verify, accept and
    rollback entries of ``obs_log`` among them), ``stats()``, lifecycle
    stamps and streams as the reference; the streams equal greedy's; the
    exec attribution reconciles with the round clock (``obs.spans``), and
    the draft and verify cycles decompose the charged round prices."""
    prompts = _prompts(3, 512, n=3)
    jgw, _, jstreams = _gateway_run("ref", prompts, draft_schedule=(2, 2), k=2)
    tgw, tad, tstreams = _gateway_run("port", prompts, draft_schedule=(2, 2), k=2)
    assert tgw.sink.canonical_bytes() == jgw.sink.canonical_bytes()
    assert tgw.stats() == jgw.stats()
    assert _lifecycle(tgw) == _lifecycle(jgw)
    assert tstreams == jstreams == _greedy(prompts)
    etypes = [e.etype for e in tgw.sink.events]
    assert {"draft", "verify", "accept", "rollback", "lm-spec", "exec"} <= set(etypes)
    assert tgw.rounds > 1 and not tad.obs_log
    rec = spans.reconcile(tgw.sink.events, [tgw.round_clock])
    assert rec == jspans.reconcile(jgw.sink.events, [jgw.round_clock])
    assert rec["holds"] and rec["total_exec"] == tgw.round_clock.worked_total
    spec_cycles = sum(e.data["cycles"] for e in tgw.sink.events if e.etype in ("draft", "verify"))
    charged = sum(len(r["slots"]) * tad._spec_slot_cycles(r["k"]) for r in tad.engine.spec_trace)
    assert spec_cycles == charged <= rec["total_exec"]
    assert spans.breakdown(spans.assemble(tgw.sink.events)) == \
        jspans.breakdown(jspans.assemble(jgw.sink.events))


def _lm_plan(cls, params_fp, **spec_kw):
    return cls(workload="lm", geometry=dict(family="dense", n_layers=2, d_model=128),
               planes=(8, 8), target_rel_err=0.05, certificate=dict(cert=0.0),
               fingerprint="t" * 64, params_fingerprint=params_fp, **spec_kw)


def test_spec_adapter_takes_knobs_from_a_v3_plan():
    """Knobs from the plan's ``spec_planes``/``spec_k``; explicit arguments
    win; neither gives the reference's message."""
    jcfg, jparams, tcfg, tparams = _model()
    fp = jparams_fingerprint(jparams)
    assert params_fingerprint(tparams) == fp
    msgs = []
    for cls, plan_cls, cfg, params, dev in (
        (jspec.SpecLMAdapter, JTunedPlan, jcfg, jparams, {}),
        (SpecLMAdapter, TunedPlan, tcfg, tparams, {"device": "cpu"}),
    ):
        plan = _lm_plan(plan_cls, fp, spec_planes=(2, 2), spec_k=3)
        ad = cls(cfg, params, batch=BATCH, max_seq=MAX_SEQ, plan=plan, **dev)
        assert ad.engine.draft_schedule == (2, 2) and ad.engine.k == 3
        ad = cls(cfg, params, batch=BATCH, max_seq=MAX_SEQ, plan=plan, draft_schedule=(4, 1),
                 k=2, **dev)
        assert ad.engine.draft_schedule == (4, 1) and ad.engine.k == 2
        with pytest.raises(ValueError) as exc:
            cls(cfg, params, batch=BATCH, max_seq=MAX_SEQ, plan=_lm_plan(plan_cls, fp), **dev)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] and "draft_schedule and k" in msgs[1]
    assert ad.engine.device == torch.device("cpu")


def test_spans_equal_the_reference_on_gateway_burst():
    """``traces/gateway_burst.json`` replayed through the reference's gateway
    on its modeled (pricing-only) adapters: the port's ``assemble``,
    ``breakdown`` and ``reconcile`` of that event stream equal the
    reference's."""
    trace = JTrace.load(os.path.join(ROOT, "traces", "gateway_burst.json"))
    sink = JRecordingSink()
    gw = jgateway.Gateway(
        [ModeledLMAdapter.from_config(jget_smoke_config("minitron_4b"), batch=20, max_seq=32),
         ModeledSegAdapter.from_geometry()],
        policy="fair", round_budget=int(trace.meta["round_budget"]),
        shares=dict(trace.meta["shares"]), sink=sink,
    )
    jreplay(gw, trace, {k: modeled_materializer() for k in trace.kinds}, max_rounds=10_000)
    events = sink.events
    got, want = spans.assemble(events), jspans.assemble(events)
    assert len(got) == len(want) == len(trace)
    props = ("done", "admitted_eff", "total", "queued", "executing", "preempted",
             "overdrafted", "missed_deadline", "joules")
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [getattr(a, p) for p in props] == [getattr(b, p) for p in props]
    assert spans.breakdown(got) == jspans.breakdown(want)
    assert spans.breakdown(got, pcts=(90,)) == jspans.breakdown(want, pcts=(90,))
    rec = spans.reconcile(events, [gw.round_clock])
    assert rec == jspans.reconcile(events, [gw.round_clock]) and rec["holds"]


# ---------------------------------------------------------------- tuning


def test_tune_spec_grid_equals_the_reference():
    """The real search on a 2 x 2 grid: every grid entry, the best point,
    the modeled speedup and the v3 fields equal the reference's."""
    jcfg, jparams, tcfg, tparams = _model()
    fp = jparams_fingerprint(jparams)
    kw = dict(batch=BATCH, max_seq=MAX_SEQ, max_new=6, k_candidates=(2, 3),
              plane_candidates=(2, 4))
    prompts = _prompts(11, 512, n=2)
    want = japi.tune_spec(jparams, jcfg, prompts, plan=_lm_plan(JTunedPlan, fp), **kw)
    got = autotune.tune_spec(tparams, tcfg, prompts, plan=_lm_plan(TunedPlan, fp),
                             device="cpu", **kw)
    assert got.modeled == want.modeled
    assert (got.spec_planes, got.spec_k, got.version) == (want.spec_planes, want.spec_k,
                                                          want.version)
    grid = got.modeled["spec"]["grid"]
    assert len(grid) == 4 and all(g["emitted"] == 12 for g in grid)
    assert any(g["accepted"] < g["drafted"] for g in grid)
    with pytest.raises(ValueError, match="extends an LM plan"):
        autotune.tune_spec(tparams, tcfg, [], plan=dataclasses.replace(
            _lm_plan(TunedPlan, fp), workload="unet", tile=28, halo=12,
            geometry=dict(depth=2, convs_per_stage=1)), device="cpu")


def _replayed_tune_lm(params, cfg, tokens, target, slack, margin):
    """The reference's ``tune_lm`` repair loop with each forward under
    ``_exact_jit``: ``(planes, repairs, measured)``."""
    mod = jmodels.build(cfg)
    toks = jnp.asarray(tokens)

    def logits(qcfg):
        fwd = _exact_jit(lambda p, t: mod.forward(p, t, cfg.replace(quant=qcfg)))
        return fwd(params, toks).astype(jnp.float32)

    ref = logits(JQuantConfig(mode="mma_int8", planes=8))
    denom = max(float(jnp.max(jnp.abs(ref))), 1e-8)

    def measured(planes):
        out = logits(JQuantConfig(mode="mma_int8", planes=8, plane_schedule=tuple(planes)))
        return float(jnp.max(jnp.abs(out - ref))) / denom

    seed = jengine.lm_schedule_from_params(params, cfg, target)
    planes, repairs = list(seed.planes), 0
    m = measured(planes)
    while m > slack * target and repairs < 8 * len(planes):
        fixable = [l for l in range(len(planes)) if planes[l] < 8]
        if not fixable:
            break
        bounds = seed.layer_bounds or (0.0,) * len(planes)
        planes[min(fixable, key=lambda l: (planes[l], -bounds[l]))] += 1
        repairs += 1
        m = measured(planes)
    return tuple(planes), repairs, m


@pytest.mark.parametrize("target", [0.2, 0.1])
def test_tune_lm_equals_the_exact_replay(target):
    """``tune_lm`` on the float smoke model: planes and repairs equal the
    reference's loop replayed under ``_exact_jit``, ``measured_rel_err`` and
    ``cert`` within 1e-5; the fingerprints and the certificate's other
    fields equal the reference's own ``tune_lm``.  The reference's own run
    (its forwards under XLA's excess precision) reaches the same planes
    here; its measurement is printed beside the replay's."""
    jcfg, jparams, tcfg, tparams = _model()
    jcfg, tcfg = jcfg.replace(quant=JQuantConfig()), tcfg.replace(quant=QuantConfig())
    tokens = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    got = autotune.tune_lm(tparams, tcfg, tokens, target_rel_err=target, device="cpu")
    c = got.certificate
    planes, repairs, m = _replayed_tune_lm(jparams, jcfg, tokens, target, c["slack"],
                                           c["margin"])
    assert (got.planes, c["repairs"]) == (planes, repairs)
    assert repairs > 0 and min(planes) < 8
    assert abs(c["measured_rel_err"] - m) <= TUNE_LM_TOL
    assert abs(c["cert"] - m * c["margin"]) <= TUNE_LM_TOL
    own = japi.tune_lm(jparams, jcfg, tokens, target_rel_err=target)
    assert (own.planes, own.certificate["repairs"]) == (planes, repairs)
    assert (got.fingerprint, got.params_fingerprint, got.layer_bounds, got.geometry) == \
        (own.fingerprint, own.params_fingerprint, own.layer_bounds, own.geometry)
    for key in ("target_rel_err", "margin", "slack", "n_tokens", "repairs"):
        assert c[key] == own.certificate[key]
    assert c["holds"] == (c["cert"] <= target)
    print(f"tune_lm target {target}: planes {got.planes}, repairs {repairs}; measured_rel_err "
          f"port {c['measured_rel_err']!r}, exact replay {m!r}, reference's own "
          f"{own.certificate['measured_rel_err']!r}")


def test_lm_schedule_from_int8_params_equals_float():
    """On int8 serving params the analytic seed reads the ``w_q`` leaves,
    which are the per-channel int8 values it quantizes float weights to."""
    _, _, tcfg, tparams = _model()
    got = tengine.lm_schedule_from_params(quant.quantize_params_int8(tparams, min_dim=128),
                                          tcfg, 0.05)
    want = tengine.lm_schedule_from_params(tparams, tcfg, 0.05)
    assert (got.planes, got.layer_bounds) == (want.planes, want.layer_bounds)


# ------------------------------------------------------------ bench twin


def test_bench_twin_equals_the_reference_bench(tmp_path):
    """``repro_torch.bench.specdecode.run`` on the reference bench model
    (``_build_model()``'s weights carried over) against
    ``benchmarks/specdecode.py`` run here: every block equal, integers
    exact.  Against the committed ``BENCH_specdecode.json`` the ``plan``
    block (the tune grid), ``model`` and ``geometry`` are equal; its
    ``ledger``, ``gate``, ``gateway`` and ``spans`` blocks were written by
    an earlier run of the reference elsewhere, and the reference's own
    bench on this CPU no longer reproduces them (it drafts every token
    right: 114 of 114, where the file has 115 of 134), so they are held
    to the reference's run."""
    jcfg, jparams = jbench._build_model()
    tparams = transformer.params_from_jax(_np_tree(jparams), device="cpu")
    cfg = tbench.bench_config()
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.tie_embeddings) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.vocab, jcfg.tie_embeddings)
    got = json.loads(json.dumps(tbench.run(cfg, tparams, device="cpu")))
    path = tmp_path / "BENCH_specdecode.json"
    jbench.run(json_path=str(path))
    want = json.loads(path.read_text())
    assert got == want
    committed = json.loads((open(os.path.join(ROOT, "BENCH_specdecode.json"))).read())
    for block in ("bench", "model", "geometry", "plan"):
        assert got[block] == committed[block]
    assert got["gate"]["holds"] and got["spans"]["reconcile"]["holds"]
    assert got["ledger"]["emitted"] == committed["ledger"]["emitted"] == 144


def test_bench_twin_raises_where_the_reference_raises(monkeypatch):
    """The throughput gate: at an unreachable ``MIN_SPEEDUP`` both benches
    raise with the same message."""
    jcfg, jparams = jbench._build_model()
    tparams = transformer.params_from_jax(_np_tree(jparams), device="cpu")
    monkeypatch.setattr(jbench, "MIN_SPEEDUP", 100.0)
    monkeypatch.setattr(tbench, "MIN_SPEEDUP", 100.0)
    monkeypatch.setattr(jbench, "MAX_NEW", 4)
    monkeypatch.setattr(tbench, "MAX_NEW", 4)
    msgs = []
    for call in (lambda: jbench.run(json_path=None),
                 lambda: tbench.run(tbench.bench_config(), tparams, device="cpu")):
        with pytest.raises(RuntimeError) as exc:
            call()
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0] and "under the 100.0x gate" in msgs[1]


# ------------------------------------------------------ entry points


def test_spec_modules_import_no_jax():
    """With jax made unimportable, the new modules import, and none pulls in
    the reference package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.serve.specdecode, repro_torch.obs.spans, repro_torch.bench.specdecode\n"
        "from repro_torch.autotune import tune_lm, tune_spec\n"
        "from repro_torch.serve import SpecEngine, SpecLMAdapter\n"
        "from repro_torch.obs import assemble, breakdown, reconcile\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and (m in ('repro', 'jax') or m.startswith(('repro.', 'jax.')))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spec_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, tcfg, tparams = _model()
    plan = _lm_plan(TunedPlan, "x")
    calls = [
        lambda: SpecEngine(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ, draft_schedule=(2, 2),
                           k=2),
        lambda: SpecLMAdapter(tcfg, tparams, batch=BATCH, max_seq=MAX_SEQ,
                              draft_schedule=(2, 2), k=2),
        lambda: autotune.tune_lm(tparams, tcfg, np.zeros((1, 4), np.int32), target_rel_err=0.1),
        lambda: autotune.tune_spec(tparams, tcfg, [np.arange(3)], plan=plan),
        lambda: tbench.run(tbench.bench_config(), tparams),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
