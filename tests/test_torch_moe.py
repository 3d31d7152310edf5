"""The port's mixture-of-experts FFN and the 'moe' transformer family against
the JAX reference.

Models: the olmoe_1b_7b and dbrx_132b smoke configs (8 experts top-2 and 4
experts top-2, d_model 128).  The reference's ``jax.random`` weights come
across with ``transformer.params_from_jax``; inputs are numpy draws.

Held exactly: routing (expert ids, positions in the expert's segment, the
kept mask, token order, ``cap``) and the dispatch buffer, given the same
router logits and on each package's own; ties go to the lower expert index
as ``lax.top_k`` breaks them; served token streams and events.  Float
outputs, logits and losses are held at the reference's decode tolerance
(``tests/test_system.py``: atol = rtol = 1e-2), the load-balance loss at
1e-5 relative (float32 means of the same probabilities).  Whole-model
references run under ``_exact_jit`` (``test_torch_lm.py``): under plain
``jax.jit`` the reference skips bf16 roundings its source writes, which
moves near-tie routing and argmax decisions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_gateway import _exact_engines, _exact_jit, _np_tree, _same_run
from test_torch_specdecode import _replayed_tune_lm

from repro.autotune import api as japi
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quant as jquant
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro.serve import serve_step as jserve_step
from repro.serve import specdecode as jspec
from repro_torch import autotune, models
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.models import moe, transformer
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Gateway, LMAdapter, Request, SpecEngine
from repro_torch.serve import engine as tengine

MODELS = ("olmoe_1b_7b", "dbrx_132b")
LOGIT_TOL = 1e-2  # the reference's decode tolerance (tests/test_system.py)
AUX_RTOL = 1e-5  # float32 means of the same probabilities, summed in another order
SCHEDULE = (6, 5)
MIN_DIM = 128  # attention and head int8 at d_model 128; router and experts stay bf16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


@functools.lru_cache(maxsize=None)
def _moe_params(name):
    jcfg, tcfg = jget_smoke_config(name), get_smoke_config(name)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, transformer.params_from_jax(_np_tree(jp), device="cpu")


def _x(shape, d, seed):
    x = np.random.default_rng(seed).standard_normal(shape + (d,)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.to(torch.float32) if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _reference_moe(jp, jx, jcfg, monkeypatch):
    """The reference's ``moe_ffn`` and its own dispatch buffer (E, cap, D),
    read at its first sharding hint."""
    seen = []
    monkeypatch.setattr(jmoe, "constrain", lambda a, *names: seen.append(a) or a)
    y = jmoe.moe_ffn(jp, jx, jcfg)
    return y, seen[0]


def _routing_equal(jmeta, tmeta):
    """(eid_s, pos, tok_s, keep) exactly, the gate weights within float32
    rounding (softmax sums in another order)."""
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(tmeta[i].numpy(), np.asarray(jmeta[i]))
    np.testing.assert_allclose(tmeta[3].numpy(), np.asarray(jmeta[3]), rtol=1e-6, atol=0)


def _dispatch_both(jp, tp, jx, tx, jcfg, tcfg):
    """Each package's routing on its own router logits."""
    m, d = tcfg.moe, tcfg.d_model
    t = tx.numel() // d
    cap = moe.capacity(t, m)
    jxf, txf = jx.reshape(t, d), tx.reshape(t, d)
    jlog = jlayers.linear(jp["router"], jxf).astype(jnp.float32)
    tlog = moe.router_logits(tp, txf)
    np.testing.assert_array_equal(tlog.numpy(), np.asarray(jlog))
    jxe, jmeta = jmoe._local_dispatch(jxf, jlog, m.n_experts, m.top_k, cap, jnp.bfloat16)
    txe, tmeta = moe._local_dispatch(txf, tlog, m.n_experts, m.top_k, cap, torch.bfloat16)
    return cap, (jxe, jmeta), (txe, tmeta)


# ---------------------------------------------------------------- configs


def test_moe_config_copies_build_the_transformer():
    for name in MODELS:
        cfg = get_smoke_config(name)
        assert cfg.family == "moe" and cfg.moe.n_experts and not cfg.moe.ep
        assert models.build(cfg) is transformer


# ---------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("case", ["reference-shape", "drops", "dropless"])
def test_moe_ffn_equals_the_reference(name, case, monkeypatch):
    """At (2, 16, d) (``tests/test_models_extra.py``'s shape), at T = 32
    with other data (assignments dropped at capacity), and at capacity
    factor 64 (dropless): routing and the dispatch buffer exact, the
    output within the decode tolerance."""
    jcfg, jp, tcfg, tp = _moe_params(name)
    shape, seed = {"reference-shape": ((2, 16), 0), "drops": ((4, 8), 10),
                   "dropless": ((2, 16), 0)}[case]
    if case == "dropless":
        jcfg, tcfg = _with_moe(jcfg, capacity_factor=64.0), _with_moe(tcfg, capacity_factor=64.0)
    jx, tx = _x(shape, tcfg.d_model, seed)
    want, jxe_own = _reference_moe(jp, jx, jcfg, monkeypatch)
    got = moe.moe_ffn(tp, tx, tcfg)
    cap, (jxe, jmeta), (txe, tmeta) = _dispatch_both(jp, tp, jx, tx, jcfg, tcfg)
    assert jxe_own.shape == (tcfg.moe.n_experts, cap, tcfg.d_model)
    np.testing.assert_array_equal(_np(txe), _np(jxe_own))
    np.testing.assert_array_equal(_np(txe), _np(jxe))
    _routing_equal(jmeta, tmeta)
    dropped = int((~tmeta[4]).sum())
    if case == "dropless":
        assert dropped == 0
    elif case == "drops":
        assert dropped > 0
    assert got.shape == tx.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.to(torch.float32)).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("router", ["tied-columns", "all-equal"])
def test_router_ties_go_to_the_lower_expert(name, router, monkeypatch):
    """A router whose first three columns are equal (the k-th and (k+1)-th
    probabilities tie wherever that group leads), or all zero (every
    probability equal: experts 0..k-1 for every token, drops at capacity):
    the port picks the reference's experts."""
    jcfg, jp, tcfg, tp = _moe_params(name)
    w = np.asarray(jp["router"]["w"].astype(jnp.float32)).copy()
    if router == "tied-columns":
        w[:, 1] = w[:, 2] = w[:, 0]
    else:
        w[:] = 0.0
    jp = dict(jp, router={"w": jnp.asarray(w, jnp.bfloat16)})
    tp = dict(tp, router={"w": torch.from_numpy(w).to(torch.bfloat16)})
    jx, tx = _x((2, 16), tcfg.d_model, 3)
    want, _ = _reference_moe(jp, jx, jcfg, monkeypatch)
    got = moe.moe_ffn(tp, tx, tcfg)
    cap, (_, jmeta), (_, tmeta) = _dispatch_both(jp, tp, jx, tx, jcfg, tcfg)
    _routing_equal(jmeta, tmeta)
    probs = torch.softmax(moe.router_logits(tp, tx.reshape(-1, tcfg.d_model)), -1)
    top = torch.sort(probs, -1, descending=True).values
    k = tcfg.moe.top_k
    assert bool((top[:, k - 1] == top[:, k]).any())  # a tie at the k-th place
    if router == "all-equal":
        assert set(tmeta[0].tolist()) == set(range(k))
        assert int((~tmeta[4]).sum()) == 32 * k - k * cap
    np.testing.assert_allclose(_np(got), _np(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@settings(max_examples=20, deadline=None)
@given(
    t=st.integers(min_value=1, max_value=40),
    e=st.sampled_from((2, 4, 8, 16, 64)),
    data=st.data(),
)
def test_local_dispatch_sweep_equals_the_reference(t, e, data):
    """``_local_dispatch`` over T, E, k and the capacity factor, on bf16
    logits (exact ties are frequent): routing and buffer exact, and
    ``capacity`` equal to the cap the reference's ``moe_ffn`` allocates."""
    k = data.draw(st.integers(min_value=1, max_value=min(e, 8)))
    cf = data.draw(st.sampled_from((0.5, 1.0, 1.25, 2.0, 64.0)))
    seed = data.draw(st.integers(min_value=0, max_value=10**6))
    rng = np.random.default_rng(seed)
    d = 8
    xf = rng.standard_normal((t, d)).astype(np.float32)
    # bf16-rounded logits on a coarse grid: many exact ties
    logits = np.round(rng.standard_normal((t, e)) * 2) / 2
    cfg = _with_moe(get_smoke_config("olmoe_1b_7b"), n_experts=e, top_k=k, capacity_factor=cf)
    cap = moe.capacity(t, cfg.moe)
    jcfg = _with_moe(jget_smoke_config("olmoe_1b_7b").replace(d_model=d), n_experts=e,
                     top_k=k, capacity_factor=cf)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "constrain", lambda a, *names: seen.append(a) or a)
        mp.setattr(jlayers, "linear", lambda p, x, *a: jnp.asarray(logits, jnp.bfloat16))
        jmoe.moe_ffn({"router": None, "w_gate": jnp.zeros((e, d, 1), jnp.bfloat16),
                      "w_up": jnp.zeros((e, d, 1), jnp.bfloat16),
                      "w_down": jnp.zeros((e, 1, d), jnp.bfloat16)},
                     jnp.asarray(xf, jnp.bfloat16).reshape(1, t, d), jcfg)
    assert seen[0].shape == (e, cap, d)
    jlog = jnp.asarray(logits, jnp.float32)
    jxe, jmeta = jmoe._local_dispatch(jnp.asarray(xf, jnp.bfloat16), jlog, e, k, cap, jnp.bfloat16)
    txe, tmeta = moe._local_dispatch(torch.from_numpy(xf).to(torch.bfloat16),
                                     torch.from_numpy(logits.astype(np.float32)), e, k, cap,
                                     torch.bfloat16)
    _routing_equal(jmeta, tmeta)
    np.testing.assert_array_equal(_np(txe), _np(jxe))
    np.testing.assert_array_equal(_np(txe), _np(seen[0]))


@pytest.mark.parametrize("name", MODELS)
def test_load_balance_loss_equals_the_reference(name):
    jcfg, jp, tcfg, tp = _moe_params(name)
    for shape, seed in (((2, 16), 0), ((1, 5), 1)):
        jx, tx = _x(shape, tcfg.d_model, seed)
        want = float(jmoe.load_balance_loss(jp, jx, jcfg))
        got = moe.load_balance_loss(tp, tx, tcfg)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=AUX_RTOL)


def test_moe_ffn_ep_is_moe_ffn_on_one_card():
    _, _, tcfg, tp = _moe_params("olmoe_1b_7b")
    _, tx = _x((2, 16), tcfg.d_model, 0)
    ep = _with_moe(tcfg, ep=True)
    assert torch.equal(moe.moe_ffn_ep(tp, tx, ep), moe.moe_ffn(tp, tx, tcfg))


# ------------------------------------------------------------ whole model


def _qcfgs(name, impl=("pallas", "kernel"), schedule=SCHEDULE):
    jq = JQuantConfig(mode="mma_int8", impl=impl[0], plane_schedule=schedule)
    tq = QuantConfig(mode="mma_int8", impl=impl[1], plane_schedule=schedule)
    return jget_smoke_config(name).replace(quant=jq), get_smoke_config(name).replace(quant=tq)


@functools.lru_cache(maxsize=None)
def _lm(name):
    """The smoke model in both packages, float and int8 (``w_q`` on the
    attention linears and the head)."""
    jcfg = jget_smoke_config(name)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    jqp = jquant.quantize_params_int8(jparams, min_dim=MIN_DIM)
    return (jparams, jqp, transformer.params_from_jax(_np_tree(jparams), device="cpu"),
            transformer.params_from_jax(_np_tree(jqp), device="cpu"))


@pytest.fixture
def drops(monkeypatch):
    """Assignments the port's dispatch dropped, counted per call."""
    seen = []
    inner = moe._local_dispatch

    def counting(*a):
        xe, meta = inner(*a)
        seen.append(int((~meta[4]).sum()))
        return xe, meta

    monkeypatch.setattr(moe, "_local_dispatch", counting)
    return seen


@pytest.mark.parametrize("name", MODELS)
def test_params_carry_the_moe_subtree(name):
    jparams, jqp, tparams, tqp = _lm(name)
    moe_p = tqp["blocks"]["moe"]
    assert set(moe_p) == {"router", "w_gate", "w_up", "w_down"}
    assert set(moe_p["router"]) == {"w"} and moe_p["w_gate"].dtype == torch.bfloat16
    assert "w_q" in tqp["blocks"]["attn"]["wq"] and "w_q" in tqp["head"]
    got = quant.quantize_params_int8(tparams, min_dim=MIN_DIM)
    for path in (("attn", "wq", "w_q"), ("moe", "w_up"), ("moe", "router", "w")):
        a, b = got["blocks"], tqp["blocks"]
        for key in path:
            a, b = a[key], b[key]
        assert torch.equal(a, b), path
    want = np.asarray(jqp["blocks"]["moe"]["w_down"].astype(jnp.float32))
    np.testing.assert_array_equal(moe_p["w_down"].to(torch.float32).numpy(), want)


@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_with_drops_equal_the_reference(name, drops):
    """The whole quantized model (the kernel route against the reference's
    interpret-mode Pallas, a per-layer schedule) on (2, 16) tokens, where
    every layer's MoE sees T = 32 and drops at capacity."""
    _, jqp, _, tqp = _lm(name)
    jcfg, tcfg = _qcfgs(name)
    toks = np.random.default_rng(11).integers(0, 512, (2, 16)).astype(np.int32)
    want = _exact_jit(lambda p, t: jtransformer.forward(p, t, jcfg))(jqp, jnp.asarray(toks))
    got = transformer.forward(tqp, toks, tcfg, device="cpu")
    assert len(drops) == tcfg.n_layers and sum(drops) > 0
    np.testing.assert_allclose(_np(got), _np(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_logits_equal_the_reference(name, drops):
    """``decode_step`` prefilling 12 tokens per row into the cache (T = 24:
    drops at capacity), then 4 teacher-forced decode steps at per-row
    positions."""
    _, jqp, _, tqp = _lm(name)
    jcfg, tcfg = _qcfgs(name)
    toks = np.random.default_rng(12).integers(0, 512, (2, 16)).astype(np.int32)
    jstep = functools.partial(jtransformer.decode_step, cfg=jcfg)
    jpre = _exact_jit(lambda p, t, c, i: jstep(p, t, c, i))
    jdec = _exact_jit(lambda p, t, c, i: jstep(p, t, c, i))
    jc = jtransformer.init_cache(jcfg, 2, 32)
    tc = transformer.init_cache(tcfg, 2, 32, device="cpu")
    jl, jc = jpre(jqp, jnp.asarray(toks[:, :12]), jc, jnp.asarray(0))
    tl, tc = transformer.decode_step(tqp, toks[:, :12], tc, 0, tcfg, device="cpu")
    assert sum(drops) > 0
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    lengths = np.array([12, 12], np.int32)
    for i in range(12, 16):
        jl, jc = jdec(jqp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(lengths))
        tl, tc = transformer.decode_step(tqp, toks[:, i:i + 1], tc, lengths, tcfg, device="cpu")
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
        lengths = lengths + 1


@pytest.mark.parametrize("name", MODELS)
def test_aux_and_loss_equal_the_reference(name):
    """``forward(return_aux=True)``'s load-balance aux (summed over layers,
    each on ``rmsnorm(ln2, h)`` of the block's input) and ``loss_fn``
    (nll + 0.01 aux), float model."""
    jparams, _, tparams, _ = _lm(name)
    jcfg, tcfg = jget_smoke_config(name), get_smoke_config(name)
    toks = np.random.default_rng(13).integers(0, 512, (2, 9)).astype(np.int32)
    jfwd = _exact_jit(lambda p, t: jtransformer.forward(p, t, jcfg, return_aux=True))
    jlogits, jaux = jfwd(jparams, jnp.asarray(toks[:, :-1]))
    logits, aux = transformer.forward(tparams, toks[:, :-1], tcfg, return_aux=True, device="cpu")
    assert float(aux) > 0 and aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jloss, jm = _exact_jit(lambda p, b: jtransformer.loss_fn(p, b, jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    loss, metrics = transformer.loss_fn(tparams, {"tokens": toks}, tcfg, device="cpu")
    assert float(metrics["aux"]) == pytest.approx(float(jm["aux"]), rel=AUX_RTOL)
    assert float(loss) == pytest.approx(float(jloss), abs=LOGIT_TOL)
    assert float(loss) == pytest.approx(float(metrics["nll"]) + 0.01 * float(aux), rel=1e-6)


# ---------------------------------------------------------------- serving


def _requests(cls, n=10, seed=61):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, int(m)).astype(np.int32), max_new=4)
            for i, m in enumerate(rng.integers(2, 7, n))]


@pytest.mark.parametrize("name", MODELS)
def test_engine_streams_with_drops_equal_the_reference(name, drops):
    """``Engine.run`` at batch 8 on the Horner route (one activation scale
    per row): every decode call routes T = 8 tokens, pad tokens of idle
    slots included, and some calls drop at capacity (cap 4 / 5).  Streams
    and events equal the reference engine's."""
    _, jqp, _, tqp = _lm(name)
    jcfg, tcfg = _qcfgs(name, impl=("xla", "horner"))
    batch, max_seq = 8, 16
    jeng = jengine.Engine(jcfg, jqp, batch=batch, max_seq=max_seq)
    jeng.decode_fn = _exact_jit(jserve_step.make_decode(jcfg, batch, max_seq)[0])
    jeng.obs = JRecordingSink()
    jdone = jeng.run(_requests(jengine.Request))
    teng = Engine(tcfg, tqp, batch=batch, max_seq=max_seq, device="cpu")
    teng.obs = RecordingSink()
    tdone = teng.run(_requests(Request))
    assert sum(drops) > 0
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 4 for r in tdone)
    assert teng.obs.canonical_bytes() == jeng.obs.canonical_bytes()


def test_lm_schedule_from_params_on_an_moe_tree():
    """MoE blocks take the attention query projection (no ``mlp``): float
    weights as the reference, int8 ``w_q`` leaves to the same budgets."""
    jparams, _, tparams, tqp = _lm("olmoe_1b_7b")
    jcfg, tcfg = jget_smoke_config("olmoe_1b_7b"), get_smoke_config("olmoe_1b_7b")
    for target in (0.05, 0.01):
        want = jengine.lm_schedule_from_params(jparams, jcfg, target)
        got = tengine.lm_schedule_from_params(tparams, tcfg, target)
        assert got.planes == want.planes
        assert got.layer_bounds == pytest.approx(want.layer_bounds, rel=1e-6)
        assert tengine.lm_schedule_from_params(tqp, tcfg, target).planes == want.planes


@pytest.fixture
def exact_shared_decode(monkeypatch):
    """The reference's ``shared_decode`` under ``_exact_jit`` (engines the
    reference builds inside ``SpecEngine``/``tune_lm``)."""
    exact = functools.lru_cache(maxsize=None)(
        lambda cfg, b, s: _exact_jit(jserve_step.make_decode(cfg, b, s)[0]))
    monkeypatch.setattr(jengine, "shared_decode", exact)
    monkeypatch.setattr(jspec, "shared_decode", exact)


def test_spec_engine_on_moe_equals_the_reference(exact_shared_decode):
    """``SpecEngine`` (2-plane drafts, k 2) on the float olmoe smoke model's
    Horner route: streams and every ``spec_trace`` record equal the
    reference's, and the streams equal greedy's."""
    jparams, _, tparams, _ = _lm("olmoe_1b_7b")
    jcfg, tcfg = _qcfgs("olmoe_1b_7b", impl=("xla", "horner"), schedule=(8, 8))
    out = []
    for eng, req_cls in (
        (jspec.SpecEngine(jcfg, jparams, batch=2, max_seq=24, draft_schedule=(2, 2), k=2),
         jengine.Request),
        (SpecEngine(tcfg, tparams, batch=2, max_seq=24, draft_schedule=(2, 2), k=2,
                    device="cpu"), Request),
    ):
        reqs = [req_cls(rid=i, prompt=p.prompt, max_new=6) for i, p in
                enumerate(_requests(Request, n=2, seed=5))]
        for r in reqs:
            assert eng.admit(r)
        while eng.ready_slots():
            eng.spec_step()
        out.append(([r.out for r in reqs], eng.spec_trace))
    greedy = Engine(tcfg, tparams, batch=2, max_seq=24, device="cpu").run(
        [Request(rid=i, prompt=p.prompt, max_new=6)
         for i, p in enumerate(_requests(Request, n=2, seed=5))])
    assert out[1] == out[0]
    assert out[1][0] == [r.out for r in sorted(greedy, key=lambda r: r.rid)]


def test_gateway_lm_adapter_on_moe_equals_the_reference():
    """``Gateway`` + ``LMAdapter`` on the quantized olmoe smoke model (Horner
    route, batch 4): event bytes, ``stats()``, stamps and streams equal
    the reference's."""
    _, jqp, _, tqp = _lm("olmoe_1b_7b")
    jcfg, tcfg = _qcfgs("olmoe_1b_7b", impl=("xla", "horner"))
    ja = _exact_engines(jgateway.LMAdapter(jcfg, jqp, batch=4, max_seq=16))
    ta = LMAdapter(tcfg, tqp, batch=4, max_seq=16, device="cpu")
    gws = []
    for gw in (jgateway.Gateway([ja], policy="fair", round_budget=200_000, sink=JRecordingSink()),
               Gateway([ta], policy="fair", round_budget=200_000, sink=RecordingSink())):
        for r in _requests(Request, n=6, seed=9):
            gw.submit("lm", r.prompt, max_new=4)
        gw.drain(max_rounds=1_000)
        gws.append(gw)
    _same_run(*gws)
    assert [g.handle.out for g in gws[1].requests] == [g.handle.out for g in gws[0].requests]
    assert all(len(g.handle.out) == 4 for g in gws[1].requests)


def test_tune_lm_on_moe_equals_the_exact_replay():
    """``tune_lm`` on the float olmoe smoke model: planes and repairs equal
    the reference's repair loop replayed under ``_exact_jit``
    (``test_torch_specdecode._replayed_tune_lm``), the measured error
    within 1e-5; fingerprints, layer bounds and geometry equal the
    reference's own ``tune_lm`` (whose forwards under plain ``jax.jit``
    round elsewhere, so its measurement may stop the repairs elsewhere)."""
    jparams, _, tparams, _ = _lm("olmoe_1b_7b")
    jcfg, tcfg = jget_smoke_config("olmoe_1b_7b"), get_smoke_config("olmoe_1b_7b")
    tokens = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)
    got = autotune.tune_lm(tparams, tcfg, tokens, target_rel_err=0.1, device="cpu")
    c = got.certificate
    planes, repairs, m = _replayed_tune_lm(jparams, jcfg, tokens, 0.1, c["slack"], c["margin"])
    assert (got.planes, c["repairs"]) == (planes, repairs)
    assert abs(c["measured_rel_err"] - m) <= 1e-5
    own = japi.tune_lm(jparams, jcfg, tokens, target_rel_err=0.1)
    assert (got.fingerprint, got.params_fingerprint, got.layer_bounds, got.geometry) == \
        (own.fingerprint, own.params_fingerprint, own.layer_bounds, own.geometry)
