"""The port's Mamba2 block and Zamba2 (the 'hybrid' family) against the JAX
reference.

Models: Zamba2-7B's smoke config (5 Mamba2 layers: 2 groups of 2 and a
tail of 1; d_model 128, d_inner 256, 8 heads of 32, ssm_state 16; the
shared block 256 wide with 4 heads of 64; vocab 512) and a cut of it at
d_model 256.  At the cut ``quantize_params_int8(min_dim=256)`` makes
``z_proj``, ``xbc_proj``, ``out_proj``, the shared block's linears and the
head int8 (the scaled kernel's route under ``impl='kernel'``: its plain
version on the CPU, the reference's ``impl='pallas'`` in interpret mode),
while ``dt_proj`` (256 x 16) stays bf16 and goes through ``mma_linear``:
the unscaled kernel's route, per-row activation scales.  The reference's
``jax.random`` weights come across with ``zamba2.params_from_jax`` (numpy
leaves of their own dtype); inputs are numpy draws.

Tolerances (``test_torch_rwkv6.py``): parameter trees bit for bit; block
outputs at the reference's decode tolerance (atol = rtol = 1e-2) on bf16
values, float32 SSM states at 1e-5, the chunked SSD's float32 output at
1e-5 of its largest value in the first chunk and 2**-8 past it; whole-model
logits within ``LOGIT_REL`` of the largest (the stateless forward on the
kernel route: within the reference's own compile-mode spread); token
streams on the Horner route and events exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _exact_jit
from test_torch_rwkv6 import LOGIT_REL, LOGIT_TOL, STATE_TOL, _assert_logits_close, _f32, _layout, _np, _x

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quant as jquant
from repro.models import mamba2 as jmamba2
from repro.models import zamba2 as jzamba2
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import serve_step as jserve_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.kernels import ops
from repro_torch.models import layers, mamba2, zamba2
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Request
from repro_torch.serve import serve_step

from _config_fields import reference_view

SSD_REL = 1e-5  # the chunked SSD's float32 output, relative to its largest value
CARRY_REL = 2**-8  # ... past the first chunk: one bf16 rounding of the carried state
CUT = dict(d_model=256)  # z/xbc/out_proj, the shared block and the head int8
BATCH, MAX_SEQ = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _cfgs(width, impl=None):
    jcfg, tcfg = jget_smoke_config("zamba2_7b"), get_smoke_config("zamba2_7b")
    if width == "cut":
        jcfg, tcfg = jcfg.replace(**CUT), tcfg.replace(**CUT)
    if impl is not None:
        jimpl, timpl = {"kernel": ("pallas", "kernel"), "horner": ("xla", "horner")}[impl]
        jcfg = jcfg.replace(quant=JQuantConfig(mode="mma_int8", impl=jimpl, planes=6))
        tcfg = tcfg.replace(quant=QuantConfig(mode="mma_int8", impl=timpl, planes=6))
    return jcfg, tcfg


_MODELS = {}


def _model(width, int8):
    key = (width, int8)
    if key not in _MODELS:
        jcfg, _ = _cfgs(width)
        jp = jzamba2.init_params(jax.random.PRNGKey(0), jcfg)
        if int8:
            jp = jquant.quantize_params_int8(jp, min_dim=256)
        _MODELS[key] = (jp, zamba2.params_from_jax(_np(jp), device="cpu"))
    return _MODELS[key]


def _first_mamba(jp, tp):
    jb = jax.tree.map(lambda a: a[0, 0], jp["groups"])["mamba"]
    tb = layers.layer_params(layers.layer_params(tp["groups"], 0), 0)["mamba"]
    return jb, tb


def _mamba_state(cfg, b, seed):
    """A nonzero decode state of one Mamba2 layer: (reference, port)."""
    d_inner, h, p, n = jmamba2.dims(cfg)
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, cfg.ssm_conv - 1, d_inner + 2 * n)).astype(np.float32)
    ssm = (rng.standard_normal((b, h, n, p)) * 0.1).astype(np.float32)
    return ({"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(ssm)},
            {"conv": torch.from_numpy(conv).to(torch.bfloat16), "ssm": torch.from_numpy(ssm)})


# ----------------------------------------------------------------- configs


def test_config_copies_match_the_reference():
    for t, j in ((get_config("zamba2_7b"), jget_config("zamba2_7b")),
                 (get_smoke_config("zamba2_7b"), jget_smoke_config("zamba2_7b"))):
        td, jd = reference_view(t, j), dataclasses.asdict(j)
        assert td.pop("quant")["impl"] == "horner" and jd.pop("quant")["impl"] == "xla"
        assert td == jd
        assert mamba2.dims(t) == jmamba2.dims(j)
        assert zamba2._group_split(t) == jzamba2._group_split(j)
    assert zamba2._group_split(get_config("zamba2_7b")) == (6, 13, 3)


# ------------------------------------------------------------ param trees


@pytest.mark.parametrize("width", ["smoke", "cut"])
def test_init_trees_equal_in_keys_shapes_and_dtypes(width):
    jcfg, tcfg = _cfgs(width)
    jp = jzamba2.init_params(jax.random.PRNGKey(0), jcfg)
    assert _layout(zamba2.init_params(0, tcfg, device="cpu")) == _layout(jp)
    assert _layout(zamba2.init_params(0, tcfg, device="cpu", int8_min_dim=256)) == \
        _layout(jquant.quantize_params_int8(jp, min_dim=256))


def test_quantize_params_int8_equals_the_reference():
    from test_torch_lm import _leaves

    jp, tp = _model("cut", int8=False)
    got = _leaves(quant.quantize_params_int8(tp, min_dim=256))
    want = _leaves(jquant.quantize_params_int8(jp, min_dim=256))
    assert [p for p, _ in got] == [p for p, _ in want]
    paths = dict(got)
    assert ("groups", "mamba", "dt_proj", "w") in paths  # 256 x 16 stays bf16
    assert ("shared", "attn", "wq", "w_q") in paths and ("tail", "mamba", "out_proj", "w_q") in paths
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), path
        np.testing.assert_array_equal(_f32(a), np.asarray(b, np.float32), err_msg=str(path))


def test_params_from_jax_keeps_each_dtype():
    _, tp = _model("cut", int8=True)
    m = tp["groups"]["mamba"]
    assert m["a_log"].dtype == m["dt_bias"].dtype == m["d_skip"].dtype == torch.float32
    assert m["z_proj"]["w_q"].dtype == torch.int8 and m["z_proj"]["w_scale"].dtype == torch.float32
    assert m["dt_proj"]["w"].dtype == m["conv_w"].dtype == torch.bfloat16
    assert m["a_log"].shape == (2, 2, 16) and tp["tail"]["mamba"]["a_log"].shape == (1, 16)


# --------------------------------------------------------------- components


def test_ssd_chunked_equals_the_reference():
    """Two chunks of 256, states carried across (inputs drawn at the smoke
    config's shapes); S = 255 raises (the reference asserts)."""
    cfg = jget_smoke_config("zamba2_7b")
    d_inner, h, p, n = jmamba2.dims(cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 512, h, p)).astype(np.float32)
    dt = rng.random((2, 512, h)).astype(np.float32) * 0.2
    a = np.linspace(1.0, 4.0, h).astype(np.float32)
    bm = rng.standard_normal((2, 512, n)).astype(np.float32)
    cm = rng.standard_normal((2, 512, n)).astype(np.float32)
    j = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16)]
    t = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dt), torch.from_numpy(a),
         torch.from_numpy(bm).to(torch.bfloat16), torch.from_numpy(cm).to(torch.bfloat16)]
    want = np.asarray(jmamba2._ssd_chunked(*j))
    got = mamba2._ssd_chunked(*t).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 512, h, p)
    top = np.abs(want).max()
    # the first chunk: float32 sums in another order; the second reads the
    # carried state rounded to bf16, where a state element a float32 ulp
    # apart may round one bf16 ulp (2**-8) apart
    assert float(np.abs(got - want)[:, :256].max() / top) <= SSD_REL
    assert float(np.abs(got - want).max() / top) <= CARRY_REL
    with pytest.raises(ValueError, match="not divisible by chunk"):
        mamba2._ssd_chunked(*(v[:, :255] if v.ndim > 1 else v for v in t))
    with pytest.raises(AssertionError):
        jmamba2._ssd_chunked(*(v[:, :255] if v.ndim > 1 else v for v in j))


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel"), ("cut", "horner")])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_equals_the_reference(width, impl, with_state):
    """With state: one decode step from a nonzero state.  Without: the
    chunked SSD path at S = 256."""
    jcfg, tcfg = _cfgs(width, impl)
    jb, tb = _first_mamba(*_model(width, int8=impl is not None))
    jx, tx = _x((2, 1 if with_state else 256, jcfg.d_model), 13)
    js, ts = _mamba_state(jcfg, 2, 14) if with_state else (None, None)
    want, jns = jmamba2.mamba_forward(jb, jx, jcfg, state=js)
    got, tns = mamba2.mamba_forward(tb, tx, tcfg, state=ts)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if with_state:
        np.testing.assert_array_equal(_f32(tns["conv"]), _f32(jns["conv"]))
        np.testing.assert_allclose(tns["ssm"].numpy(), np.asarray(jns["ssm"]), rtol=STATE_TOL,
                                   atol=STATE_TOL)
        assert not torch.equal(tns["ssm"], ts["ssm"])  # a new state; the given one unchanged
    else:
        assert tns is None and jns is None
    with pytest.raises(ValueError, match="one token"):
        mamba2.mamba_forward(tb, torch.zeros((2, 2, jcfg.d_model), dtype=torch.bfloat16), tcfg,
                             state=_mamba_state(jcfg, 2, 14)[1])


def test_softplus_is_logaddexp():
    x = torch.tensor([-100.0, -20.0, -1.5, 0.0, 1e-3, 3.0, 19.0, 21.0, 80.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    # within one float32 ulp: XLA's exp and log1p against torch's (and XLA
    # flushes the denormal at -100 to zero)
    np.testing.assert_allclose(mamba2._softplus(x).numpy(), want, rtol=2**-23, atol=1e-38)


# --------------------------------------------------------------- whole model


def _spread(a, b):
    """(max |a - b| over the largest |b|, top-1 agreement)."""
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max()), float((a.argmax(-1) == b.argmax(-1)).mean())


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel")])
def test_forward_logits_equal_the_reference(width, impl):
    """The stateless forward at S = 256 (one SSD chunk; the shared block on
    the chunked attention path).  Float: within ``LOGIT_REL``.  At the cut on
    the kernel route the model is chaotic: one activation scale for all 256
    positions, so one rounding that differs anywhere (a float32 ulp of
    XLA's sin against torch's in RoPE at position 200, say) moves int8
    levels everywhere downstream.  The reference's own plain ``jax.jit``
    build, which skips some bf16 roundings, departs from its ``_exact_jit``
    build by 0.33 of the largest logit (top-1 agreement 0.56); the port is
    held to depart no further than that, on both measures."""
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    toks = np.random.default_rng(23).integers(0, 512, (1, 256)).astype(np.int32)
    want = _exact_jit(lambda p, t: jzamba2.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    got = zamba2.forward(tp, toks, tcfg, device="cpu")
    assert got.shape == (1, 256, 512) and got.dtype == torch.bfloat16
    if impl is None:
        _assert_logits_close(got, want)
        return
    plain = jax.jit(lambda p, t: jzamba2.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    rel, agree = _spread(got, want)
    ref_rel, ref_agree = _spread(plain, want)
    assert ref_rel > LOGIT_REL  # the chaos this case is held against
    assert rel <= ref_rel and agree >= ref_agree, (rel, agree, ref_rel, ref_agree)


def _counted(monkeypatch):
    """Count the wrappers' calls: (scaled, unscaled)."""
    seen = {"scaled": 0, "unscaled": 0}
    real_s, real_u = ops.mma_matmul_scaled, ops.mma_matmul

    def scaled(*a, **k):
        seen["scaled"] += 1
        return real_s(*a, **k)

    def unscaled(*a, **k):
        seen["unscaled"] += 1
        return real_u(*a, **k)

    monkeypatch.setattr(ops, "mma_matmul_scaled", scaled)
    monkeypatch.setattr(ops, "mma_matmul", unscaled)
    return seen


@pytest.mark.parametrize("width,impl", [("smoke", "kernel"), ("cut", "kernel"),
                                        ("cut", "horner")])
def test_teacher_forced_decode_logits_equal_the_reference(width, impl, monkeypatch):
    """Ten decode calls at batch 4 through ``make_decode`` at the scalar
    index; at the cut on the kernel route each call makes 26 scaled calls
    (5 layers x z/xbc/out_proj, 2 shared-block uses x wq/wk/wv/wo/proj, the
    head) and 5 unscaled ones (``dt_proj``)."""
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=True)
    tokens = np.random.default_rng(33).integers(0, 512, (BATCH, 10)).astype(np.int32)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    tdec, spec = serve_step.make_decode(tcfg, BATCH, MAX_SEQ, device="cpu")
    js = jzamba2.init_state(jcfg, BATCH, MAX_SEQ)
    ts = zamba2.init_state(tcfg, BATCH, MAX_SEQ, device="cpu")
    assert _layout(spec) == _layout(js) and spec["attn_k"].device.type == "meta"
    seen = _counted(monkeypatch)
    for i in range(tokens.shape[1]):
        jl, js = jdec(jp, jnp.asarray(tokens[:, i:i + 1]), js, jnp.int32(i), {})
        tl, ts = tdec(tp, tokens[:, i:i + 1], ts, i, {})
        _assert_logits_close(tl, jl, f"step {i}")
    assert _layout(ts) == _layout(js)
    np.testing.assert_allclose(ts["tail"]["ssm"].numpy(), np.asarray(js["tail"]["ssm"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(_f32(ts["attn_k"]), _f32(js["attn_k"]), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    if width == "cut" and impl == "kernel":
        assert seen == {"scaled": 26 * 10, "unscaled": 5 * 10}
    elif width == "cut":
        assert seen == {"scaled": 0, "unscaled": 0}


def test_decode_refuses_a_vector_index():
    _, tcfg = _cfgs("smoke")
    _, tp = _model("smoke", int8=False)
    st = zamba2.init_state(tcfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="scalar cache index"):
        zamba2.decode_step(tp, np.zeros((2, 1), np.int32), st, np.array([0, 1]), tcfg,
                           device="cpu")


def _requests(cls):
    """Five requests at batch 4: the fifth reuses the first freed slot."""
    rng = np.random.default_rng(43)
    return [cls(rid=i, prompt=rng.integers(0, 512, int(n)).astype(np.int32), max_new=4)
            for i, n in enumerate((4, 2, 5, 3, 3))]


def test_engine_streams_equal_the_reference_with_slot_reuse():
    """``Engine.run`` at batch 4 on the Horner route: the shared scalar index
    (the largest length among the active slots for a step, the slot's own
    for prefill), every row's state advancing on every call and the reused
    slot's state and length inherited, as in the reference.  Streams and
    events equal."""
    jcfg, tcfg = _cfgs("cut", "horner")
    jp, tp = _model("cut", int8=True)
    jeng = jengine.Engine(jcfg, jp, batch=BATCH, max_seq=MAX_SEQ)
    jeng.decode_fn = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    jeng.obs = JRecordingSink()
    jdone = jeng.run(_requests(jengine.Request))
    teng = Engine(tcfg, tp, batch=BATCH, max_seq=MAX_SEQ, device="cpu")
    teng.obs = RecordingSink()
    indices = []
    inner = teng.decode_fn

    def decode(p, toks, cache, idx, extras):
        indices.append(idx)
        return inner(p, toks, cache, idx, extras)

    teng.decode_fn = decode
    tdone = teng.run(_requests(Request))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 4 for r in tdone)
    assert teng.obs.canonical_bytes() == jeng.obs.canonical_bytes()
    assert all(isinstance(i, int) for i in indices) and indices[:4] == [0, 1, 2, 3]


def test_loss_fn_equals_the_reference():
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _model("smoke", int8=False)
    toks = np.random.default_rng(53).integers(0, 512, (1, 257)).astype(np.int32)
    want, _ = _exact_jit(lambda p, t: jzamba2.loss_fn(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    got, metrics = zamba2.loss_fn(tp, {"tokens": toks}, tcfg, device="cpu")
    assert float(got) == pytest.approx(float(want), abs=LOGIT_TOL)
    assert float(metrics["nll"]) == float(got)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg = _cfgs("smoke", "kernel")
    _, tp = _model("smoke", int8=True)
    for call in (lambda: zamba2.init_params(0, tcfg),
                 lambda: zamba2.forward(tp, np.zeros((1, 256), np.int32), tcfg),
                 lambda: zamba2.init_state(tcfg, 1, 8),
                 lambda: mamba2.init_state(tcfg, 1),
                 lambda: zamba2.decode_step(tp, np.zeros((1, 1), np.int32),
                                            zamba2.init_state(tcfg, 1, 8, device="cpu"), 0, tcfg),
                 lambda: zamba2.loss_fn(tp, {"tokens": np.zeros((1, 257), np.int32)}, tcfg),
                 lambda: serve_step.make_prefill(tcfg),
                 lambda: Engine(tcfg, tp, batch=1, max_seq=8)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
