"""The port's RWKV6 (the 'ssm' family) against the JAX reference.

Models: RWKV6-3B's smoke config (2 layers, d_model 128, 2 heads of 64,
d_ff 256, vocab 512) and a cut of it at d_model 256 (4 heads).  At the cut,
``quantize_params_int8(min_dim=256)`` makes ``mix_lora_a`` (256 x 320),
every block linear and the head int8, while ``w_lora_a`` (256 x 64) stays
bf16: the time-mix's ``mix_lora_a`` (called without a quant config) takes
the ``w_q`` Horner route at 8 planes with per-row scales, and the block
linears the scaled kernel's route (``impl='kernel'``: its plain version on
the CPU; the reference's ``impl='pallas'`` in interpret mode).  The
reference's ``jax.random`` weights come across with
``rwkv6.params_from_jax`` (numpy leaves of their own dtype: bf16, float32,
int8); inputs are numpy draws.

Tolerances: parameter trees are equal bit for bit.  Block outputs, logits
and losses are held at the reference's decode tolerance
(``tests/test_system.py``: atol = rtol = 1e-2) on bf16 values; the float32
WKV state at 1e-5 (the same float32 products summed in another order).
Token streams on the Horner route and events are equal.  Whole-model
references run under ``_exact_jit`` (``test_torch_lm.py``), component
references op by op.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _exact_jit, _leaves

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quant as jquant
from repro.models import rwkv6 as jrwkv6
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import serve_step as jserve_step
from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.models import layers, rwkv6
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Request, SpecEngine
from repro_torch.serve import engine as tengine
from repro_torch.serve import serve_step

from _config_fields import reference_view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-2  # the reference's decode tolerance (tests/test_system.py)
STATE_TOL = 1e-5  # float32 state: the same products summed in another order
# Whole-model logits, relative to the largest: the reference's own tolerance
# for its recurrent paths (tests/test_archs.py, Mamba2 decode against the
# chunked SSD: 0.05 of the largest output).  The recurrences sum float32
# products in another order than XLA's (its batched matrix-vector dot is one
# fused multiply-add chain); rounded to bf16 between layers, that moves a
# logit by a few bf16 ulp (0.0103 of the largest on the smoke model).
LOGIT_REL = 0.05
CUT = dict(d_model=256, n_heads=4, n_kv_heads=4)  # mix_lora_a 256 x 320: int8
BATCH, MAX_SEQ = 4, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _np(tree):
    """The reference's leaves as numpy, each of its own dtype (bf16 too)."""
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    """A bf16/float32 tensor or array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(width, impl=None):
    """The reference's and the port's config: 'smoke' or 'cut', float
    (``impl`` None) or ``mma_int8`` on the kernel or Horner route."""
    jcfg, tcfg = jget_smoke_config("rwkv6_3b"), get_smoke_config("rwkv6_3b")
    if width == "cut":
        jcfg, tcfg = jcfg.replace(**CUT), tcfg.replace(**CUT)
    if impl is not None:
        jimpl, timpl = {"kernel": ("pallas", "kernel"), "horner": ("xla", "horner")}[impl]
        jcfg = jcfg.replace(quant=JQuantConfig(mode="mma_int8", impl=jimpl, planes=6))
        tcfg = tcfg.replace(quant=QuantConfig(mode="mma_int8", impl=timpl, planes=6))
    return jcfg, tcfg


_MODELS = {}


def _model(width, int8):
    """(reference params, port params): the reference's draws from
    PRNGKey(0), int8 at ``min_dim=256`` when ``int8``."""
    key = (width, int8)
    if key not in _MODELS:
        jcfg, _ = _cfgs(width)
        jp = jrwkv6.init_params(jax.random.PRNGKey(0), jcfg)
        if int8:
            jp = jquant.quantize_params_int8(jp, min_dim=256)
        _MODELS[key] = (jp, rwkv6.params_from_jax(_np(jp), device="cpu"))
    return _MODELS[key]


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _assert_logits_close(got, want, msg=""):
    got, want = _f32(got), _f32(want)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= LOGIT_REL, f"logits differ by {rel} of the largest {msg}"


def _first_block(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _state(cfg, b, seed):
    """A nonzero decode state of one layer: (reference, port)."""
    h, p = jrwkv6.dims(cfg)
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((b, h, p, p)) * 0.1).astype(np.float32)
    x = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    js = {"s": jnp.asarray(s), "x": jnp.asarray(x, jnp.bfloat16)}
    ts = {"s": torch.from_numpy(s), "x": torch.from_numpy(x).to(torch.bfloat16)}
    return js, ts


# ----------------------------------------------------------------- configs


def test_config_copies_match_the_reference():
    for t, j in ((get_config("rwkv6_3b"), jget_config("rwkv6_3b")),
                 (get_smoke_config("rwkv6_3b"), jget_smoke_config("rwkv6_3b"))):
        td, jd = reference_view(t, j), dataclasses.asdict(j)
        assert td.pop("quant")["impl"] == "horner" and jd.pop("quant")["impl"] == "xla"
        assert td == jd
        assert rwkv6.dims(t) == jrwkv6.dims(j)
    assert get_config("rwkv6_3b").family == "ssm"


# ------------------------------------------------------------ param trees


def _layout(tree):
    return [(path, tuple(a.shape), str(a.dtype).replace("torch.", "")) for path, a in
            _leaves(tree)]


@pytest.mark.parametrize("width", ["smoke", "cut"])
def test_init_trees_equal_in_keys_shapes_and_dtypes(width):
    jcfg, tcfg = _cfgs(width)
    jp = jrwkv6.init_params(jax.random.PRNGKey(0), jcfg)
    assert _layout(rwkv6.init_params(0, tcfg, device="cpu")) == _layout(jp)
    # drawn layer by layer and quantized as drawn: the reference's int8 tree
    assert _layout(rwkv6.init_params(0, tcfg, device="cpu", int8_min_dim=256)) == \
        _layout(jquant.quantize_params_int8(jp, min_dim=256))


def test_quantize_params_int8_equals_the_reference():
    jp, tp = _model("cut", int8=False)
    got = _leaves(quant.quantize_params_int8(tp, min_dim=256))
    want = _leaves(jquant.quantize_params_int8(jp, min_dim=256))
    assert [p for p, _ in got] == [p for p, _ in want]
    paths = dict(got)
    assert ("blocks", "time_mix", "mix_lora_a", "w_q") in paths
    assert ("blocks", "time_mix", "w_lora_a", "w") in paths  # 256 x 64 stays bf16
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), path
        np.testing.assert_array_equal(_f32(a), np.asarray(b, np.float32), err_msg=str(path))


def test_params_from_jax_keeps_each_dtype():
    _, tp = _model("cut", int8=True)
    tm = tp["blocks"]["time_mix"]
    assert tm["w_base"].dtype == tm["u"].dtype == torch.float32
    assert tm["wr"]["w_q"].dtype == torch.int8 and tm["wr"]["w_scale"].dtype == torch.float32
    assert tm["mix_lora_b"].dtype == tm["w_lora_a"]["w"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16


# --------------------------------------------------------------- components


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel"), ("cut", "horner")])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_equals_the_reference(width, impl, with_state, monkeypatch):
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    jb = _first_block(jp["blocks"])["time_mix"]
    tb = layers.layer_params(tp["blocks"], 0)["time_mix"]
    jx, tx = _x((2, 5, jcfg.d_model), 7)
    js, ts = _state(jcfg, 2, 8) if with_state else (None, None)
    seen = []
    inner = layers.linear
    monkeypatch.setattr(layers, "linear",
                        lambda p, x, q=None: seen.append(("w_q" in p, q)) or inner(p, x, q))
    want, jns = jrwkv6.time_mix(jb, jx, jcfg, state=js)
    got, tns = rwkv6.time_mix(tb, tx, tcfg, state=ts)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, jcfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if with_state:
        np.testing.assert_allclose(tns["s"].numpy(), np.asarray(jns["s"]), rtol=STATE_TOL,
                                   atol=STATE_TOL)
        np.testing.assert_array_equal(_f32(tns["x"]), _f32(jns["x"]))
    else:
        assert tns is None and jns is None
    # the LoRAs take no quant config: mix_lora_a int8 at the cut (the Horner
    # route through layers.linear), float at the smoke width (rwkv6.lora_linear
    # accumulates in float64: only the quantized block linears reach layers.linear)
    if impl is None:
        assert seen and all(not w_q and q is tcfg.quant for w_q, q in seen)
    else:
        assert seen[0] == (True, None)


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel")])
@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_equals_the_reference(width, impl, with_state):
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    jb = _first_block(jp["blocks"])["channel_mix"]
    tb = layers.layer_params(tp["blocks"], 0)["channel_mix"]
    jx, tx = _x((2, 5, jcfg.d_model), 9)
    jl, tl = _x((2, jcfg.d_model), 10) if with_state else (None, None)
    want, jlast = jrwkv6.channel_mix(jb, jx, jcfg, last=jl)
    got, tlast = rwkv6.channel_mix(tb, tx, tcfg, last=tl)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if with_state:
        np.testing.assert_array_equal(_f32(tlast), _f32(jlast))


def test_wkv_reads_the_state_before_the_update():
    """y_t = r_t (S_{t-1} + diag(u) k_t v_t^T), then S_t = diag(w_t) S_{t-1}
    + k_t v_t^T: one step by hand."""
    rng = np.random.default_rng(11)
    r, k, v, w = (torch.from_numpy(rng.random((1, 1, 1, 3)).astype(np.float32)) for _ in range(4))
    u = torch.from_numpy(rng.random((1, 3)).astype(np.float32))
    s0 = torch.from_numpy(rng.random((1, 1, 3, 3)).astype(np.float32))
    y, s1 = rwkv6.wkv(r, k, v, w, u, s0)
    kv = k[0, 0, 0][:, None] * v[0, 0, 0][None, :]
    torch.testing.assert_close(y[0, 0, 0], r[0, 0, 0] @ (s0[0, 0] + u[0][:, None] * kv))
    torch.testing.assert_close(s1[0, 0], w[0, 0, 0][:, None] * s0[0, 0] + kv)


# --------------------------------------------------------------- whole model


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel")])
def test_forward_logits_equal_the_reference(width, impl):
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    toks = np.random.default_rng(21).integers(0, 512, (2, 8)).astype(np.int32)
    want = _exact_jit(lambda p, t: jrwkv6.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    got = rwkv6.forward(tp, toks, tcfg, device="cpu")
    assert got.shape == (2, 8, 512) and got.dtype == torch.bfloat16
    _assert_logits_close(got, want)


@pytest.mark.parametrize("width,impl", [("smoke", "kernel"), ("cut", "kernel"),
                                        ("cut", "horner")])
def test_teacher_forced_decode_logits_equal_the_reference(width, impl):
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=True)
    tokens = np.random.default_rng(31).integers(0, 512, (BATCH, 10)).astype(np.int32)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    tdec, spec = serve_step.make_decode(tcfg, BATCH, MAX_SEQ, device="cpu")
    js = jrwkv6.init_state(jcfg, BATCH)
    ts = rwkv6.init_state(tcfg, BATCH, device="cpu")
    assert _layout(spec) == _layout(js) and spec["tm_s"].device.type == "meta"
    for i in range(tokens.shape[1]):
        jl, js = jdec(jp, jnp.asarray(tokens[:, i:i + 1]), js, jnp.int32(i), {})
        tl, ts = tdec(tp, tokens[:, i:i + 1], ts, i, {})
        _assert_logits_close(tl, jl, f"step {i}")
    assert _layout(ts) == _layout(js)
    # prefill: the whole prompt through the stateless forward
    want = _exact_jit(jserve_step.make_prefill(jcfg))(jp, jnp.asarray(tokens), {})
    got = serve_step.make_prefill(tcfg, device="cpu")(tp, tokens, {})
    _assert_logits_close(got, want, "prefill")


def _requests(cls):
    """Five requests at batch 4: the fifth reuses the first freed slot."""
    rng = np.random.default_rng(41)
    return [cls(rid=i, prompt=rng.integers(0, 512, int(n)).astype(np.int32), max_new=4)
            for i, n in enumerate((3, 6, 4, 5, 2))]


def test_engine_streams_equal_the_reference_with_slot_reuse():
    """``Engine.run`` at batch 4 on the Horner route (per-row activation
    scales).  The reference's shared-index behaviour is kept: every prefill
    call advances every row's state, and the fifth request inherits its
    slot's state and length.  Streams and events equal the reference's."""
    jcfg, tcfg = _cfgs("cut", "horner")
    jp, tp = _model("cut", int8=True)
    jeng = jengine.Engine(jcfg, jp, batch=BATCH, max_seq=MAX_SEQ)
    jeng.decode_fn = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    jeng.obs = JRecordingSink()
    jdone = jeng.run(_requests(jengine.Request))
    teng = Engine(tcfg, tp, batch=BATCH, max_seq=MAX_SEQ, device="cpu")
    teng.obs = RecordingSink()
    inherited = {}

    def admit_slot(req, inner=teng.admit_slot):
        before = teng.lengths.copy()
        ok = inner(req)
        if ok:
            slot = next(i for i, r in teng.slots.active() if r is req)
            assert teng.lengths[slot] == before[slot]  # not reset
            inherited[req.rid] = int(before[slot])
        return ok

    teng.admit_slot = admit_slot
    tdone = teng.run(_requests(Request))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 4 for r in tdone)
    assert teng.obs.canonical_bytes() == jeng.obs.canonical_bytes()
    # the fifth request took a used slot, its length and state as they were
    assert inherited[4] > 0 and all(inherited[i] == 0 for i in range(4))


def test_loss_fn_equals_the_reference():
    jp, tp = _model("smoke", int8=False)
    jcfg, tcfg = _cfgs("smoke")
    toks = np.random.default_rng(51).integers(0, 512, (2, 9)).astype(np.int32)
    want, _ = _exact_jit(lambda p, t: jrwkv6.loss_fn(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    got, metrics = rwkv6.loss_fn(tp, {"tokens": toks}, tcfg, device="cpu")
    assert float(got) == pytest.approx(float(want), abs=LOGIT_TOL)
    assert float(metrics["nll"]) == float(got)


# ----------------------------------------------------- families and refusals


def test_build_dispatches_and_refuses():
    from repro_torch.models import whisper, zamba2

    _, tcfg = _cfgs("smoke", "kernel")
    assert models.build(tcfg) is rwkv6
    assert models.build(get_smoke_config("zamba2_7b")) is zamba2
    # 'encdec' builds Whisper, and its decode step serves from the same
    # kind of cache spec as the other families
    wcfg = get_smoke_config("whisper_large_v3")
    assert models.build(tcfg.replace(family="encdec", quant=QuantConfig())) is whisper
    _, spec = serve_step.make_decode(wcfg, 2, 8, device="cpu")
    assert spec["k"].shape == (wcfg.n_layers, 2, 8, wcfg.n_kv_heads, wcfg.hd)
    for name in ("rwkv6_3b", "zamba2_7b"):
        sched = get_smoke_config(name).replace(
            quant=QuantConfig(mode="mma_int8", impl="kernel", plane_schedule=(6, 5)))
        with pytest.raises(NotImplementedError, match="plane_schedule"):
            models.build(sched)
        with pytest.raises(NotImplementedError, match="global quant.planes"):
            tengine.lm_schedule_from_params({}, get_smoke_config(name), 0.05)


@pytest.mark.parametrize("name", ["rwkv6_3b", "zamba2_7b"])
def test_spec_engine_refuses_the_recurrent_families(name):
    from repro.models import zamba2 as jzamba2
    from repro.serve import specdecode as jspec
    from repro_torch.models import zamba2

    jcfg = jget_smoke_config(name).replace(quant=JQuantConfig(mode="mma_int8"))
    tcfg = get_smoke_config(name).replace(quant=QuantConfig(mode="mma_int8"))
    jmod, tmod = (jrwkv6, rwkv6) if name == "rwkv6_3b" else (jzamba2, zamba2)
    jp = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmod.init_params(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="per-slot cache-index") as want:
        jspec.SpecEngine(jcfg, jp, batch=2, max_seq=16, draft_schedule=(2,) * 2, k=2)
    with pytest.raises(ValueError, match="per-slot cache-index") as got:
        SpecEngine(tcfg, tp, batch=2, max_seq=16, draft_schedule=(2,) * 2, k=2, device="cpu")
    assert str(got.value) == str(want.value)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg = _cfgs("smoke", "kernel")
    _, tp = _model("smoke", int8=True)
    for call in (lambda: rwkv6.init_params(0, tcfg),
                 lambda: rwkv6.forward(tp, np.zeros((1, 2), np.int32), tcfg),
                 lambda: rwkv6.init_state(tcfg, 1),
                 lambda: rwkv6.decode_step(tp, np.zeros((1, 1), np.int32),
                                           rwkv6.init_state(tcfg, 1, device="cpu"), 0, tcfg),
                 lambda: rwkv6.loss_fn(tp, {"tokens": np.zeros((1, 3), np.int32)}, tcfg),
                 lambda: serve_step.make_decode(tcfg, 1, 8),
                 lambda: Engine(tcfg, tp, batch=1, max_seq=8)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


def test_recurrent_modules_import_no_jax():
    """With jax made unimportable, the new modules import, and neither jax
    nor the reference package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.models.rwkv6, repro_torch.models.zamba2, repro_torch.serve\n"
        "import repro_torch.models.mamba2, repro_torch.configs.rwkv6_3b\n"
        "import repro_torch.configs.zamba2_7b\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and (m in ('repro', 'jax') or m.startswith(('repro.', 'jax.')))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
