"""The port's Whisper (the 'encdec' family) against the JAX reference.

Models: Whisper-large-v3's smoke config (2 + 2 layers, d_model 128, 4
heads, d_ff 256, vocab 512, 32 encoder frames) and a cut of it at d_model
256 (4 heads of 64, d_ff 512, attention chunks of 24 so the encoder's 32
frames take two ragged chunks, as 1500 frames take two chunks of 1024 at
full width).  At the cut ``quantize_params_int8(min_dim=256)`` makes every
encoder and decoder linear int8, as at full width: the kernel route
(``impl='kernel'``, its plain version on the CPU; the reference's
``impl='pallas'`` in interpret mode) or the Horner route (``'horner'`` /
``'xla'``).  The reference's ``jax.random`` weights come across with
``whisper.params_from_jax``; frames and tokens are numpy draws.

Tolerances: parameter trees equal in keys, shapes and dtypes; encoder
memory and cross K/V at the reference's decode tolerance
(``tests/test_system.py``: atol = rtol = 1e-2) on bf16 values; logits
within 0.05 of the largest (the tolerance ``test_torch_rwkv6.py`` and
``test_torch_gpu.py`` hold LM logits to: a bf16 ulp of a float op that
rounds the other way moves an int8 level of the next per-tensor grid).
The port's decode with and without precomputed cross K/V is equal bit
for bit; token streams and events on the Horner route equal the
reference's.  Whole-model references run under ``_exact_jit``
(``test_torch_lm.py``).
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
from repro.models import layers as jlayers
from repro.models import whisper as jwhisper
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro.serve import serve_step as jserve_step
from repro.serve import specdecode as jspec
from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.models import layers, whisper
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Gateway, LMAdapter, Request, SpecEngine
from repro_torch.serve import serve_step

from _config_fields import reference_view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-2  # the reference's decode tolerance (tests/test_system.py), bf16 values
LOGIT_REL = 0.05  # logits, relative to the largest
CUT = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, attn_chunk=24)
BATCH, MAX_SEQ, MAX_DEC_POS = 2, 24, 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _np(tree):
    """The reference's leaves as numpy, each of its own dtype (bf16 too)."""
    return jax.tree.map(np.asarray, tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(width, impl=None):
    """The reference's and the port's config: 'smoke' or 'cut', float
    (``impl`` None) or ``mma_int8`` on the kernel or Horner route."""
    jcfg, tcfg = jget_smoke_config("whisper_large_v3"), get_smoke_config("whisper_large_v3")
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
    PRNGKey(0) with ``max_dec_pos`` 32, int8 at ``min_dim=256`` when
    ``int8``."""
    key = (width, int8)
    if key not in _MODELS:
        jcfg, _ = _cfgs(width)
        jp = jwhisper.init_params(jax.random.PRNGKey(0), jcfg, max_dec_pos=MAX_DEC_POS)
        if int8:
            jp = jquant.quantize_params_int8(jp, min_dim=256)
        _MODELS[key] = (jp, whisper.params_from_jax(_np(jp), device="cpu"))
    return _MODELS[key]


def _frames(cfg, b=BATCH, seed=0):
    return np.random.default_rng(seed).standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)


_MEMORY = {}


def _memory(width, impl):
    """The reference's encoder memory (under ``_exact_jit``) as numpy
    float32 (exact bf16 values), shared by both packages' decoders."""
    key = (width, impl)
    if key not in _MEMORY:
        jcfg, _ = _cfgs(width, impl)
        jp, _ = _model(width, int8=impl is not None)
        m = _exact_jit(lambda p, f: jwhisper.encode(p, f, jcfg))(
            jp, jnp.asarray(_frames(jcfg)))
        _MEMORY[key] = _f32(m)
    return _MEMORY[key]


def _bf16(a):
    """A numpy float32 array (exact bf16 values) as a bf16 tensor."""
    return torch.tensor(a).to(torch.bfloat16)


def _assert_logits_close(got, want, msg=""):
    got, want = _f32(got), _f32(want)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= LOGIT_REL, f"logits differ by {rel} of the largest {msg}"
    return rel


def _layout(tree):
    return [(path, tuple(a.shape), str(a.dtype).replace("torch.", "")) for path, a in
            _leaves(tree)]


# ------------------------------------------------------------------- configs


def test_config_copies_match_the_reference():
    name = "whisper_large_v3"
    for t, j in ((get_config(name), jget_config(name)),
                 (get_smoke_config(name), jget_smoke_config(name))):
        td, jd = reference_view(t, j), dataclasses.asdict(j)
        assert td.pop("quant")["impl"] == "horner" and jd.pop("quant")["impl"] == "xla"
        assert td == jd
        assert t.hd == j.hd and t.family == "encdec"


# --------------------------------------------------------------- param trees


@pytest.mark.parametrize("width", ["smoke", "cut"])
def test_init_trees_equal_in_keys_shapes_and_dtypes(width):
    jcfg, tcfg = _cfgs(width)
    jp = jwhisper.init_params(jax.random.PRNGKey(0), jcfg, max_dec_pos=MAX_DEC_POS)
    tp = whisper.init_params(0, tcfg, device="cpu", max_dec_pos=MAX_DEC_POS)
    assert _layout(tp) == _layout(jp)
    # drawn layer by layer and quantized as drawn: the reference's int8 tree
    tq = whisper.init_params(0, tcfg, device="cpu", int8_min_dim=256, max_dec_pos=MAX_DEC_POS)
    assert _layout(tq) == _layout(jquant.quantize_params_int8(jp, min_dim=256))
    if width == "cut":  # every linear int8, as at full width
        assert ("dec_blocks", "cross_attn", "wk", "w_q") in dict(_leaves(tq))
        assert not [p for p, _ in _leaves(tq) if p[-1] == "w"]
    # the default table of decoder positions is the reference's 4096
    assert whisper.init_params(1, tcfg, device="cpu")["dec_pos"].shape == (4096, tcfg.d_model)


def test_params_from_jax_keeps_each_dtype():
    jp, tp = _model("cut", int8=True)
    assert [(p, _f32(a).tobytes()) for p, a in _leaves(tp)] == \
        [(p, np.asarray(a, np.float32).tobytes()) for p, a in _leaves(_np(jp))]
    blk = tp["dec_blocks"]["cross_attn"]["wq"]
    assert blk["w_q"].dtype == torch.int8 and blk["w_scale"].dtype == torch.float32
    assert tp["enc_pos"].dtype == tp["embed"]["table"].dtype == torch.bfloat16


# ---------------------------------------------------------------- components


@pytest.mark.parametrize("s,t", [(5, 5), (32, 32), (1, 32), (3, 40)])
def test_non_causal_attention_equals_the_reference(s, t):
    """``flash_attention(causal=False)``: the short-query path (S <= 8) and
    the chunked path (two ragged chunks), queries against keys of another
    length (cross-attention), bf16 inputs."""
    rng = np.random.default_rng(s * 100 + t)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, s, 4, 16), (2, t, 4, 16), (2, t, 4, 16)))
    want = jlayers.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                   causal=False, chunk=24)
    got = layers.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                 causal=False, chunk=24)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel"), ("cut", "horner")])
def test_encode_equals_the_reference(width, impl):
    jcfg, tcfg = _cfgs(width, impl)
    _, tp = _model(width, int8=impl is not None)
    got = whisper.encode(tp, _frames(tcfg), tcfg, device="cpu")
    assert got.shape == (BATCH, tcfg.enc_seq, tcfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _memory(width, impl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel"), ("cut", "horner")])
def test_precompute_cross_kv_equals_the_reference(width, impl):
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    mem = _memory(width, impl)
    want = _exact_jit(lambda p, m: jwhisper.precompute_cross_kv(p, m, jcfg))(
        jp, jnp.asarray(mem, jnp.bfloat16))
    got = whisper.precompute_cross_kv(tp, _bf16(mem), tcfg,
                                      device="cpu")
    for name in ("k", "v"):
        assert got[name].shape == (tcfg.n_layers, BATCH, tcfg.enc_seq, tcfg.n_kv_heads, tcfg.hd)
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got[name]), _f32(want[name]), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- decoding


@pytest.mark.parametrize("width,impl", [("smoke", "kernel"), ("cut", "kernel"),
                                        ("cut", "horner")])
def test_teacher_forced_decode_equals_the_reference(width, impl):
    """``make_decode``'s step with and without precomputed cross K/V: the
    port's two routes equal bit for bit, each within ``LOGIT_REL`` of the
    reference's step (with its own precomputed K/V), every call."""
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=True)
    mem = _memory(width, impl)
    jmem, tmem = jnp.asarray(mem, jnp.bfloat16), _bf16(mem)
    jx = _exact_jit(lambda p, m: jwhisper.precompute_cross_kv(p, m, jcfg))(jp, jmem)
    tx = whisper.precompute_cross_kv(tp, tmem, tcfg, device="cpu")
    tokens = np.random.default_rng(31).integers(0, 512, (BATCH, 8)).astype(np.int32)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    tdec, spec = serve_step.make_decode(tcfg, BATCH, MAX_SEQ, device="cpu")
    jc = jwhisper.init_cache(jcfg, BATCH, MAX_SEQ)
    tc = {True: whisper.init_cache(tcfg, BATCH, MAX_SEQ, device="cpu"),
          False: whisper.init_cache(tcfg, BATCH, MAX_SEQ, device="cpu")}
    assert _layout(spec) == _layout(jc) and spec["k"].device.type == "meta"
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(i), {"memory": jmem, "cross_kv": jx})
        with_kv, tc[True] = tdec(tp, tok, tc[True], i, {"memory": tmem, "cross_kv": tx})
        without, tc[False] = tdec(tp, tok, tc[False], i, {"memory": tmem})
        assert torch.equal(with_kv, without), f"step {i}: cross_kv and memory routes differ"
        _assert_logits_close(with_kv, jl, f"step {i}")
    for name in ("k", "v"):
        assert torch.equal(tc[True][name], tc[False][name])
        np.testing.assert_allclose(_f32(tc[True][name]), _f32(jc[name]), rtol=TOL, atol=TOL)


def test_dec_pos_clamps_past_the_table_as_the_reference():
    """Past ``max_dec_pos`` the reference's ``dynamic_slice_in_dim`` clamps
    its start to ``max_dec_pos - S``: decode at base 30 with S = 4 (table of
    32) reads positions 28-31, as at base 28."""
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _model("smoke", int8=False)
    mem = _memory("smoke", None)
    toks = np.random.default_rng(5).integers(0, 512, (BATCH, 4)).astype(np.int32)

    def run(base):
        jc, tc = jwhisper.init_cache(jcfg, BATCH, 40), whisper.init_cache(tcfg, BATCH, 40,
                                                                         device="cpu")
        jl, _ = _exact_jit(lambda p, t, c, m: jwhisper.decode_step(
            p, t, c, base, jcfg, memory=m))(jp, jnp.asarray(toks), jc,
                                            jnp.asarray(mem, jnp.bfloat16))
        tl, _ = whisper.decode_step(tp, toks, tc, base, tcfg,
                                    memory=_bf16(mem),
                                    device="cpu")
        return jl, tl

    assert _f32(whisper._dec_positions(tp["dec_pos"], 30, 4)).tobytes() == \
        _f32(tp["dec_pos"][28:32]).tobytes()
    for base in (28, 30, 100):
        jl, tl = run(base)
        _assert_logits_close(tl, jl, f"base {base}")
    # the clamp moves the positions only: the cache write lands at the base
    assert not torch.equal(run(30)[1], run(28)[1])


@pytest.mark.parametrize("width,impl", [("smoke", None), ("cut", "kernel")])
def test_make_prefill_equals_the_reference(width, impl):
    """Prefill encodes the frames, then decodes the prompt without a cache."""
    jcfg, tcfg = _cfgs(width, impl)
    jp, tp = _model(width, int8=impl is not None)
    frames = _frames(tcfg, seed=3)
    toks = np.random.default_rng(7).integers(0, 512, (BATCH, 6)).astype(np.int32)
    want = _exact_jit(lambda p, t, f: jserve_step.make_prefill(jcfg)(p, t, {"frames": f}))(
        jp, jnp.asarray(toks), jnp.asarray(frames))
    got = serve_step.make_prefill(tcfg, device="cpu")(tp, toks, {"frames": frames})
    assert got.shape == (BATCH, 6, 512) and got.dtype == torch.bfloat16
    _assert_logits_close(got, want)
    # forward is the same encode-then-decode on a batch dict
    fwd = whisper.forward(tp, {"frames": frames, "tokens": toks}, tcfg, device="cpu")
    assert torch.equal(fwd, got)


def test_loss_fn_equals_the_reference():
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _model("smoke", int8=False)
    frames = _frames(tcfg, seed=9)
    toks = np.random.default_rng(51).integers(0, 512, (BATCH, 9)).astype(np.int32)
    want, _ = _exact_jit(lambda p, f, t: jwhisper.loss_fn(p, {"frames": f, "tokens": t}, jcfg))(
        jp, jnp.asarray(frames), jnp.asarray(toks))
    got, metrics = whisper.loss_fn(tp, {"frames": frames, "tokens": toks}, tcfg, device="cpu")
    assert float(got) == pytest.approx(float(want), abs=TOL)
    assert float(metrics["nll"]) == float(got)


# ------------------------------------------------------------------ serving


def _requests(cls):
    """Three requests at batch 2: the third reuses the first freed slot."""
    rng = np.random.default_rng(41)
    return [cls(rid=i, prompt=rng.integers(0, 512, int(n)).astype(np.int32), max_new=4)
            for i, n in enumerate((3, 5, 2))]


def test_engine_streams_equal_the_reference_with_slot_reuse():
    """``Engine.run`` at batch 2 on the Horner route under the scalar index
    (quirk 5): every prefill call writes pad-token K/V into the other row
    at the prefilling slot's length, a step indexes every row at the
    largest active length, and the third request inherits its slot's
    length.  The engine projects the cross K/V from the memory it is given;
    streams and events equal the reference's."""
    jcfg, tcfg = _cfgs("cut", "horner")
    jp, tp = _model("cut", int8=True)
    mem = _memory("cut", "horner")
    jeng = jengine.Engine(jcfg, jp, batch=BATCH, max_seq=MAX_SEQ,
                          extras={"memory": jnp.asarray(mem, jnp.bfloat16)})
    jeng.decode_fn = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    jeng.obs = JRecordingSink()
    jdone = jeng.run(_requests(jengine.Request))
    extras = {"memory": _bf16(mem)}
    teng = Engine(tcfg, tp, batch=BATCH, max_seq=MAX_SEQ, extras=extras, device="cpu")
    assert teng.extras is extras and set(extras) == {"memory", "cross_kv"}
    assert torch.equal(extras["cross_kv"]["k"],
                       whisper.precompute_cross_kv(tp, extras["memory"], tcfg, device="cpu")["k"])
    teng.obs = RecordingSink()
    inherited = {}
    indices = []

    def admit_slot(req, inner=teng.admit_slot):
        before = teng.lengths.copy()
        ok = inner(req)
        if ok:
            slot = next(i for i, r in teng.slots.active() if r is req)
            assert teng.lengths[slot] == before[slot]  # not reset
            inherited[req.rid] = int(before[slot])
        return ok

    def decode(p, toks, cache, idx, ex, inner=teng.decode_fn):
        indices.append(idx)
        return inner(p, toks, cache, idx, ex)

    teng.admit_slot, teng.decode_fn = admit_slot, decode
    tdone = teng.run(_requests(Request))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 4 for r in tdone)
    assert teng.obs.canonical_bytes() == jeng.obs.canonical_bytes()
    assert inherited[2] > 0 and inherited[0] == inherited[1] == 0
    assert all(isinstance(i, int) for i in indices)  # one scalar index per call


def test_engine_without_memory_fails_at_decode_as_the_reference():
    jcfg, tcfg = _cfgs("smoke")
    jp, tp = _model("smoke", int8=False)
    jeng = jengine.Engine(jcfg, jp, batch=1, max_seq=8)
    teng = Engine(tcfg, tp, batch=1, max_seq=8, device="cpu")
    assert "cross_kv" not in jeng.extras and "cross_kv" not in teng.extras
    with pytest.raises(KeyError, match="memory"):
        jeng.run([jengine.Request(rid=0, prompt=np.array([1, 2], np.int32), max_new=1)])
    with pytest.raises(KeyError, match="memory"):
        teng.run([Request(rid=0, prompt=np.array([1, 2], np.int32), max_new=1)])
    with pytest.raises(ValueError, match="memory"):
        whisper.decode_step(tp, np.zeros((1, 1), np.int32),
                            whisper.init_cache(tcfg, 1, 8, device="cpu"), 0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="batch dict"):
        whisper.forward(tp, np.zeros((1, 2), np.int32), tcfg, device="cpu")


def test_gateway_lm_adapter_serves_with_extras():
    """The gateway's ``LMAdapter(extras=)`` serves Whisper unchanged, as in
    the reference: the same event bytes, ``stats()`` and streams (the
    reference's engine decodes under ``_exact_jit``)."""
    jcfg, tcfg = _cfgs("cut", "horner")
    jp, tp = _model("cut", int8=True)
    mem = _memory("cut", "horner")
    prompts = [r.prompt for r in _requests(Request)]
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "shared_decode",
                   lambda cfg, b, s: _exact_jit(jserve_step.make_decode(cfg, b, s)[0]))
        for gw_cls, ad_cls, cfg, params, sink, kw, extras in (
            (jgateway.Gateway, jgateway.LMAdapter, jcfg, jp, JRecordingSink(), {},
             {"memory": jnp.asarray(mem, jnp.bfloat16)}),
            (Gateway, LMAdapter, tcfg, tp, RecordingSink(), {"device": "cpu"},
             {"memory": _bf16(mem)}),
        ):
            ad = ad_cls(cfg, params, batch=BATCH, max_seq=MAX_SEQ, extras=extras, **kw)
            gw = gw_cls([ad], policy="fair", round_budget=60_000, sink=sink)
            reqs = [gw.submit("lm", p, max_new=4) for p in prompts]
            gw.drain(max_rounds=1_000)
            runs.append((gw, [list(r.handle.out) for r in reqs]))
    (jgw, jstreams), (tgw, tstreams) = runs
    assert tstreams == jstreams and all(len(s) == 4 for s in tstreams)
    assert tgw.sink.canonical_bytes() == jgw.sink.canonical_bytes()
    assert tgw.stats() == jgw.stats()


def test_spec_engine_refuses_encdec_as_the_reference():
    jcfg, tcfg = _cfgs("smoke", "horner")
    jp, tp = _model("smoke", int8=False)
    mem = _memory("smoke", None)
    with pytest.raises(ValueError, match="per-slot cache-index") as want:
        jspec.SpecEngine(jcfg, jp, batch=2, max_seq=16, draft_schedule=(2,) * 2, k=2,
                         extras={"memory": jnp.asarray(mem, jnp.bfloat16)})
    with pytest.raises(ValueError, match="per-slot cache-index") as got:
        SpecEngine(tcfg, tp, batch=2, max_seq=16, draft_schedule=(2,) * 2, k=2,
                   extras={"memory": _bf16(mem)}, device="cpu")
    assert str(got.value) == str(want.value)


def test_build_dispatches_encdec():
    _, tcfg = _cfgs("smoke", "kernel")
    assert models.build(tcfg) is whisper
    with pytest.raises(NotImplementedError, match="plane_schedule"):
        models.build(tcfg.replace(quant=QuantConfig(mode="mma_int8", plane_schedule=(6, 5))))


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg = _cfgs("smoke")
    _, tp = _model("smoke", int8=False)
    frames = _frames(tcfg, b=1)
    mem = torch.zeros((1, tcfg.enc_seq, tcfg.d_model), dtype=torch.bfloat16)
    for call in (lambda: whisper.init_params(0, tcfg),
                 lambda: whisper.encode(tp, frames, tcfg),
                 lambda: whisper.precompute_cross_kv(tp, mem, tcfg),
                 lambda: whisper.decode(tp, np.zeros((1, 2), np.int32), mem, tcfg),
                 lambda: whisper.forward(tp, {"frames": frames, "tokens": np.zeros((1, 2))},
                                         tcfg),
                 lambda: whisper.init_cache(tcfg, 1, 8),
                 lambda: whisper.decode_step(tp, np.zeros((1, 1), np.int32),
                                             whisper.init_cache(tcfg, 1, 8, device="cpu"), 0,
                                             tcfg, memory=mem),
                 lambda: whisper.loss_fn(tp, {"frames": frames, "tokens": np.zeros((1, 3))},
                                         tcfg),
                 lambda: serve_step.make_decode(tcfg, 1, 8),
                 lambda: Engine(tcfg, tp, batch=1, max_seq=8, extras={"memory": mem})):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


def test_whisper_modules_import_no_jax():
    """With jax made unimportable, the new modules import, and neither jax
    nor the reference package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.models.whisper, repro_torch.serve\n"
        "import repro_torch.configs.whisper_large_v3, repro_torch.configs.h2o_danube_3_4b\n"
        "import repro_torch.configs.granite_20b, repro_torch.configs.internvl2_76b\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and (m in ('repro', 'jax') or m.startswith(('repro.', 'jax.')))]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.models.whisper' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
