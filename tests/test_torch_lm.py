"""The port's LM decode serving path against the JAX reference.

Yi-6B's smoke config widened as ``test_system.py`` widens it (d_model 256,
d_ff 512, 4 heads, 2 KV heads, head_dim 64, vocab 512, 2 layers).  After
``quantize_params_int8(min_dim=256)`` ``wq``/``wo``/the MLP/the head are
int8 and take the scaled kernel's path, while ``wk``/``wv`` (256x128) stay
bf16 and take the unscaled kernel's path through ``mma_linear``: both
kernels are exercised.  The reference's weights come across through
``transformer.params_from_jax``; the reference runs ``impl='pallas'`` in
interpret mode, the port ``impl='kernel'`` (its plain version on the CPU).

Tolerances: integer paths and the scaled epilogue are compared bit for bit.
Logits are compared at the reference's own decode tolerance
(``test_system.py``: atol = rtol = 1e-2).  Whole-model references are
compiled as their source reads (``_exact_jit``: XLA's excess precision and
its algebraic simplifier off).  By default a fused XLA computation may skip
the bf16 roundings the source writes between ops, or reassociate a scalar
multiply through a product, and the int8 activation quantization (with
plane truncation) turns one such changed rounding into a step of a whole
quantization level: 0.5 of logit on this model.  The port rounds where the
source rounds, as the reference run op by op does (``jax.disable_jit``,
too slow for this suite, agrees with ``_exact_jit`` here).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import quant as jquant
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.obs.events import RecordingSink as JRecordingSink
from repro.serve import engine as jengine
from repro.serve import serve_step as jserve_step
from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.core.plane_schedule import PlaneSchedule
from repro_torch.models import layers, transformer
from repro_torch.obs.events import RecordingSink
from repro_torch.serve import Engine, Request
from repro_torch.serve import engine as tengine

# The reference's decode tolerance (tests/test_system.py), for bf16 logits.
LOGIT_TOL = 1e-2
# Float32 attention on identical inputs: the two packages sum in another order.
ATTN_TOL = 1e-5
SCHEDULE = (6, 5)
BATCH, MAX_SEQ = 2, 32

WIDE = dict(d_model=256, d_ff=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab=512)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _np_tree(tree):
    """The reference's leaves as numpy: bf16 as float32 (exact), the rest as is."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree
    )


def _jcfg(impl="pallas", schedule=SCHEDULE):
    return jget_smoke_config("yi_6b").replace(
        **WIDE, quant=JQuantConfig(mode="mma_int8", impl=impl, plane_schedule=schedule))


def _tcfg(impl="kernel", schedule=SCHEDULE):
    return get_smoke_config("yi_6b").replace(
        **WIDE, quant=QuantConfig(mode="mma_int8", impl=impl, plane_schedule=schedule))


@pytest.fixture(scope="module")
def lm():
    jcfg = _jcfg()
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    jqp = jquant.quantize_params_int8(jparams, min_dim=256)
    tparams = transformer.params_from_jax(_np_tree(jparams), device="cpu")
    tqp = transformer.params_from_jax(_np_tree(jqp), device="cpu")
    return jparams, jqp, tparams, tqp


def _exact_jit(fn):
    """``fn`` jitted without excess precision or algebraic simplification,
    compiled at its first call's shapes (every later call must have the
    same)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                {"xla_allow_excess_precision": False, "xla_disable_hlo_passes": "algsimp"}))
        return compiled[0](*args)

    return call


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


# ----------------------------------------------------------------- configs


def test_config_copies_match_the_reference():
    for t, j in itertools.chain.from_iterable(
            ((get_config(n), jget_config(n)), (get_smoke_config(n), jget_smoke_config(n)))
            for n in ("yi_6b", "minitron_4b")):
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert td.pop("quant")["impl"] == "horner" and jd.pop("quant")["impl"] == "xla"
        assert td == jd
        assert t.hd == j.hd


# ---------------------------------------------------- (b) quantize_params_int8


def test_quantize_params_int8_equals_reference(lm):
    jparams, jqp, tparams, tqp = lm
    got = _leaves(quant.quantize_params_int8(tparams, min_dim=256))
    want = _leaves(jqp)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert ("blocks", "attn", "wk", "w") in dict(got)  # 256x128 stays float
    assert ("blocks", "mlp", "w_up", "w_q") in dict(got)
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b)
        a = a.to(torch.float32).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# ------------------------------------------------------------- (c) linear


@pytest.mark.parametrize("branch", ["w_q-kernel", "w_q-horner", "w-mma-kernel",
                                    "w-mma-horner", "w-float"])
def test_linear_every_branch(branch):
    rng = np.random.default_rng(21)
    w = (rng.standard_normal((256, 320)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, 2, 256)).astype(np.float32)
    x[1] *= 4.0  # rows of different amplitude: per-row vs per-tensor scales differ
    jw = {"w": jnp.asarray(w, jnp.bfloat16)}
    if branch.startswith("w_q"):
        jp = jquant.quantize_params_int8(jw, min_dim=256)
    else:
        jp = jw
    tp = transformer.params_from_jax(_np_tree(jp), device="cpu")
    impl = {"kernel": ("pallas", "kernel"), "horner": ("xla", "horner"), "float": None}[
        branch.rsplit("-", 1)[1]]
    if impl is None:
        jq, tq = JQuantConfig(), QuantConfig()
    else:
        jq = JQuantConfig(mode="mma_int8", impl=impl[0], planes=6)
        tq = QuantConfig(mode="mma_int8", impl=impl[1], planes=6)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jlayers.linear(jp, jx, jq).astype(jnp.float32))
    got = layers.linear(tp, torch.from_numpy(x).to(torch.bfloat16), tq)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 2, 320)
    got = got.to(torch.float32).numpy()
    if branch.startswith("w_q"):
        # int8 operands, int32 product and the f32 scale products are the same
        # IEEE operations in both packages: equal bit for bit
        np.testing.assert_array_equal(got, want)
    else:
        # the float product x @ w (in mma_linear's straight-through form too)
        # sums over K in another order: within one bf16 rounding
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_linear_kernel_routes(monkeypatch):
    """w_q under impl='kernel' takes the scaled kernel with one scale per
    tensor; float w under mma_int8 takes the unscaled kernel."""
    from repro_torch.kernels import ops

    seen = []
    real_s, real_u = ops.mma_matmul_scaled, ops.mma_matmul
    monkeypatch.setattr(ops, "mma_matmul_scaled",
                        lambda *a, **k: seen.append(("scaled", a[2].numel())) or real_s(*a, **k))
    monkeypatch.setattr(ops, "mma_matmul", lambda *a, **k: seen.append(("unscaled",)) or real_u(*a, **k))
    x = torch.randn((2, 1, 256), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    q = QuantConfig(mode="mma_int8", impl="kernel")
    layers.linear(quant.quantize_params_int8({"w": w}), x, q)
    layers.linear({"w": w}, x, q)
    assert seen == [("scaled", 1), ("unscaled",)]


# ---------------------------------------------------- (d) flash attention


@pytest.mark.parametrize("case", ["decode", "decode-window", "chunked", "chunked-window"])
def test_flash_attention_vs_reference(case):
    rng = np.random.default_rng(31)
    s = 4 if case.startswith("decode") else 16
    b, t, h, kv, d = 3, 20, 4, 2, 16
    window = 5 if case.endswith("window") else 0
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    # per-row offsets; the last row sees no key at all — a fully masked row:
    # chunked, its queries lie at negative positions; decode, at 40..43,
    # past a 5-key window over 20 keys (without the window it sees them all)
    offsets = np.array([3, 10, -30] if s > 8 else [3, 16, 40], np.int32)
    kw = dict(causal=True, window=window, chunk=8)
    for q_offset in (offsets, 2):
        want = np.asarray(jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  q_offset=jnp.asarray(q_offset), **kw))
        got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), q_offset=q_offset, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL, equal_nan=True)
        if np.ndim(q_offset) and s > 8:
            assert (got[2] == 0).all()  # the chunked path's all-masked row is 0
        elif np.ndim(q_offset) and window:
            assert np.isnan(got[2]).all()  # the short-query path's is NaN


# ------------------------------------------- (h) cache write clamp at S_max


@pytest.mark.parametrize("index", [7, [6, 2]])
def test_cache_write_clamps_at_s_max(index):
    """A write that would run past S_max lands on the last s positions, as
    ``dynamic_update_slice`` clamps it in the reference."""
    rng = np.random.default_rng(41)
    cfg = get_smoke_config("yi_6b").replace(**WIDE)
    jcfg = jget_smoke_config("yi_6b").replace(**WIDE)
    p = {name: {"w": (rng.standard_normal((256, n)) * 0.05).astype(np.float32)}
         for name, n in (("wq", 256), ("wk", 128), ("wv", 128), ("wo", 256))}
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    pos = np.asarray(index).reshape(-1, 1) + np.arange(3)[None, :]
    c0 = np.zeros((2, 8, 2, 64), np.float32)
    jout, (jk, jv) = jlayers.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        cache=(jnp.asarray(c0), jnp.asarray(c0)), cache_index=jnp.asarray(index))
    tp = jax.tree.map(torch.from_numpy, p)
    ck, cv = torch.from_numpy(c0.copy()), torch.from_numpy(c0.copy())
    tout, (tk, tv) = layers.attention(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                                      cache=(ck, cv), cache_index=index)
    assert tk is ck  # updated in place
    for a, bb in ((tk, jk), (tv, jv)):
        a, bb = a.numpy(), np.asarray(bb)
        np.testing.assert_array_equal(a != 0, bb != 0)  # the same positions written
        np.testing.assert_allclose(a, bb, rtol=ATTN_TOL, atol=ATTN_TOL)
    written = (tk.numpy() != 0).any(axis=(2, 3))
    starts = np.minimum(np.broadcast_to(np.asarray(index), (2,)), 8 - 3)
    for r in range(2):
        assert written[r].nonzero()[0].tolist() == list(range(starts[r], starts[r] + 3))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=ATTN_TOL, atol=ATTN_TOL)


# ----------------------------------------- (e) teacher-forced decode_step


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_teacher_forced_decode_logits(lm, kv):
    _, jqp, _, tqp = lm
    jcfg, tcfg = _jcfg(), _tcfg()
    tokens = np.random.default_rng(51).integers(0, 512, (BATCH, 12)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if kv == "bf16" else (jnp.int8, torch.int8)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, BATCH, MAX_SEQ)[0])
    jc = jtransformer.init_cache(jcfg, BATCH, MAX_SEQ, dtype=jdt)
    tc = transformer.init_cache(tcfg, BATCH, MAX_SEQ, dtype=tdt, device="cpu")
    # rows at different lengths: row 1 starts 2 positions later
    lengths = np.array([0, 2], np.int32)
    for i in range(12):
        jl, jc = jdec(jqp, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.asarray(lengths), {})
        tl, tc = transformer.decode_step(tqp, tokens[:, i:i + 1], tc, lengths, tcfg, device="cpu")
        want = np.asarray(jl.astype(jnp.float32))
        got = tl.to(torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=f"step {i}")
        lengths = lengths + 1
    assert tc["k"].dtype == tdt


# ------------------------------------------------------- (f) Engine.run


def _requests(cls):
    rng = np.random.default_rng(61)
    return [cls(rid=i, prompt=rng.integers(0, 512, int(n)).astype(np.int32), max_new=4)
            for i, n in enumerate((3, 6, 4, 5))]


def test_engine_run_matches_reference(lm):
    _, jqp, _, tqp = lm
    jeng = jengine.Engine(_jcfg(), jqp, batch=BATCH, max_seq=MAX_SEQ)
    jeng.decode_fn = _exact_jit(jserve_step.make_decode(_jcfg(), BATCH, MAX_SEQ)[0])
    jeng.obs = JRecordingSink()
    jdone = jeng.run(_requests(jengine.Request))
    teng = Engine(_tcfg(), tqp, batch=BATCH, max_seq=MAX_SEQ, device="cpu")
    teng.obs = RecordingSink()
    tdone = teng.run(_requests(Request))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 4 for r in tdone)
    assert [(e.cycle, e.etype, e.data) for e in teng.obs.events] == \
        [(e.cycle, e.etype, e.data) for e in jeng.obs.events]
    assert {e.etype for e in teng.obs.events} == {"lm-prefill", "lm-step"}


# ------------------------------------------------ (g) the plane schedule


def test_lm_schedule_from_params_matches_reference(lm):
    jparams, _, tparams, tqp = lm
    for target in (0.05, 0.01):
        want = jengine.lm_schedule_from_params(jparams, _jcfg(), target)
        got = tengine.lm_schedule_from_params(tparams, _tcfg(), target)
        assert got.planes == want.planes
        assert got.layer_bounds == pytest.approx(want.layer_bounds, rel=1e-6)
        # from the served int8 leaves: the same budgets (quantize_weights and
        # quantize_params_int8 give the same int8 for a (K, N) weight)
        wq = tqp["blocks"]["mlp"]["w_up"]["w_q"]
        assert PlaneSchedule.from_weights([wq[l] for l in range(2)], target).planes == got.planes


def test_models_build_and_families():
    assert models.build(_tcfg()) is transformer
    with pytest.raises(NotImplementedError):
        models.build(_tcfg().replace(family="ssm", quant=QuantConfig()))
    with pytest.raises(NotImplementedError, match="plane_schedule"):
        models.build(_tcfg().replace(family="ssm"))
    for fam in ("moe", "vlm"):
        with pytest.raises(NotImplementedError, match="later slice"):
            transformer.init_params(0, _tcfg().replace(family=fam), device="cpu")
    with pytest.raises(NotImplementedError):
        tengine.lm_schedule_from_params({}, _tcfg().replace(family="ssm"), 0.05)


def test_seeded_init_and_int8_build():
    cfg = _tcfg()
    a = transformer.init_params(3, cfg, device="cpu")
    b = transformer.init_params(3, cfg, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))
    assert a["blocks"]["mlp"]["w_up"]["w"].shape == (2, 256, 512)
    assert float(a["blocks"]["mlp"]["w_up"]["w"].float().abs().max()) <= 2.0 / 16 + 1e-3
    q = transformer.init_params(3, cfg, device="cpu", int8_min_dim=256)
    want = quant.quantize_params_int8(a, min_dim=256)
    assert [p for p, _ in _leaves(q)] == [p for p, _ in _leaves(want)]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(q), _leaves(want)))


def test_loss_fn_vs_reference(lm):
    jparams, _, tparams, _ = lm
    toks = np.random.default_rng(71).integers(0, 512, (2, 9)).astype(np.int32)
    jcfg = _jcfg(impl="xla", schedule=None).replace(quant=JQuantConfig())
    want, _ = jtransformer.loss_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, metrics = transformer.loss_fn(tparams, {"tokens": toks},
                                       _tcfg(schedule=None).replace(quant=QuantConfig()),
                                       device="cpu")
    assert float(got) == pytest.approx(float(want), abs=LOGIT_TOL)
    assert float(metrics["aux"]) == 0.0


def test_lm_entry_points_without_device_raise_without_a_card(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, _, tqp = lm
    cfg = _tcfg()
    with pytest.raises(RuntimeError, match="CUDA card"):
        transformer.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        transformer.forward(tqp, np.zeros((1, 2), np.int32), cfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        Engine(cfg, tqp, batch=1, max_seq=8)
