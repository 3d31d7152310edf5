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
from repro_torch.serve import serve_step

from _config_fields import reference_view

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
            for n in ("yi_6b", "minitron_4b", "olmoe_1b_7b", "dbrx_132b", "h2o_danube_3_4b",
                      "granite_20b", "internvl2_76b")):
        td, jd = reference_view(t, j), dataclasses.asdict(j)
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


# Rows of the reference's RMSNorm that the port's rounds differently, at
# most: the reference's float32 rsqrt (XLA's CPU approximation) and mean
# (another summation order) differ from torch's in the last bit on many
# rows, and a row's output moves when that bit carries one of its d
# elements across a bf16 rounding boundary.  Measured on these draws:
# 0.10%, 0.17%, 0.68% and 2.0% of rows at d = 128, 256, 1280 and 4096.
RMSNORM_ROW_SHARE = 0.05


@pytest.mark.parametrize("d", [128, 256, 1280, 4096])
def test_rmsnorm_within_one_bf16_ulp_of_the_reference(d):
    """The port's ``rmsnorm`` against the reference's, run eagerly, on 4096
    random bf16 rows of widely varying scale: every element within one bf16
    ulp of the reference's, and fewer than ``RMSNORM_ROW_SHARE`` of the
    rows differing at all."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((4096, d)) * rng.uniform(0.1, 10, (4096, 1))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    want = np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale, jnp.bfloat16)},
                                      jnp.asarray(x, jnp.bfloat16), 1e-5).astype(jnp.float32))
    got = layers.rmsnorm({"scale": torch.tensor(scale).to(torch.bfloat16)},
                         torch.tensor(x).to(torch.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    nonzero = np.where(want != 0, np.abs(want), 1.0)
    ulp = np.where(want != 0, 2.0 ** (np.floor(np.log2(nonzero)) - 7), 0.0)  # 8-bit mantissa
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), f"{int((diff > ulp).sum())} elements more than one ulp apart"
    share = float((diff > 0).any(axis=1).mean())
    assert share < RMSNORM_ROW_SHARE, f"{share:.4f} of the rows differ"


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
    from repro_torch.models import rwkv6, whisper

    assert models.build(_tcfg()) is transformer
    # 'ssm' builds RWKV6; 'encdec' builds Whisper and serves a decode step
    assert models.build(_tcfg().replace(family="ssm", quant=QuantConfig())) is rwkv6
    wcfg = get_smoke_config("whisper_large_v3")
    assert models.build(wcfg) is whisper
    wp = whisper.init_params(0, wcfg, device="cpu", max_dec_pos=16)
    mem = torch.zeros((2, wcfg.enc_seq, wcfg.d_model), dtype=torch.bfloat16)
    wdec, _ = serve_step.make_decode(wcfg, 2, 8, device="cpu")
    wl, _ = wdec(wp, np.zeros((2, 1), np.int32), whisper.init_cache(wcfg, 2, 8, device="cpu"), 0,
                 {"memory": mem})
    assert wl.shape == (2, 1, 512) and bool(torch.isfinite(wl.float()).all())
    with pytest.raises(NotImplementedError, match="plane_schedule"):
        models.build(_tcfg().replace(family="ssm"))
    # 'moe' builds, draws its experts and serves a forward; so does 'vlm',
    # with its patch-embedding prefix
    mcfg = get_smoke_config("olmoe_1b_7b").replace(
        quant=QuantConfig(mode="mma_int8", impl="kernel", plane_schedule=SCHEDULE))
    assert models.build(mcfg) is transformer
    mp = transformer.init_params(0, mcfg, device="cpu", int8_min_dim=128)
    assert "moe" in mp["blocks"] and "mlp" not in mp["blocks"]
    assert mp["blocks"]["moe"]["w_gate"].shape == (2, 8, 128, 128)
    assert mp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16 and "w_q" in mp["head"]
    logits = transformer.forward(mp, np.zeros((2, 3), np.int32), mcfg, device="cpu")
    assert logits.shape == (2, 3, 512) and bool(torch.isfinite(logits.float()).all())
    vcfg = get_smoke_config("internvl2_76b")
    assert models.build(vcfg) is transformer
    vp = transformer.init_params(0, vcfg, device="cpu")
    prefix = torch.zeros((2, vcfg.vlm_patches, vcfg.d_model))
    logits = transformer.forward(vp, np.zeros((2, 3), np.int32), vcfg, prefix_embeds=prefix,
                                 device="cpu")
    assert logits.shape == (2, vcfg.vlm_patches + 3, 512)
    with pytest.raises(ValueError, match="not a transformer LM family"):
        transformer.init_params(0, wcfg, device="cpu")
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


# ------------------------- the vlm prefix and the last dense configs


def _smoke_pair(name, impl=None, **over):
    """A smoke config in both packages, float or on the int8 kernel route,
    and the reference's weights from PRNGKey(0) in both (int8 at
    ``min_dim=128`` on the kernel route: every linear of the smoke width)."""
    jcfg, tcfg = jget_smoke_config(name).replace(**over), get_smoke_config(name).replace(**over)
    if impl == "kernel":
        jcfg = jcfg.replace(quant=JQuantConfig(mode="mma_int8", impl="pallas", planes=6))
        tcfg = tcfg.replace(quant=QuantConfig(mode="mma_int8", impl="kernel", planes=6))
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    if impl == "kernel":
        jp = jquant.quantize_params_int8(jp, min_dim=128)
    return jcfg, tcfg, jp, transformer.params_from_jax(jax.tree.map(np.asarray, jp),
                                                       device="cpu")


def _within(got, want, rel=0.05, msg=""):
    """Logits within ``rel`` of the largest (the tolerance the port's other
    whole-model tests state: a bf16 ulp that rounds the other way moves an
    int8 level of the next per-tensor grid)."""
    got = got.to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    assert gap <= rel, f"logits differ by {gap} of the largest {msg}"


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_vlm_prefix_forward_and_loss_equal_the_reference(impl):
    """InternVL2's smoke config: ``forward`` with ``prefix_embeds`` (the
    stub frontend's patches before the tokens, positions over P + S) and
    ``loss_fn`` with ``patches`` (the prefix's logits dropped)."""
    jcfg, tcfg, jp, tp = _smoke_pair("internvl2_76b", impl)
    rng = np.random.default_rng(81)
    patches = rng.standard_normal((2, tcfg.vlm_patches, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    want = _exact_jit(lambda p, t, x: jtransformer.forward(p, t, jcfg, prefix_embeds=x))(
        jp, jnp.asarray(toks), jnp.asarray(patches))
    got = transformer.forward(tp, toks, tcfg, prefix_embeds=patches, device="cpu")
    assert got.shape == (2, tcfg.vlm_patches + 7, 512) and got.dtype == torch.bfloat16
    _within(got, want)
    # the prefix moves every token's logits (it is attended to)
    plain = transformer.forward(tp, toks, tcfg, device="cpu")
    assert not torch.equal(plain, got[:, tcfg.vlm_patches:])
    want_loss, _ = _exact_jit(lambda p, t, x: jtransformer.loss_fn(
        p, {"tokens": t, "patches": x}, jcfg))(jp, jnp.asarray(toks), jnp.asarray(patches))
    got_loss, metrics = transformer.loss_fn(tp, {"tokens": toks, "patches": patches}, tcfg,
                                            device="cpu")
    assert float(got_loss) == pytest.approx(float(want_loss), abs=LOGIT_TOL)
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("name,impl", [("h2o_danube_3_4b", None), ("h2o_danube_3_4b", "kernel"),
                                       ("granite_20b", None), ("granite_20b", "kernel")])
def test_dense_config_decode_equals_the_reference(name, impl):
    """Teacher-forced decode at batch 2 (rows two positions apart) on
    H2O-Danube3 (sliding window 32: 40 steps into a cache of 48, so the
    window drops keys) and Granite (MQA, one KV head; the GELU MLP with
    biases); then the stateless forward over the same tokens."""
    max_seq, steps = 48, 40
    jcfg, tcfg, jp, tp = _smoke_pair(name, impl)
    if name == "h2o_danube_3_4b":
        assert tcfg.swa_window == 32 < steps
    else:
        assert tcfg.n_kv_heads == 1 and tcfg.act == "gelu" and "b" in tp["blocks"]["mlp"]["w_up"]
    tokens = np.random.default_rng(91).integers(0, 512, (2, steps)).astype(np.int32)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, 2, max_seq)[0])
    jc = jtransformer.init_cache(jcfg, 2, max_seq)
    tc = transformer.init_cache(tcfg, 2, max_seq, device="cpu")
    lengths = np.array([0, 2], np.int32)
    for i in range(steps):
        jl, jc = jdec(jp, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.asarray(lengths), {})
        tl, tc = transformer.decode_step(tp, tokens[:, i:i + 1], tc, lengths, tcfg, device="cpu")
        _within(tl, jl, msg=f"step {i}")
        lengths = lengths + 1
    want = _exact_jit(lambda p, t: jtransformer.forward(p, t, jcfg))(jp, jnp.asarray(tokens))
    _within(transformer.forward(tp, tokens, tcfg, device="cpu"), want, msg="forward")


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
