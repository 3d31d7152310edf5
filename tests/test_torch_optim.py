"""The port's optimizer pieces against the reference's, on the same numpy
inputs: the LR schedule, AdamW, error-feedback int8 compression and the
QAT ``fake_quant``.

Tolerances: the reference runs op by op (eager), as its source reads.
AdamW's master weights, moments and grad norm are held within one float32
ulp and its bf16 params bit for bit on gradients whose float32 sums are
exact in any order; the grad norm of arbitrary leaves to the reductions'
order (1e-6 relative).  The schedule's warmup bit for bit, its cosine to
one ulp of the cosine (see the test).  Compression and ``fake_quant``
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jschedule
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.core import quant
from repro_torch.optim import adamw, grad_compress, schedule


def _np(a) -> np.ndarray:
    """A reference array as numpy float32 (bf16 exactly) or its own dtype."""
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _t(a: torch.Tensor) -> np.ndarray:
    return (a.float() if a.dtype == torch.bfloat16 else a).numpy()


@pytest.mark.parametrize("peak_lr,warmup,total",
                         [(3e-4, 20, 200), (1e-3, 0, 64), (3e-4, 100, 10_000)])
def test_warmup_cosine_equals_the_reference(peak_lr, warmup, total):
    """The warmup steps bit for bit; the cosine steps within one ulp plus
    one ulp of the cosine carried through (the two packages' float32 ``cos``
    differ by an ulp on ~5% of arguments, and near the end of the decay
    ``1 + cos`` cancels, so that ulp, scaled by ``0.45 * peak_lr``, weighs up
    to ~4 ulp of an lr at its floor)."""
    steps = np.arange(0, total + 1, max(1, total // 500), dtype=np.int32)
    want = _np(jschedule.warmup_cosine(jnp.asarray(steps), peak_lr=peak_lr, warmup=warmup,
                                       total=total))
    got = schedule.warmup_cosine(torch.from_numpy(steps), peak_lr=peak_lr, warmup=warmup,
                                 total=total)
    assert got.dtype == torch.float32
    got = _t(got)
    warm = steps < warmup
    np.testing.assert_array_equal(got[warm], want[warm])
    bound = np.spacing(want[~warm]) + 0.45 * peak_lr * 2.0**-24
    assert (np.abs(got[~warm] - want[~warm]) <= bound).all()
    # a 0-d step, as the train step passes it
    one = schedule.warmup_cosine(torch.tensor(steps[3]), peak_lr=peak_lr, warmup=warmup,
                                 total=total)
    assert one.shape == () and _t(one) == got[3]


SHAPES = {"blocks": {"w": (3, 16, 8), "scale": (3, 16)}, "embed": {"table": (32, 16)},
          "head": {"w": (16, 32)}, "f32": {"decay": (4, 5)}}


def _params(rng):
    def leaf(path, shape):
        a = rng.standard_normal(shape).astype(np.float32) * 0.5
        return jnp.asarray(a, jnp.float32 if path == "f32" else jnp.bfloat16)
    return {k: {n: leaf(k, s) for n, s in v.items()} for k, v in SHAPES.items()}


def _to_torch(tree):
    """The reference's leaves as tensors of the same dtype (bf16 exactly)."""
    def leaf(a):
        t = torch.from_numpy(_np(a).copy())
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t
    return jax.tree.map(leaf, tree)


def _summable(rng, shape, scale, dtype):
    """Gradients whose squares and their sums are exact in float32 in any
    order: integers in [-128, 128) times ``scale`` (a power of two)."""
    return jnp.asarray(rng.integers(-128, 128, shape).astype(np.float32) * scale, dtype)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [True, False])
def test_adamw_update_within_one_ulp(grad_dtype, clipped):
    """Three updates on the same gradients, clipping active and inactive.
    The gradients sum exactly in any order, so both packages see the same
    grad norm (the float32 sums' order is the reduction's, held apart in
    ``test_global_norm_within_reduction_order``) and the rest is the same
    operations in the same order."""
    rng = np.random.default_rng(7)
    jparams = _params(rng)
    tparams = _to_torch(jparams)
    jstate, tstate = jadamw.init(jparams), adamw.init(tparams)
    assert tstate.step.dtype == torch.int32 and tstate.step.shape == ()
    gscale = 2.0**-10 if clipped else 2.0**-16
    for step in range(3):
        jgrads = jax.tree.map(lambda p: _summable(rng, p.shape, gscale, jnp.dtype(grad_dtype)),
                              jparams)
        tgrads = _to_torch(jgrads)
        lr = np.float32(3e-4 * (step + 1))
        jparams, jstate, jm = jadamw.update(jparams, jgrads, jstate, lr=jnp.asarray(lr))
        tparams, tstate, tm = adamw.update(tparams, tgrads, tstate, lr=torch.tensor(lr))
        assert (float(jm["grad_norm"]) > 1.0) == clipped
        np.testing.assert_array_max_ulp(_t(tm["grad_norm"]), _np(jm["grad_norm"]), maxulp=1)
        assert _t(tm["lr"]) == _np(jm["lr"])
        assert int(tstate.step) == int(jstate.step) == step + 1
        for name in ("master", "m", "v"):
            for got, want in zip(tree_leaves(getattr(tstate, name)),
                                 jax.tree.leaves(getattr(jstate, name))):
                assert got.dtype == torch.float32
                np.testing.assert_array_max_ulp(_t(got), _np(want), maxulp=1)
        for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
            if want.dtype == jnp.bfloat16:
                np.testing.assert_array_equal(_t(got), _np(want))
            else:
                np.testing.assert_array_max_ulp(_t(got), _np(want), maxulp=1)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_global_norm_within_reduction_order(grad_dtype):
    """Random leaves: each leaf's float32 sum of squares is reduced in
    another order by XLA and by torch, so the norms agree to the float32
    rounding of sums of a few hundred terms (1e-6 relative), and the leaves
    are taken in the reference's order (a leaf left out or counted twice
    moves the norm by far more)."""
    rng = np.random.default_rng(3)
    jtree = {"b": jnp.asarray(rng.standard_normal((7, 3)), grad_dtype),
             "a": {"y": jnp.asarray(rng.standard_normal(11) * 30, grad_dtype),
                   "x": jnp.asarray(rng.standard_normal((40, 25)), grad_dtype)},
             **_params(rng)}
    got, want = _t(adamw.global_norm(_to_torch(jtree))), _np(jadamw.global_norm(jtree))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [1.0, 1e-6, 0.0])
def test_compress_and_ef_step_equal_the_reference(scale):
    rng = np.random.default_rng(11)
    g = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
    err = (rng.standard_normal((64, 33)) * scale * 0.01).astype(np.float32)
    q, s = grad_compress.compress(torch.from_numpy(g))
    jq, js = jgc.compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _t(s) == _np(js)
    np.testing.assert_array_equal(_t(grad_compress.decompress(q, s)),
                                  _np(jgc.decompress(jq, js)))
    for gd in (jnp.float32, jnp.bfloat16):
        jg = jnp.asarray(g, gd)
        got = grad_compress.ef_step(_to_torch(jg), torch.from_numpy(err))
        want = jgc.ef_step(jg, jnp.asarray(err))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_t(a), _np(b))


def test_ef_tree_step_equals_the_reference():
    rng = np.random.default_rng(12)
    jgrads = _params(rng)
    jerr = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.01,
                                              jnp.float32), jgrads)
    got = grad_compress.ef_tree_step(_to_torch(jgrads), _to_torch(jerr))
    want = jgc.ef_tree_step(jgrads, jerr)
    for gt, wt in zip(got, want):
        for a, b in zip(tree_leaves(gt), jax.tree.leaves(wt)):
            np.testing.assert_array_equal(_t(a), _np(b))


@pytest.mark.parametrize("channel_axis", [None, -1, 0])
def test_fake_quant_forward_equals_the_reference(channel_axis):
    x = np.random.default_rng(4).standard_normal((16, 24)).astype(np.float32)
    got = quant.fake_quant(torch.from_numpy(x), channel_axis=channel_axis)
    want = jquant.fake_quant(jnp.asarray(x), channel_axis=channel_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fake_quant_gradient_passes_straight_through():
    """As ``tests/test_core.py`` holds it: d/dx sum(fake_quant(x)**2) is
    2 * fake_quant(x) (the quantization's own gradient is the identity)."""
    w = np.linspace(-1, 1, 32, dtype=np.float32)
    x = torch.from_numpy(w).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(quant.fake_quant(x) ** 2), x)
    want = jax.grad(lambda v: jnp.sum(jquant.fake_quant(v) ** 2))(jnp.asarray(w))
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g.numpy(), (2 * quant.fake_quant(x)).detach().numpy())
    # the identity on an arbitrary upstream gradient
    up = torch.from_numpy(np.random.default_rng(1).standard_normal(32).astype(np.float32))
    (g2,) = torch.autograd.grad(quant.fake_quant(x), x, grad_outputs=up)
    assert torch.equal(g2, up)
