"""The long_500k decode cell (``configs.base.SHAPES``: 524,288 positions at
batch 1) on the CPU, the port against the JAX reference.

- ``layers.flash_attention``'s chunked pass walks only the key chunks some
  query row may see (``layers._live_chunks``).  A chunk that every row
  masks leaves the running max, sum and accumulator as they were, so the
  pass over the live chunks is bit-equal to the pass over them all (the
  reference's loop), held here on seeded q/k/v where most chunks are
  masked; and within ``ATTN_TOL`` of the reference's own pass (XLA and
  torch sum float32 in other orders: 3e-7 apart on these cases, as
  ``test_torch_lm.py``'s ``test_flash_attention_vs_reference`` allows).
- H2O-Danube3's smoke config (window 32) with a cache of the cell's
  524,288 positions: a 40-token prompt fed in calls of 8 tokens, then 8
  decode steps, the last at position 524,287, through ``make_decode`` on
  the float and the int8 kernel routes; each call's logits within 0.05 of
  the largest of the reference's (``_exact_jit``), the tolerance of
  ``test_torch_lm.py``'s decode tests.
- Zamba2-7B's smoke config at a 524,288-position state drawn from a numpy
  seed and given to both packages: 2 decode steps ending at 524,287, the
  logits and the new state within ``test_torch_zamba2.py``'s tolerances.

RWKV6-3B's state has no sequence dim (``rwkv6.decode_step`` drops its
cache index), so its long_500k step is its ordinary decode step, which
``test_torch_rwkv6.py`` holds.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_lm import ATTN_TOL, _exact_jit, _smoke_pair, _within
from test_torch_rwkv6 import LOGIT_TOL, _assert_logits_close, _f32
from test_torch_zamba2 import _cfgs as _zcfgs
from test_torch_zamba2 import _model as _zmodel

from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models import zamba2 as jzamba2
from repro.serve import serve_step as jserve_step
from repro_torch.configs.base import SHAPES
from repro_torch.models import layers
from repro_torch.serve import serve_step

LONG = SHAPES["long_500k"].seq_len  # 524,288


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def test_the_cell_is_524288_positions_at_batch_1():
    cell = SHAPES["long_500k"]
    assert (cell.seq_len, cell.global_batch, cell.kind) == (524_288, 1, "decode")


# ------------------------------------------------ RoPE near position 2**19

# the head dims the long cell's attention rotates: Danube's 120, Zamba2-7B's
# shared block's 224 (2 x 3584 / 32), the smoke configs' 32 and 64
ROPE_HEAD_DIMS = (32, 64, 120, 224)


@pytest.mark.parametrize("hd", ROPE_HEAD_DIMS)
def test_rope_at_the_cells_positions_vs_the_reference(hd):
    """Both packages rotate by ``positions * exp(-i * log(theta) / half)``
    in float32, but their float32 ``exp`` may differ by an ulp at some ``i``
    (torch's against XLA's, which itself differs run eagerly, jitted or
    constant-folded), and at position 524,287 one ulp of a frequency near 1
    turns the angle by up to 2**-5 rad: the rotated values part by at most
    ``|x|`` times that angle per frequency (and by float32 rounding), where
    at position 7 they agree to 1e-5."""
    half, theta = hd // 2, 10_000.0
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((1, 8, 2, hd)).astype(np.float32)
    tf = torch.exp(-torch.arange(0, half, dtype=torch.float32) * (np.log(theta) / half)).numpy()
    for jf in (np.asarray(jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half))),
               np.asarray(jax.jit(lambda: jnp.exp(
                   -jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))())):
        np.testing.assert_array_max_ulp(tf, jf, maxulp=1)
    for last, ulps in ((LONG, True), (8, False)):
        pos = np.arange(last - 8, last, dtype=np.int32)[None]
        want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
        gap = (last - 1) * np.spacing(tf).astype(np.float64) if ulps else np.zeros(half)
        bound = np.abs(x).max() * np.concatenate([gap, gap]) + 1e-5
        assert (np.abs(got - want) <= bound).all(), f"positions up to {last - 1}"


# --------------------------------------------------- chunk skipping, exact

# (q_offset, window, causal, the chunks walked) over 2,000 keys in 32 chunks
# of 64, 12 query rows: a window near the end of the keys, a causal prefix
# near their start, per-row offsets far apart (the chunks between their
# windows are walked too: the union's range), a non-causal window, rows that
# see no key at all
SKIP_CASES = {
    "window-at-the-end": (1950, 40, True, range(29, 31)),
    "causal-at-the-start": (30, 0, True, range(0, 1)),
    "per-row-offsets": ([1950, 700], 40, True, range(10, 31)),
    "non-causal-window": (1000, 40, False, range(15, 32)),
    "no-key-seen": ([-60, -40], 0, True, range(0)),
}


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_chunked_attention_skips_masked_chunks_bit_exactly(case, monkeypatch):
    q_offset, window, causal, chunks = SKIP_CASES[case]
    s = 12
    rng = np.random.default_rng(517)
    b = np.ndim(q_offset) and len(q_offset) or 1
    t, h, kv, d, chunk = 2000, 4, 2, 16, 64  # 32 chunks, the last one ragged
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    off = np.asarray(q_offset, np.int32)
    walked = []
    live = layers._live_chunks

    def counted(*a):
        walked.append(list(live(*a)))
        return live(*a)

    monkeypatch.setattr(layers, "_live_chunks", counted)
    got = layers.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=off, **kw)
    # the reference's loop: every chunk
    monkeypatch.setattr(layers, "_live_chunks", lambda off, s, t, chunk, *_: range(-(-t // chunk)))
    full = layers.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=off, **kw)
    assert torch.equal(got, full)
    assert walked == [list(chunks)]
    want = np.asarray(jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              q_offset=jnp.asarray(off), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_live_chunks_walks_every_chunk_on_the_meta_device():
    off = torch.tensor(1950, device="meta")
    assert layers._live_chunks(off, 12, 2000, 64, True, 40) == range(32)
    assert layers._live_chunks(torch.tensor(1950), 12, 2000, 64, True, 40) == range(29, 31)


def test_stack_drawn_equals_stacking_the_drawn_trees():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)

    def draw(g):
        return lambda: {"a": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                        "b": {"c": torch.randint(-128, 128, (2,), generator=g,
                                                 dtype=torch.int8)}}

    got = layers.stack_drawn(draw(g1), 5)
    want = layers.stack_trees([draw(g2)() for _ in range(5)])
    assert got["a"].dtype == torch.bfloat16 and got["b"]["c"].dtype == torch.int8
    assert torch.equal(got["a"], want["a"]) and torch.equal(got["b"]["c"], want["b"]["c"])


# ------------------------------------------- H2O-Danube3 at 524,288 positions


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_danube_decode_at_524288_positions_equals_the_reference(impl):
    """A 40-token prompt in calls of 8 tokens at 524,240..524,279, then 8
    steps at 524,280..524,287 (the cell's last position), window 32: every
    call reads the whole cache and masks all but the window's keys."""
    prompt, per_call, steps = 40, 8, 8
    jcfg, tcfg, jp, tp = _smoke_pair("h2o_danube_3_4b", impl)
    assert tcfg.swa_window == 32
    tokens = np.random.default_rng(524).integers(0, 512, (1, prompt + steps)).astype(np.int32)
    jfn = jserve_step.make_decode(jcfg, 1, LONG)[0]
    jdec = {n: _exact_jit(jfn) for n in (per_call, 1)}  # one build per call shape
    tdec, spec = serve_step.make_decode(tcfg, 1, LONG, device="cpu")
    jc = jtransformer.init_cache(jcfg, 1, LONG)
    tc = serve_step.init_serving_cache(tcfg, 1, LONG, device="cpu")
    assert tuple(tc["k"].shape) == tuple(spec["k"].shape) == (2, 1, LONG, 2, 32)
    pos = LONG - prompt - steps
    calls = [(i, per_call) for i in range(0, prompt, per_call)] + \
        [(prompt + i, 1) for i in range(steps)]
    for i, n in calls:
        x = tokens[:, i:i + n]
        jl, jc = jdec[n](jp, jnp.asarray(x), jc, jnp.int32(pos), {})
        tl, tc = tdec(tp, x, tc, pos, {})
        assert tl.shape == (1, n, 512)
        _within(tl, jl, msg=f"at {pos}")
        pos += n
    assert pos == LONG
    # the cache written where the reference writes it, nowhere else; layer
    # 0's keys (embedding, norm, wk and RoPE at positions near 2**19) at the
    # decode tolerance.  Layer 1's keys follow layer 0's attention, whose
    # bf16 scores over the 8-token calls' keys round the other way now and
    # then in the two packages (at short positions too): the logits hold that
    lo = LONG - prompt - steps
    np.testing.assert_allclose(_f32(tc["k"][0, :, lo:]), _f32(jc["k"][0, :, lo:]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert not tc["k"][:, :, :lo].any()


# --------------------------------------- Zamba2 at a 524,288-position state


def _bf16_noise(rng, shape):
    """Seeded noise on [-2, 2) in steps of 1/64 (int8 draws over 64: every
    value exact in bf16), as numpy bf16: a standard normal draw of these
    268 M values takes ~6 s per cache, this well under one."""
    a = rng.integers(-128, 128, shape, dtype=np.int8)
    return (a.astype(np.float32) * np.float32(1 / 64)).astype(ml_dtypes.bfloat16)


def _long_state(jcfg, seed):
    """Zamba2's decode state at 524,288 positions from a numpy seed, the
    reference's and the port's: the shared block's K/V caches and the conv
    windows bf16 noise on [-2, 2), the SSM states 0.1 of a standard normal
    (float32)."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype),
                          jax.eval_shape(lambda: jzamba2.init_state(jcfg, 1, LONG)))
    jst, tst = {}, {}

    def draw(shape_dtype):
        shape, dtype = shape_dtype
        if dtype == jnp.float32:
            a = (rng.standard_normal(shape, dtype=np.float32) * 0.1)
            return jnp.array(a), torch.from_numpy(a)
        # jnp.array copies: the port writes its caches in place
        a = _bf16_noise(rng, shape)
        return jnp.array(a), torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)

    for key in sorted(shapes):
        node = shapes[key]
        if isinstance(node, dict):
            pairs = {k: draw(node[k]) for k in sorted(node)}
            jst[key] = {k: p[0] for k, p in pairs.items()}
            tst[key] = {k: p[1] for k, p in pairs.items()}
        else:
            jst[key], tst[key] = draw(node)
    return jst, tst


@pytest.mark.parametrize("impl", [None, "kernel"])
def test_zamba2_decode_at_a_524288_position_state_equals_the_reference(impl):
    """2 decode steps at 524,286..524,287 from a seeded state: every step's
    shared block attends over all 524,288 keys of each group's cache."""
    steps = 2
    jcfg, tcfg = _zcfgs("smoke", impl)
    jp, tp = _zmodel("smoke", int8=impl is not None)
    jst, tst = _long_state(jcfg, 5242)
    assert tuple(tst["attn_k"].shape) == (2, 1, LONG, 4, 64)
    jdec = _exact_jit(jserve_step.make_decode(jcfg, 1, LONG)[0])
    tdec, _ = serve_step.make_decode(tcfg, 1, LONG, device="cpu")
    tokens = np.random.default_rng(2842).integers(0, 512, (1, steps)).astype(np.int32)
    for i in range(steps):
        idx = LONG - steps + i
        jl, jst = jdec(jp, jnp.asarray(tokens[:, i:i + 1]), jst, jnp.int32(idx), {})
        tl, tst = tdec(tp, tokens[:, i:i + 1], tst, idx, {})
        _assert_logits_close(tl, jl, f"step {i} at {idx}")
    for part in ("groups", "tail"):
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_f32(tst[part][name]), _f32(jst[part][name]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for name in ("attn_k", "attn_v"):
        np.testing.assert_allclose(_f32(tst[name][:, :, LONG - steps:]),
                                   _f32(jst[name][:, :, LONG - steps:]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # the seeded positions below the steps untouched in both
        assert np.array_equal(_f32(tst[name][:, :, :8]), _f32(jst[name][:, :, :8]))
