"""The port's sharded serving steps on 8 CPU ranks against the reference's
own sharded steps and the port's unsharded ones.

Ranks: 8 processes (``torch.multiprocessing`` spawn, gloo, a ``file://``
rendezvous in the test's directory) on the (data 2, model 4) mesh, each
running ``_torch_ranks.serve_main`` once for the module; every join has a
time limit.  The reference side is subprocesses of
``_ref_parallel.py DIR serve:FAMILIES`` (8 forced host devices, Auto-typed
meshes, the ``EXACT`` compile options, ``jax.jit`` with
``launch.specs._build_prefill`` / ``_build_decode``'s shardings), run
beside the ranks.  Both read one ``inputs.npz``: the six LM families'
smoke weights drawn by the port (seed 0), float and pre-quantized
(``quantize_params_int8(min_dim=128)``), and tokens, patches and frames
drawn with numpy.

On the smoke Yi-6B (4 heads, 2 KV heads of 32) the model axis of 4 takes
the KV-head fallback, and a cache of 48 positions splits into slices of 12:
the writing prefill of 20 tokens spans two ranks' slices.

Routes: ``none`` (float weights, bf16 cache); ``int8`` (the dry run's
serving mode: ``mma_int8``, ``impl='int8'``, int8 weights and KV cache);
``kernel`` (the same on the kernel route, its plain version here), held to
the port's unsharded step only.

Held, per family and route, for the prefill (no cache), one writing
prefill (not Zamba2's: Mamba2 decodes one token per call) and the decode
steps:

- (a) logits within ``REF_REL`` of the largest of the reference's sharded
  step's (the cross-package tolerance of ``test_torch_whisper.py``);
- (b) every int32 product (a row-parallel one after its all-reduce; the
  scaled kernel's recomputed from its operands) bit-equal to the unsharded
  step's rows and columns: the first call's whole;
- (c) logits within ``UNSHARDED_REL`` of the largest of the port's
  unsharded step's (the partial-softmax combine reorders float sums);
- (d) layer 0's new cache or state after the first call bit-equal to the
  unsharded step's, on the quantized routes (no float reordering reaches
  it: the products are exact);
- (e) every call counted on meta tensors over the shape-only mesh at the
  rank's place: the live collectives exactly;
- (f) each rank's parameter and cache bytes equal ``specs.sharded_bytes``
  of their shardings (the dry run's ``argument_size_in_bytes``).

``moe_ffn_ep``'s body at a decode step that drops (the smoke OLMoE's
layer-0 MoE, ``EP_ROWS`` rows of one token) through the serving path's
``sharded_lm.moe_serve``, against the reference's ``moe_ffn_ep`` on the same
input: the routing exactly, the output within ``MOE_REL``.  (Served whole
with a writing prefill of its own, a router near tie that the two packages'
float sums break apart moves the capacity's drops, and the logits part.)

Extra cases: Zamba2 at batch 2, where ``cache_shardings``' rule splits the
group dim of its states over 'data' (the first dim equal to the batch), (a)
and (c); and the 2-D serving mode on the smoke Yi-6B, with
``serve_step.TWO_D_BYTES`` lowered to 0 inside the ranks, (c).  And the
dense and moe smoke models with a writing prefill of ``LONG_PROMPT`` tokens
into a cache of 192 positions (``FAMILY_long``): three attention chunks of
64 keys, each over two ranks' slices of 48, so the sharded attention must
take the unsharded pass's running max chunk by chunk; (a) to (f) (the moe
model's (a) position by position, its float route's prefill not by (c):
see ``LONG``).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.core.quant import quantize_params_int8

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 8
JOIN_S = 400
REF_PARTS = ("serve:dense,moe,vlm,dense_long,moe_long", "serve:ssm,encdec", "serve:hybrid")
REF_REL = 0.05
UNSHARDED_REL = 1e-2
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
ARCHS = {"dense": "yi_6b", "moe": "olmoe_1b_7b", "vlm": "internvl2_76b", "ssm": "rwkv6_3b",
         "hybrid": "zamba2_7b", "encdec": "whisper_large_v3"}
BATCH, PROMPT, STEPS = 4, 20, 4
LONG_PROMPT = 100  # the writing prefill over several attention chunks (``_torch_ranks.SERVE_LONG_SEQ``)
# moe_ffn_ep at a decode step: this many rows of one token
# (``_torch_ranks.SERVE_EP_ROWS``), each data rank's 12 routed whole at cap 4
EP_ROWS = 24
MOE_REL = 1e-2  # test_torch_distributed.py's: bf16 expert sums in other orders


def _flat(t, prefix=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if t.dtype == torch.bfloat16:
        t = t.float()
    return {prefix[:-1]: t.numpy()}


def _inputs(d: Path) -> None:
    inp = {}
    for family in FAMILIES:
        cfg = get_smoke_config(ARCHS[family])
        params = models.build(cfg).init_params(0, cfg, device="cpu")
        inp.update({f"{family}/f/{k}": v for k, v in _flat(params).items()})
        inp.update({f"{family}/q/{k}": v for k, v in
                    _flat(quantize_params_int8(params, min_dim=128)).items()})
    rng = np.random.default_rng(7)
    vocab = get_smoke_config("yi_6b").vocab
    for s in (16, 256):
        inp[f"serve/prefill_{s}"] = rng.integers(0, vocab, (BATCH, s)).astype(np.int32)
    inp["serve/prompt"] = rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    inp["serve/steps"] = rng.integers(0, vocab, (STEPS, BATCH, 1)).astype(np.int32)
    vcfg, wcfg = get_smoke_config("internvl2_76b"), get_smoke_config("whisper_large_v3")
    for name, shape in (("patches", (BATCH, vcfg.vlm_patches, vcfg.d_model)),
                        ("frames", (BATCH, wcfg.enc_seq, wcfg.d_model))):
        t = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
        inp[f"serve/{name}"] = t.to(torch.bfloat16).float().numpy()
    inp["serve/prompt_long"] = rng.integers(0, vocab, (BATCH, LONG_PROMPT)).astype(np.int32)
    mcfg = get_smoke_config("olmoe_1b_7b")
    x = torch.tensor(rng.standard_normal((EP_ROWS, 1, mcfg.d_model)), dtype=torch.float32)
    inp["serve/moe_x"] = x.to(torch.bfloat16).float().numpy()
    np.savez(d / "inputs.npz", **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    sys.path.insert(0, str(TESTS))
    import _torch_ranks

    # one 8-rank module at a time (_torch_ranks.rank_lock); the deadline
    # starts once the lock is held
    with _torch_ranks.rank_lock(tmp_path_factory.getbasetemp().parent):
        _inputs(d)
        env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": os.environ.get("HOME", str(d)), "JAX_PLATFORMS": "cpu"}
        refs = [subprocess.Popen([sys.executable, str(TESTS / "_ref_parallel.py"), str(d), part],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
                for part in REF_PARTS]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_torch_ranks.serve_main, args=(r, str(d)))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_S
        said = []
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for ref in refs:
                said.append(ref.communicate(timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            for ref in refs:
                if ref.poll() is None:
                    ref.kill()
                    ref.communicate()
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    for part, (out, err) in zip(REF_PARTS, said):
        assert "REF_OK" in out, part + out[-2000:] + err[-4000:]
    ref = {}
    for part in REF_PARTS:
        ref.update(np.load(d / f"ref_{part.replace(':', '_').replace(',', '_')}.npz"))
    return ref, [torch.load(d / f"serve{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rank_rows(t, out, n=BATCH):
    d = out["mesh"][1]
    per = n // 2
    return t[d * per:(d + 1) * per]


CASES = [(f, r) for f in FAMILIES for r in ("none", "int8", "kernel")]
EXTRA = [("hybrid_b2", "int8"), ("dense_2d", "int8")]
# a writing prefill of LONG_PROMPT tokens into a cache of 192 positions:
# three 64-key attention chunks, each spanning two ranks' slices of 48.
# The moe model's writing prefill routes 400 tokens, and a router whose
# k-th and (k+1)-th logits lie a few bf16 ulps apart swaps an expert on an
# ulp of its input (the port's own unsharded step moves by 0.50 of the
# largest logit at one such position when only its experts' products round
# once in float32 instead of in bf16 matmuls).  So (a) holds moe_long's
# calls position by position: every position within REF_REL but those at
# such a near tie (``_torch_ranks.router_ties``), at most TIE_PART of a
# call's positions (one at least).  Its float route's prefill
# (row-parallel float32 partial sums) is held by (a), (e) and (f); the
# rest of both by every check.
LONG = [(f"{f}_long", r) for f in ("dense", "moe") for r in ("none", "int8", "kernel")]
LONG_REF = [c for c in LONG if c[1] != "kernel"]
LONG_EXACT = [c for c in LONG if c != ("moe_long", "none")]
TIE_PART = 0.01


def test_meshes_are_data_2_model_4(runs):
    _, ranks = runs
    for r, out in enumerate(ranks):
        shape, d, m = out["mesh"]
        assert shape == {"data": 2, "model": 4} and (d, m) == divmod(r, 4)


@pytest.mark.parametrize("family,route", [c for c in CASES if c[1] != "kernel"]
                         + [("hybrid_b2", "int8")] + LONG_REF)
def test_logits_equal_the_reference_sharded_step(runs, family, route):
    """(a): the prefill's and every decode call's logits against the
    reference's sharded step on the same mesh; for moe, against the
    reference's unsharded step, as ``test_torch_distributed.py`` holds the
    moe train step: the reference's sharded ``moe_ffn`` rounds its partial
    sums otherwise (GSPMD), which moves near ties of the router, and the
    writing prefill's 80 tokens drop assignments (its logits part from its
    own unsharded step's by up to 0.41 of the largest on the float route).

    Zamba2's quantized prefill (the stateless forward at S = 256) is
    chaotic across the packages, as ``test_torch_zamba2.py`` finds it: one
    rounding that differs anywhere moves int8 levels everywhere downstream.
    Here the port's sharded prefill equals its unsharded one bit for bit
    (``test_logits_equal_the_unsharded_step``), and the port is held to
    depart from the reference's ``EXACT`` build no further than the
    reference's own plain ``jax.jit`` build does, on the largest difference
    and top-1 agreement.  moe_long's calls are held position by position
    (``LONG``)."""
    ref, ranks = runs
    key = f"{family}/{route}"
    rkey = f"{key}/whole" if family.startswith("moe") else key
    n = 2 if family == "hybrid_b2" else BATCH
    pkey = rkey.replace("_long", "")  # a long case's prefill (no cache) is its base family's
    for out in ranks:
        res = out[key]
        want = _rank_rows(ref[f"{pkey}/prefill"], out, n)
        got = res["prefill/logits"].numpy()
        if f"{rkey}/prefill_plain" in ref:
            plain = _rank_rows(ref[f"{rkey}/prefill_plain"], out, n)
            assert _rel(plain, want) > REF_REL  # the chaos this case is held against
            assert _rel(got, want) <= _rel(plain, want), (key, _rel(got, want), _rel(plain, want))
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= \
                (plain.argmax(-1) == want.argmax(-1)).mean()
        else:
            assert _rel(got, want) <= REF_REL, (key, "prefill")
        for i, step in enumerate(res["decode"]):
            want = _rank_rows(ref[f"{rkey}/decode{i}"], out, n)
            got = step["logits"].numpy()
            if "tie" not in step:
                assert _rel(got, want) <= REF_REL, (key, i)
                continue
            # moe_long: position by position, the partings only at near ties
            parts = np.abs(got - want).max(-1) / np.abs(want).max() > REF_REL
            tie = step["tie"].numpy()
            assert np.isfinite(got).all() and not (parts & ~tie).any(), (key, i, _rel(got, want))
            assert parts.sum() <= max(1, int(TIE_PART * parts.size)), (key, i, int(parts.sum()))


@pytest.mark.parametrize("family,route", CASES + EXTRA + LONG_EXACT)
def test_logits_equal_the_unsharded_step(runs, family, route):
    """(c): every decode call's logits within ``UNSHARDED_REL`` of the
    port's unsharded step's, and the prefill's too on the quantized routes.
    The float route's prefill is the training forward's layout, whose
    row-parallel products sum float32 partials where the unsharded product
    is one bf16 matmul: it is held at ``REF_REL`` (Zamba2's chaotic
    stateless forward parts most, 1.7e-2 seen)."""
    _, ranks = runs
    key = f"{family}/{route}"
    for out in ranks:
        res = out[key]
        tol = REF_REL if route == "none" else UNSHARDED_REL
        assert _rel(res["prefill/logits"], res["prefill/logits1"]) <= tol, (key, "prefill")
        for i, step in enumerate(res["decode"]):
            assert _rel(step["logits"], step["logits1"]) <= UNSHARDED_REL, (key, i)


# each call's int32 products in the first layer (the first layer of the
# encoder in Whisper's prefill): the attention's 4 and the MLP's 3 linears,
# MoE's experts bf16; RWKV6's ``mix_lora_a``, time mix 5, channel mix 3;
# Zamba2's Mamba2 layer 4; Whisper's decoder 8 (its cross K/V precomputed)
LAYER0 = {"dense": 7, "moe": 4, "vlm": 7, "ssm": 9, "hybrid": 4, "encdec": 8,
          "hybrid_b2": 4, "dense_2d": 7, "dense_long": 7, "moe_long": 4}
LAYER0_PREFILL = {**LAYER0, "encdec": 6}


@pytest.mark.parametrize("family,route", [c for c in CASES + LONG if c[1] != "none"] + EXTRA)
def test_layer0_int32_products_are_bit_equal(runs, family, route):
    """(b): every call's first-layer int32 products (a row-parallel one
    after its all-reduce) equal the unsharded step's rows and columns, and
    the prefill's every product."""
    _, ranks = runs
    key = f"{family}/{route}"
    for out in ranks:
        res = out[key]
        assert len(res["prefill/int32"]) > LAYER0_PREFILL[family]
        assert all(res["prefill/int32"]), (key, res["prefill/int32"])
        for i, step in enumerate(res["decode"]):
            assert len(step["int32"]) > LAYER0[family]
            assert all(step["int32"][:LAYER0[family]]), (key, i, step["int32"])


@pytest.mark.parametrize("family,route", [c for c in CASES + LONG if c[1] != "none"] + EXTRA)
def test_layer0_cache_is_bit_equal(runs, family, route):
    """(d): layer 0's new cache or state after the first call, gathered,
    equals the unsharded step's bit for bit (the K/V rows written; RWKV6's
    and Mamba2's states)."""
    _, ranks = runs
    for out in ranks:
        got = out[f"{family}/{route}"]["decode"][0]["cache0"]
        assert got and all(got.values()), got


@pytest.mark.parametrize("family,route", CASES + EXTRA + LONG)
def test_counting_mode_equals_the_live_collectives(runs, family, route):
    """(e): each call counted on meta tensors over the shape-only mesh at
    the rank's place issues the live collectives exactly."""
    _, ranks = runs
    key = f"{family}/{route}"
    for out in ranks:
        res = out[key]
        assert res["prefill/count"] == res["prefill/stats"]
        for step in res["decode"]:
            assert step["count"] == step["stats"]
            assert step["stats"]["total_count"] > 0
    # every rank of the mesh issued the same collectives
    assert all(o[key]["decode"][-1]["stats"] == ranks[0][key]["decode"][-1]["stats"]
               for o in ranks)


@pytest.mark.parametrize("family,route", CASES + EXTRA + LONG)
def test_state_bytes_equal_the_dry_runs(runs, family, route):
    """(f): each rank's parameter and cache bytes are what
    ``specs.sharded_bytes`` gives their shardings."""
    _, ranks = runs
    for out in ranks:
        res = out[f"{family}/{route}"]
        assert res["state_bytes"] == res["dry_bytes"]


def test_the_2d_mode_gathers_its_weights(runs):
    """The 2-D mode splits the weights over 'data' too, and the step
    all-gathers them over 'data' before use: more all-gathers than TP."""
    _, ranks = runs
    out = ranks[0]
    assert out["dense_2d/int8/mode"] == "2d" and out["dense/int8/mode"] == "tp"
    two_d = out["dense_2d/int8"]["decode"][-1]["stats"]["counts_by_kind"]
    tp = out["dense/int8"]["decode"][-1]["stats"]["counts_by_kind"]
    assert two_d["all-gather"] > tp["all-gather"]
    assert out["dense_2d/int8"]["state_bytes"] < out["dense/int8"]["state_bytes"]


def test_zamba2_batch_2_splits_the_groups_over_data(runs):
    """At batch 2 ``cache_shardings``' rule marks the first dim equal to the
    batch: Zamba2's group dim (2 groups).  The step reshards the states to
    its rows around each call (the gathers counted), and its values are
    the reference's (``test_logits_equal_the_reference_sharded_step``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.parallel.sharding import Mesh
    from repro_torch.serve import serve_step as ss

    cfg = get_smoke_config("zamba2_7b")
    mesh = Mesh({"data": 2, "model": 4}, device="meta")
    spec = ss.init_serving_cache(cfg, 2, 48, device="meta")
    sh = ss.cache_shardings(spec, cfg, mesh, 2, 48)
    assert tuple(sh["groups"]["ssm"].spec)[:3] == ("data", None, None)
    assert tuple(sh["attn_k"].spec)[:3] == ("data", None, "model")
    _, ranks = runs
    b2 = ranks[0]["hybrid_b2/int8"]["decode"][0]["stats"]["counts_by_kind"]
    b4 = ranks[0]["hybrid/int8"]["decode"][0]["stats"]["counts_by_kind"]
    assert b2["all-gather"] > b4["all-gather"]


def test_moe_ep_decode_with_drops_equals_the_reference(runs):
    """``moe_ffn_ep``'s body at a decode step (the smoke OLMoE's layer 0,
    ``moe.ep`` on, unquantized, ``EP_ROWS`` rows of one token) through the
    serving path's ``sharded_lm.moe_serve`` on the (data 2, model 4) mesh,
    against the reference's ``moe_ffn_ep`` on the same mesh and input: each
    data rank's 12 rows are one slab on every model rank (1 token does not
    split over 'model'), at cap 4 of 24 assignments, and the slabs drop.
    Each rank's routing (expert ids, positions, token order, kept mask,
    ``cap``) equals the reference's for its slab, and its output rows are
    within ``MOE_REL`` of the reference's."""
    ref, ranks = runs
    assert int(ref["moe_ep_decode/cap"]) == 4
    assert not all(ref[f"moe_ep_decode/{di}/keep"].all() for di in range(2))  # drops
    want = ref["moe_ep_decode/y"]
    for out in ranks:
        di = out["mesh"][1]
        (rt,) = out["moe_ep_decode/routes"]
        assert rt["cap"] == 4
        for k in ("eid", "pos", "tok", "keep"):
            assert np.array_equal(rt[k].numpy(), ref[f"moe_ep_decode/{di}/{k}"]), k
        got = out["moe_ep_decode/y"].numpy()
        assert got.shape == (EP_ROWS // 2, 1, want.shape[-1])
        assert _rel(got, _rank_rows(want, out, EP_ROWS)) <= MOE_REL


def test_serving_modules_import_no_jax():
    code = ("import sys; import repro_torch.serve.serve_step, repro_torch.parallel.sharded_lm; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
