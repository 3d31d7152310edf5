"""The port's parallel layer on 8 CPU ranks against the reference's own
sharded runs.

Ranks: 8 processes (``torch.multiprocessing`` spawn, gloo, a ``file://``
rendezvous in the test's directory), each running ``_torch_ranks.rank_main``
once for the whole module; every join has a time limit, and a rank still
alive at it is killed and fails the module.  The reference side is one
subprocess (``_ref_parallel.py``: 8 forced host devices, Auto-typed meshes,
``JAX_PLATFORMS=cpu``), run beside the ranks.  Both read the same inputs:
Yi-6B's, OLMoE's and InternVL2's smoke weights drawn by the port (seed 0),
the tokens and the gradients of the reference's own ``test_distributed.py``
and the vlm's patches, drawn with numpy.

Tolerances, each against what it compares:

- the train step (mesh (4, 2)): loss within ``LOSS_REL`` and ``grad_norm``
  within ``NORM_REL`` of the reference's sharded step and of the port's
  unsharded step; every new param within ``PARAM_ATOL`` (one step at the
  schedule's first learning rate, 3e-6: a param moves by at most ~3e-6, so a
  wrong update shows);
- every int32 product of the sharded step (a row-parallel one after its
  all-reduce) equal bit for bit to the unsharded step's rows and columns;
- compressed sync: ``synced`` and ``err`` within 1e-6 of the reference's,
  and the reference test's two bounds;
- elastic restore (4, 2) -> (2, 4): bit-equal;
- ``moe_ffn_ep``: routing exact per slab, output within ``MOE_REL`` of the
  reference's ``moe_ffn_ep`` and the port's ``moe_ffn``;
- the pipeline (PP 2 x DP 4), at one and at two layers per stage: loss
  within ``LOSS_REL`` of the reference's ``pipelined_loss_fn`` and of the
  port's unsharded ``loss_fn``; its gradients within 2e-2 of the unsharded
  ones (the reference's own pipeline bound);
- the moe (``moe.ep`` off and on) and vlm smoke steps: loss within
  ``LOSS_REL``, grad_norm within ``NORM_REL`` (see
  ``test_sharded_family_step_equals_the_reference`` for which step each is
  held to); int32 products bit-equal; ``moe_ffn``'s routing on 4 data
  ranks equal to the reference's whole-batch routing; the global aux
  within 1e-6 and its router gradient within ``MOE_REL`` (bf16 partial
  sums);
- every step counted on meta tensors over a shape-only mesh at the rank's
  coordinates: the live step's collectives exactly.
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
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 8
# every rank and reference subprocess: a guard against a hang, counted from
# when the fixture holds the 8-rank lock.  Alone the module's ranks and
# references take ~170 s; under the suite's `-n 6 --dist loadfile` beside
# four other workers they took 290-303 s, past the 300 s this was
JOIN_S = 600
# the reference's side in three concurrent subprocesses (its compiles are
# the file's long pole: the hybrid step's about 50 s each)
REF_PARTS = ("base", "ssm,encdec", "hybrid")
LOSS_REL = 1e-3
NORM_REL = 1e-3
PARAM_ATOL = 1e-5
MOE_REL = 1e-2
# float32 gradients, sharded against unsharded, relative to each leaf's
# largest element: a missing or doubled share shows as O(1).  Seen: 1.4e-6
# (ssm, encdec) and 1.1e-4 (hybrid: Mamba2's a_log and dt_bias gradients
# are sums with cancellation, 1e-2 against terms near 1, and the SSD's
# float32 reductions regroup with the heads a rank holds; splitting the
# heads in two in the unsharded forward alone moves a_log's by 2.4e-5)
F32_GRAD_REL = 1e-3
# RWKV6's bf16 grad_norm (see test_sharded_family_step_equals_the_reference):
# test_torch_train_families.py's NORM_REL, which holds it across the packages
RWKV6_NORM_REL = 2e-2


def _flat(t, prefix=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: t.float().numpy()}


def _inputs(d: Path) -> None:
    cfg = get_smoke_config("yi_6b")
    mcfg = get_smoke_config("olmoe_1b_7b")
    params = transformer.init_params(0, cfg, device="cpu")
    mparams = moe_lib.init_moe(torch.Generator().manual_seed(3), mcfg, device="cpu")
    rng = np.random.default_rng(0)  # the reference test's draws, in its order
    inp = {**{f"p/{k}": v for k, v in _flat(params).items()},
           **{f"m/{k}": v for k, v in _flat(mparams).items()}}
    for arch in ("olmoe_1b_7b", "internvl2_76b", "rwkv6_3b", "zamba2_7b", "whisper_large_v3"):
        fcfg = get_smoke_config(arch)  # the moe, vlm, ssm, hybrid and encdec models, whole
        inp.update({f"{fcfg.family}/{k}": v
                    for k, v in _flat(models.build(fcfg).init_params(0, fcfg, device="cpu")).items()})
    inp["g_local"] = rng.standard_normal((8, 128)).astype(np.float32)
    inp["tokens"] = rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)
    xm = torch.tensor(rng.standard_normal((4, 16, mcfg.d_model)) * 0.1, dtype=torch.float32)
    inp["xm"] = xm.to(torch.bfloat16).float().numpy()
    vcfg = get_smoke_config("internvl2_76b")
    patches = torch.tensor(rng.standard_normal((8, vcfg.vlm_patches, vcfg.d_model)),
                           dtype=torch.float32)
    inp["patches"] = patches.to(torch.bfloat16).float().numpy()
    # the hybrid's sequence is one SSD chunk (mamba2.CHUNK); the encdec's frames
    inp["tokens_257"] = rng.integers(0, cfg.vocab, (8, 257)).astype(np.int32)
    wcfg = get_smoke_config("whisper_large_v3")
    frames = torch.tensor(rng.standard_normal((8, wcfg.enc_seq, wcfg.d_model)), dtype=torch.float32)
    inp["frames"] = frames.to(torch.bfloat16).float().numpy()
    # the pipeline at two layers per stage: the smoke Yi-6B at 4 layers
    cfg4 = cfg.replace(n_layers=4)
    inp.update({f"pp4/{k}": v for k, v in _flat(transformer.init_params(0, cfg4, device="cpu")).items()})
    np.savez(d / "inputs.npz", **inp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
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
        procs = [ctx.Process(target=_torch_ranks.rank_main, args=(r, str(d)))
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
    ref = {k: v for part in REF_PARTS for k, v in np.load(d / f"ref_{part}.npz").items()}
    return (ref, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
            dict(np.load(d / "inputs.npz")))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def test_meshes_lay_ranks_out_row_major(runs):
    _, ranks, _ = runs
    for r, out in enumerate(ranks):
        shape, d, m = out["mesh"]
        assert shape == {"data": 4, "model": 2} and (d, m) == divmod(r, 2)


@pytest.mark.parametrize("quant", ["none", "horner"])
def test_sharded_step_loss_and_norm_equal_the_reference(runs, quant):
    ref, ranks, _ = runs
    for out in ranks:
        assert _rel(out[f"{quant}/loss"], ref[f"{quant}/loss"]) < LOSS_REL
        assert _rel(out[f"{quant}/loss"], out[f"{quant}/loss1"]) < LOSS_REL
        assert _rel(out[f"{quant}/grad_norm"], ref[f"{quant}/grad_norm"]) < NORM_REL
        assert _rel(out[f"{quant}/grad_norm"], out[f"{quant}/grad_norm1"]) < NORM_REL
    # the step's metrics are equal on every rank
    assert len({out[f"{quant}/loss"] for out in ranks}) == 1
    assert len({out[f"{quant}/grad_norm"] for out in ranks}) == 1


@pytest.mark.parametrize("quant", ["none", "horner"])
def test_sharded_step_params_equal_the_reference(runs, quant):
    ref, ranks, _ = runs
    got = _flat(ranks[0][f"{quant}/params"])
    unsharded = _flat(ranks[0][f"{quant}/params1"])
    assert sorted(got) == sorted(k[len(quant) + 3:] for k in ref if k.startswith(f"{quant}/p/"))
    for k, v in got.items():
        assert np.abs(v - ref[f"{quant}/p/{k}"]).max() <= PARAM_ATOL, k
        assert np.abs(v - unsharded[k]).max() <= PARAM_ATOL, k
    for out in ranks[1:]:  # gathered, every rank holds the same params
        for a, b in zip(tree_leaves(out[f"{quant}/params"]), tree_leaves(ranks[0][f"{quant}/params"])):
            assert torch.equal(a, b)


def test_sharded_int32_products_are_bit_equal_to_unsharded(runs):
    _, ranks, _ = runs
    for out in ranks:
        rec = out["int32"]
        # 15 forward products (2 x 7 linears, the head), 14 again in remat
        assert rec["n"] == (29, 29)
        assert all(rec["equal"]), rec["equal"]
    # column-parallel outputs are the rank's columns; row-parallel ones whole
    shapes = ranks[0]["int32"]["shapes"]
    assert shapes[0] == (2, 32, 64) and shapes[3] == (2, 32, 128) and shapes[14] == (2, 32, 256)


@pytest.mark.parametrize("quant", ["none", "horner"])
def test_sharded_step_collectives(runs, quant):
    _, ranks, _ = runs
    stats = ranks[0][f"{quant}/stats"]
    assert sorted(stats) == ["bytes_by_kind", "counts_by_kind", "total_bytes", "total_count"]
    assert stats["total_count"] == sum(stats["counts_by_kind"].values())
    assert stats["total_bytes"] == sum(stats["bytes_by_kind"].values())
    assert set(stats["counts_by_kind"]) <= {"all-reduce", "all-gather"}
    assert stats["counts_by_kind"]["all-reduce"] > 0
    # every rank issued the same collectives
    assert all(out[f"{quant}/stats"] == stats for out in ranks)


def test_elastic_restore_is_bit_equal(runs):
    _, ranks, _ = runs
    for out in ranks:
        assert out["elastic/w"] and out["elastic/state"]
    # under (2, 4) the model-split leaves are a quarter wide: wq (2, 128, 32)
    assert (2, 128, 32) in ranks[0]["elastic/local_shapes"]


def test_compressed_sync_equals_the_reference(runs):
    ref, ranks, inp = runs
    synced = np.stack([out["gc/synced"].numpy() for out in ranks], axis=1)  # (20, 8, 128)
    err = np.concatenate([out["gc/err"].numpy() for out in ranks])
    np.testing.assert_allclose(synced, ref["gc/synced"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(err, ref["gc/err"], rtol=0, atol=1e-6)
    # every rank holds the same mean
    assert all(np.array_equal(synced[:, r], synced[:, 0]) for r in range(WORLD))
    # the reference test's bounds, on the port's run
    g_local = inp["g_local"]
    exact_mean = g_local.mean(axis=0)
    bound = float(np.abs(g_local).max()) / 127
    assert float(np.abs(synced[0, 0] - exact_mean).max()) < bound * 1.01 + 1e-6
    drift = float(np.abs(synced[:, 0].sum(axis=0) - 20 * exact_mean).max())
    assert drift < bound * 2.5, drift
    # only the int8 payload and the scales cross the ranks
    stats = ranks[0]["gc/stats"]
    assert stats["counts_by_kind"] == {"all-gather": 40}
    assert stats["bytes_by_kind"] == {"all-gather": 20 * (128 + 4)}


def test_moe_ep_routing_and_output_equal_the_reference(runs):
    ref, ranks, _ = runs
    slabs = set()
    for out in ranks:
        di, r = out["moe/slab"]
        slabs.add((di, r))
        for k, v in out["moe/route"].items():
            assert np.array_equal(v.numpy(), ref[f"moe/{di}{r}/{k}"]), (di, r, k)
        y = out["moe/ep"].numpy()
        scale = float(np.abs(ref["moe/ep"]).max())
        assert float(np.abs(y - ref["moe/ep"]).max()) <= MOE_REL * scale
        assert float(np.abs(y - ref["moe/plain"]).max()) <= MOE_REL * scale
        assert float(np.abs(y - out["moe/plain"].numpy()).max()) <= MOE_REL * scale
    assert len(slabs) == WORLD
    stats = ranks[0]["moe/stats"]
    assert stats["counts_by_kind"] == {"all-to-all": 2, "all-reduce": 1}


def test_moe_ep_gradients_equal_moe_ffn(runs):
    _, ranks, _ = runs
    for out in ranks:
        gx, gx1, gw, gw1 = (t.numpy() for t in out["moe/grads"])
        assert float(np.abs(gx - gx1).max()) <= MOE_REL * float(np.abs(gx1).max())
        assert float(np.abs(gw - gw1).max()) <= MOE_REL * float(np.abs(gw1).max())


def test_pipeline_loss_equals_the_reference(runs):
    ref, ranks, _ = runs
    for out in ranks:
        assert _rel(out["pp/loss"], ref["pp/loss"]) < LOSS_REL
        assert _rel(out["pp/loss"], ref["pp/ref"]) < 2e-2  # the reference's own bound
        assert _rel(out["pp/loss"], out["pp/loss1"]) < LOSS_REL
    stats = ranks[0]["pp/stats"]
    # 3 ticks of forward ring permutes; the transposes of the first 2 (the
    # last tick's output is not used)
    assert stats["counts_by_kind"]["collective-permute"] == 5


def test_pipeline_gradients_reach_both_stages(runs):
    _, ranks, _ = runs
    by_stage = {}
    for out in ranks:
        by_stage.setdefault(out["pp/stage"], out)
    assert sorted(by_stage) == [0, 1]
    for stage, out in by_stage.items():
        g = out["pp/grads"]["blocks"]["attn"]["wq"]["w"]  # this stage's one layer
        g1 = out["pp/grads1"]["blocks"]["attn"]["wq"]["w"][stage:stage + 1]
        assert float(g.abs().max()) > 0
        assert float((g.float() - g1.float()).abs().max()) <= 2e-2 * float(g1.abs().max())
        # the replicated leaves' gradients are whole on every stage
        for name in ("embed", "head", "ln_f"):
            for a, b in zip(tree_leaves(out["pp/grads"][name]), tree_leaves(out["pp/grads1"][name])):
                assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.abs().max())
    from repro_torch.parallel.pipeline import bubble_fraction

    assert abs(bubble_fraction(2, 2) - 1 / 3) < 1e-9


def test_pipeline_two_layers_per_stage(runs):
    """GPipe PP 2 x DP 4 on the smoke Yi-6B at 4 layers, two per stage: the
    loss within ``LOSS_REL`` of the reference's ``pipelined_loss_fn`` and of
    the port's unsharded ``loss_fn``; every leaf's gradient (the stage's two
    layers of each stacked block leaf, the replicated embed, head and ln_f
    whole) within 2e-2 of the largest of the unsharded gradient's matching
    slice, both stages' blocks non-zero; 5 collective-permutes, as at one
    layer per stage (the ring moves a microbatch's activations once per
    tick, whatever a stage holds): 3 ticks forward, the transposes of the
    first 2."""
    ref, ranks, _ = runs
    by_stage = {}
    for out in ranks:
        assert _rel(out["pp4/loss"], ref["pp4/loss"]) < LOSS_REL
        assert _rel(out["pp4/loss"], out["pp4/loss1"]) < LOSS_REL
        assert out["pp4/stats"]["counts_by_kind"]["collective-permute"] == 5
        stage = out["pp4/stage"]
        by_stage.setdefault(stage, out)
        for name in out["pp4/grads"]:
            got, want = tree_leaves(out["pp4/grads"][name]), tree_leaves(out["pp4/grads1"][name])
            for a, b in zip(got, want):
                if name == "blocks":
                    b = b[2 * stage:2 * stage + 2]
                    assert a.shape[0] == 2 and float(a.abs().max()) > 0
                assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.abs().max())
    assert sorted(by_stage) == [0, 1]


FAMILY_CASES = [(f, q) for f in ("moe", "moe_ep", "vlm", "ssm", "hybrid", "encdec")
                for q in ("none", "horner")]


@pytest.mark.parametrize("family,quant", FAMILY_CASES)
def test_sharded_family_step_equals_the_reference(runs, family, quant):
    """The moe (``moe.ep`` off and on), vlm, ssm, hybrid and encdec smoke
    models' sharded steps, the same on every rank: the loss within
    tolerance of the reference's sharded step, and of the port's unsharded
    step where that takes the same path (not ``moe_ffn_ep``, which routes
    each slab on its own capacity; under quantization the reference falls
    back to ``moe_ffn``, so ``moe/horner`` is the reference's
    ``moe_ep/horner`` too).

    grad_norm: within tolerance of the reference's sharded step, except
    where routing is global (``moe_ffn``): there of the reference's
    unsharded step and of the port's.  The reference's sharded ``moe_ffn``
    step rounds its partial sums otherwise (GSPMD), the rounding moves near
    ties of the router, and a moved expert choice moves the gradient: its
    grad_norm is 3.2e-3 from its own unsharded step's on this batch.

    And for the ssm family at ``RWKV6_NORM_REL``: RWKV6's grad_norm is
    ``u``'s gradient, which the first position dominates (its state and
    ``u`` are zero, so ``ln_x`` normalises a zero row and ``rsqrt(eps)``
    scales its gradient by 316), and the bf16 roundings of the residual's
    gradient upstream, which a sharded step groups otherwise, move it by
    parts in a thousand: the reference's own sharded and unsharded steps
    are 7.3e-3 apart on this batch.  Its gradients in float32 are held to
    the unsharded ones leaf by leaf
    (``test_sharded_float32_gradients_equal_unsharded``)."""
    ref, ranks, _ = runs
    key = f"{family}/{quant}"
    rkey = "moe/horner" if key == "moe_ep/horner" else key
    norm_rel = RWKV6_NORM_REL if family == "ssm" else NORM_REL
    for out in ranks:
        assert _rel(out[f"{key}/loss"], ref[f"{rkey}/loss"]) < LOSS_REL
        if key != "moe_ep/none":
            assert _rel(out[f"{key}/loss"], out[f"{key}/loss1"]) < LOSS_REL
            assert _rel(out[f"{key}/grad_norm"], out[f"{key}/grad_norm1"]) < norm_rel
        if rkey.startswith("moe/"):
            assert _rel(out[f"{key}/loss"], ref[f"{rkey}/loss_whole"]) < LOSS_REL
            assert _rel(out[f"{key}/grad_norm"], ref[f"{rkey}/grad_norm_whole"]) < NORM_REL
        else:
            assert _rel(out[f"{key}/grad_norm"], ref[f"{rkey}/grad_norm"]) < norm_rel
    assert len({out[f"{key}/loss"] for out in ranks}) == 1
    assert len({out[f"{key}/grad_norm"] for out in ranks}) == 1


# quantized products of microbatch 0's forward (each then again in remat's
# recompute): the attention's four linears and the MLP's three per layer
# (the moe's MLP is its experts, bf16); RWKV6's time mix 5 and channel mix 3;
# Zamba2's 4 per Mamba2 layer (5) and the shared block's 5 per group (2);
# Whisper's encoder 6 and decoder 10 per layer (its head is bf16, tied)
INT32_FORWARD = {"moe": 4 * 2 + 1, "moe_ep": 4 * 2 + 1, "vlm": 7 * 2 + 1, "ssm": 8 * 2 + 1,
                 "hybrid": 4 * 5 + 5 * 2 + 1, "encdec": 6 * 2 + 10 * 2}
INT32_REMAT = {"moe": 4 * 2, "moe_ep": 4 * 2, "vlm": 7 * 2, "ssm": 8 * 2, "hybrid": 4 * 5,
               "encdec": 6 * 2 + 10 * 2}


@pytest.mark.parametrize("family", ["moe", "moe_ep", "vlm", "ssm", "hybrid", "encdec"])
def test_sharded_family_int32_products_are_bit_equal_to_unsharded(runs, family):
    _, ranks, _ = runs
    for out in ranks:
        rec = out[f"{family}/horner/int32"]
        n = INT32_FORWARD[family] + INT32_REMAT[family]
        assert rec["n"] == (n, n)
        assert all(rec["equal"]), rec["equal"]
    shapes = ranks[0][f"{family}/horner/int32"]["shapes"]
    if family == "vlm":  # the 8 patch positions ride the sequence
        assert shapes[0] == (2, 40, 64)
    if family == "ssm":  # wr: the rank's head; time mix wo whole
        assert shapes[0] == (2, 32, 64) and shapes[4] == (2, 32, 128)
    if family == "hybrid":  # the row-parallel in-projections: whole after the all-reduce
        assert shapes[:4] == [(2, 256, 256), (2, 256, 288), (2, 256, 8), (2, 256, 128)]
    if family == "encdec":  # the encoder's frames, then the decoder's tokens
        assert shapes[0] == (2, 32, 64) and shapes[12] == (2, 32, 64)


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec", "ssm_model4"])
def test_sharded_float32_gradients_equal_unsharded(runs, family):
    """With every leaf in float32 the sharded step's gradients (averaged
    over the data ranks, gathered) are the unsharded ones, leaf by leaf, to
    within float32's reassociation; on (4, 2), and for RWKV6 on (2, 4) too,
    where the model axis splits inside a head and every head runs on every
    rank (the path the production meshes' 16-way model axis takes for
    RWKV6-3B's 40 heads)."""
    _, ranks, _ = runs
    for out in ranks:
        assert out[f"{family}/f32_grad_rel"] < F32_GRAD_REL, out[f"{family}/f32_grad_rel"]


@pytest.mark.parametrize("key", ["none", "horner", "pp", "pp4"] + [f"{f}/{q}" for f, q in FAMILY_CASES])
def test_counting_mode_equals_the_live_collectives(runs, key):
    """Each rank's step run again on meta tensors over a shape-only mesh at
    the rank's coordinates issues the live step's collectives exactly."""
    _, ranks, _ = runs
    for out in ranks:
        assert out[f"{key}/count"] == out[f"{key}/stats"], key
    if key.startswith("moe/"):  # the global routing's counts cross the data ranks
        assert ranks[0][f"{key}/stats"]["counts_by_kind"]["all-gather"] == 4


def test_moe_global_routing_equals_the_reference(runs):
    """``moe_ffn``'s routing on 4 data ranks: each rank's assignments are the
    reference's whole-batch ones of its tokens, in order, with the global
    capacity and positions; the batch drops some."""
    ref, ranks, _ = runs
    assert not ref["route/keep"].all()
    for out in ranks:
        rt = out["route"]
        assert rt["cap"] == int(ref["route/cap"])
        t_loc = rt["tok"].numel() // 2
        d = out["mesh"][1]
        sel = (ref["route/tok"] >= d * t_loc) & (ref["route/tok"] < (d + 1) * t_loc)
        assert np.array_equal(rt["eid"].numpy(), ref["route/eid"][sel])
        assert np.array_equal(rt["tok"].numpy() + d * t_loc, ref["route/tok"][sel])
        assert np.array_equal(rt["pos"].numpy(), ref["route/pos"][sel])
        assert np.array_equal(rt["keep"].numpy(), ref["route/keep"][sel])


def test_sharded_load_balance_loss_and_gradient(runs):
    """The aux over 4 data ranks is the whole batch's, and its router
    gradient, averaged over the data ranks as the train step averages, is
    the unsharded one's."""
    _, ranks, _ = runs
    for out in ranks:
        aux, aux1, g, g1 = out["aux"]
        assert abs(aux - aux1) <= 1e-6 * abs(aux1)
        # bf16 gradients: partial sums over 16 tokens against one over 64
        assert float((g - g1).abs().max()) <= MOE_REL * float(g1.abs().max())
