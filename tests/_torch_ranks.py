"""The port's side of ``tests/test_torch_distributed.py``: one function run
on each of 8 CPU ranks (gloo, ``torch.multiprocessing`` spawn).  No jax
here: each rank imports torch and the port only.

:func:`rank_main` reads ``DIR/inputs.npz`` (the weights and data the
reference subprocess reads too), runs every check's port side on the
world's meshes and writes ``DIR/rank{r}.pt`` for the test to compare.

:func:`rank_lock` is the lock the two 8-rank test modules take around
their ranks and reference subprocesses, so that they never run at once.
"""
import contextlib
import dataclasses
import fcntl
import os
import shutil
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.checkpoint.ckpt import Checkpointer, tree_leaves, tree_unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import mma
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import pipeline as pp
from repro_torch.parallel import sharded_lm
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import Mesh, NamedSharding, P
from repro_torch.train import train_step as ts
from repro_torch.train import trainer

WORLD = 8
# the sharded steps beside the dense one: (smoke config, moe.ep); each also
# runs under mma_int8 on the Horner route
FAMILIES = {"moe": ("olmoe_1b_7b", False), "moe_ep": ("olmoe_1b_7b", True),
            "vlm": ("internvl2_76b", None), "ssm": ("rwkv6_3b", None),
            "hybrid": ("zamba2_7b", None), "encdec": ("whisper_large_v3", None)}
ROUTE_CAPACITY = 0.5  # the routing check's capacity factor: it drops assignments
FLOAT32_LEAVES = ("w_base", "u", "a_log", "dt_bias", "d_skip")  # RWKV6's and Mamba2's
LOCK_NAME = "torch_ranks.lock"


@contextlib.contextmanager
def rank_lock(directory):
    """Hold an exclusive ``flock`` on ``directory/LOCK_NAME`` for the block.

    ``tests/test_torch_distributed.py`` and ``tests/test_torch_serve_sharded.py``
    each spawn 8 rank processes and 3 reference compiles, and each alone
    keeps a machine's 8 cores busy; under ``pytest -n N --dist loadfile``
    both may land on workers at once, and their deadlines were set for one
    at a time.  Each takes this lock (``directory``: one every worker of the
    run shares, the parent of ``tmp_path_factory.getbasetemp()``) before it
    draws its inputs and releases it after its joins and kills.  The kernel
    drops an ``flock`` when its holder dies, so a killed run leaves nothing
    that blocks the next."""
    with open(os.path.join(directory, LOCK_NAME), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def tree(inp: dict, prefix: str) -> dict:
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.tensor(v).to(
                torch.float32 if leaf in FLOAT32_LEAVES else torch.bfloat16)
    return out


def _route(quant: str, family: str = "dense"):
    if family == "dense":
        cfg = get_smoke_config("yi_6b")
    else:
        arch, ep = FAMILIES[family]
        cfg = get_smoke_config(arch)
        if ep is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep=ep))
    if quant == "horner":
        cfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="horner"))
    return cfg


def _batch(inp, cfg) -> dict:
    batch = {"tokens": inp["tokens_257" if cfg.family == "hybrid" else "tokens"]}
    if cfg.family == "vlm":
        batch["patches"] = torch.tensor(inp["patches"]).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(inp["frames"]).to(torch.bfloat16)
    return batch


def _meta(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype, device="meta")
            for k, v in batch.items()}


def counting_mesh(mesh) -> Mesh:
    """The shape-only mesh at this rank's place: the dry run's counting mode."""
    return Mesh(mesh.shape, device="meta", coord={a: mesh.index(a) for a in mesh.axis_names})


def _counted_step(cfg, mesh, batch) -> dict:
    """The collectives one rank's step issues, counted on meta tensors."""
    cmesh = counting_mesh(mesh)
    ab = ts.abstract_state(cfg)
    step = ts.build_jitted_train_step(cfg, cmesh, ab, _meta(batch))
    step(shd.shard_tree(ab, ts.state_shardings(ab, cfg, cmesh)), _meta(batch))
    return coll.collective_stats(cmesh)


def _train_step(inp, mesh, quant, out, family="dense"):
    """One sharded step; for the Horner route also every int32 product
    (after its all-reduce) against the unsharded step's, bit for bit; and
    the same step's collectives counted on meta tensors."""
    cfg = _route(quant, family)
    params = tree(inp, "p/" if family == "dense" else f"{cfg.family}/")
    key = quant if family == "dense" else f"{family}/{quant}"
    batch = _batch(inp, cfg)
    tok = batch["tokens"]
    ab = ts.abstract_state(cfg)
    st_sh = ts.state_shardings(ab, cfg, mesh)
    step = ts.build_jitted_train_step(cfg, mesh, ab, _meta(batch))
    local = shd.shard_tree({"params": params, "opt": adamw.init(params)}, st_sh)

    sharded_calls, plain_calls = [], []
    inner_product, inner_dot = sharded_lm.mma_product, mma.mma_dot

    def rec_product(*a, **kw):
        acc = inner_product(*a, **kw)
        sharded_calls.append(acc)
        return acc

    coll.reset_stats(mesh)
    sharded_lm.mma_product = rec_product
    try:
        new, m = step(local, batch)
    finally:
        sharded_lm.mma_product = inner_product
    out[f"{key}/stats"] = coll.collective_stats(mesh)
    out[f"{key}/count"] = _counted_step(cfg, mesh, batch)
    out[f"{key}/loss"], out[f"{key}/grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    full = shd.gather_tree(new, st_sh)
    out[f"{key}/params"] = full["params"] if family == "dense" else None
    # the port's unsharded step on the whole batch
    def rec_dot(*a, **kw):
        acc = inner_dot(*a, **kw)
        plain_calls.append(acc)
        return acc

    mma.mma_dot = rec_dot
    try:
        new1, m1 = ts.train_step({"params": params, "opt": adamw.init(params)}, batch, cfg,
                                 device="cpu")
    finally:
        mma.mma_dot = inner_dot
    out[f"{key}/loss1"], out[f"{key}/grad_norm1"] = float(m1["loss"]), float(m1["grad_norm"])
    out[f"{key}/params1"] = new1["params"] if family == "dense" else None
    if quant == "horner":
        # forward, then the backward's recompute of each rematerialised block;
        # a column-parallel product is the rank's columns, a row-parallel one
        # (after its all-reduce) whole
        d, r = mesh.index("data"), mesh.index("model")
        rows = slice(d * tok.shape[0] // mesh.size("data"), (d + 1) * tok.shape[0] // mesh.size("data"))
        equal = []
        for got, want in zip(sharded_calls, plain_calls):
            want = want[rows]
            if got.shape[-1] != want.shape[-1]:
                n = got.shape[-1]
                want = want[..., r * n:(r + 1) * n]
            equal.append(got.dtype == torch.int32 and torch.equal(got, want))
        out["int32" if family == "dense" else f"{key}/int32"] = {
            "n": (len(sharded_calls), len(plain_calls)), "equal": equal,
            "shapes": [tuple(c.shape) for c in sharded_calls]}
    return full, st_sh


def _float32_grads(inp, mesh, family, out, key=None):
    """The ``family`` smoke model's sharded gradients with every leaf in
    float32 (no bf16 rounding left to differ), averaged over the data ranks
    as the train step averages and gathered, against the unsharded ones:
    the largest difference relative to each leaf's largest gradient, under
    ``out[f"{key or family}/f32_grad_rel"]``."""
    cfg = _route("none", family)
    params = layers.tree_map(lambda t: t.float(), tree(inp, f"{cfg.family}/"))
    batch = {k: torch.as_tensor(v) for k, v in _batch(inp, cfg).items()}
    sh = ts.state_shardings(ts.abstract_state(cfg), cfg, mesh)["params"]
    local_batch = shd.shard_tree(batch, ts.batch_shardings(batch, mesh))
    with shd.use_mesh(mesh):
        _, grads = ts.value_and_grad(
            partial(sharded_lm.loss_fn, cfg=cfg, mesh=mesh, device="cpu"),
            shd.shard_tree(params, sh), local_batch)
    _, grads1 = ts.value_and_grad(partial(models.build(cfg).loss_fn, cfg=cfg, device="cpu"),
                                  params, batch)
    worst = 0.0
    for g, g1, s in zip(tree_leaves(grads), tree_leaves(grads1), tree_leaves(sh)):
        g = shd.gather(coll.all_reduce(g, mesh, "data") / mesh.size("data"), s)
        worst = max(worst, float((g - g1).abs().max() / g1.abs().max().clamp_min(1e-30)))
    out[f"{key or family}/f32_grad_rel"] = worst


def _moe_global(inp, mesh, out):
    """Layer 0 of the moe smoke model on ``xm`` (one row per data rank):
    ``moe_ffn``'s routing as ``sharded_lm.route`` takes it (global capacity
    and positions), and the global load-balance loss with its router
    gradient (averaged over the data ranks, as the train step averages)
    against the unsharded ``moe.load_balance_loss``'s."""
    cfg = _route("none", "moe")
    params = tree(inp, "moe/")
    sh = ts.state_shardings(ts.abstract_state(cfg), cfg, mesh)["params"]
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=ROUTE_CAPACITY))
    p = layers.layer_params(shd.shard_tree(params, sh)["blocks"], 0)["moe"]
    xm = torch.tensor(inp["xm"]).to(torch.bfloat16)
    xs = xm[mesh.index("data")]
    cap, (eid_s, pos, tok_s, _, keep) = sharded_lm.route(p, xs, cfg, mesh, split=True)
    out["route"] = {"cap": cap, "eid": eid_s, "pos": pos, "tok": tok_s, "keep": keep}
    w = p["router"]["w"].detach().requires_grad_()
    aux = sharded_lm.load_balance_loss({**p, "router": {"w": w}}, xs[None], cfg, mesh)
    (g,) = torch.autograd.grad(aux, [w])
    g = coll.all_reduce(g.float(), mesh, "data") / mesh.size("data")
    p1 = layers.layer_params(params["blocks"], 0)["moe"]
    w1 = p1["router"]["w"].detach().requires_grad_()
    aux1 = moe_lib.load_balance_loss({**p1, "router": {"w": w1}}, xm, cfg)
    (g1,) = torch.autograd.grad(aux1, [w1])
    n = g.shape[-1]
    out["aux"] = (float(aux), float(aux1), g, g1.float()[:, mesh.index("model") * n:][:, :n])


def _elastic(d, state_a, st_a, mesh_b, out):
    """Save under (4, 2), restore under (2, 4): equal bit for bit."""
    rank = dist.get_rank()
    ck_dir = os.path.join(d, "ckpt")
    w = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    if rank == 0:
        ck = Checkpointer(ck_dir)
        ck.save(1, {"w": w})
        ck.save(2, {"state": state_a})
    dist.barrier()
    ck = Checkpointer(ck_dir)
    sh_b = NamedSharding(mesh_b, P("data", "model"))
    got, step = ck.restore({"w": torch.empty(8, 16, device="meta")}, step=1,
                           shardings={"w": sh_b})
    out["elastic/w"] = bool(torch.equal(got["w"], shd.shard(w, sh_b))) and step == 1
    cfg = _route("horner")
    st_b = ts.state_shardings(ts.abstract_state(cfg), cfg, mesh_b)
    like = tree_unflatten(state_a, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                                    for t in tree_leaves(state_a)])
    resumed, start = trainer.resume(like, trainer.TrainerConfig(ckpt_dir=ck_dir), shardings=st_b)
    back = shd.gather_tree(resumed, st_b)
    out["elastic/state"] = start == 2 and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(tree_leaves(back), tree_leaves(state_a)))
    out["elastic/local_shapes"] = [tuple(t.shape) for t in tree_leaves(resumed["params"])]


def _compressed(inp, out):
    mesh1 = Mesh.from_world((WORLD,), ("data",), device="cpu")
    f = gc.compressed_psum_shardmap(mesh1, ("data",))
    r = dist.get_rank()
    g = torch.tensor(inp["g_local"][r:r + 1])
    err = torch.zeros_like(g)
    synced_all = []
    for _ in range(20):
        synced, err = f(g, err)
        synced_all.append(synced)
    out["gc/synced"], out["gc/err"] = torch.cat(synced_all), err
    out["gc/stats"] = coll.collective_stats(mesh1)


def _moe(inp, mesh, out):
    mcfg = get_smoke_config("olmoe_1b_7b")
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe, capacity_factor=64.0, ep=True))
    mp = tree(inp, "m/")
    ex = NamedSharding(mesh, P("model", None, None))
    local = {**mp, **{k: shd.shard(mp[k], ex) for k in ("w_gate", "w_up", "w_down")}}
    local = layers.tree_map(lambda t: t.detach().requires_grad_(), local)
    x = torch.tensor(inp["xm"]).to(torch.bfloat16).requires_grad_()
    wts = torch.tensor(np.random.default_rng(5).standard_normal(x.shape), dtype=torch.float32)
    coll.reset_stats(mesh)
    with shd.use_mesh(mesh):
        y = moe_lib.moe_ffn_ep(local, x, mcfg)
    out["moe/stats"] = coll.collective_stats(mesh)
    gx, gw = torch.autograd.grad((y.float() * wts).sum(), [x, local["w_gate"]])
    full = layers.tree_map(lambda t: t.detach().requires_grad_(), mp)
    x1 = x.detach().requires_grad_()
    y1 = moe_lib.moe_ffn(full, x1, mcfg)
    gx1, gw1 = torch.autograd.grad((y1.float() * wts).sum(), [x1, full["w_gate"]])
    out["moe/ep"], out["moe/plain"] = y.detach().float(), y1.detach().float()
    out["moe/grads"] = (gx.float(), gx1.float(), gw.float(), shd.shard(gw1, ex).float())
    # this rank's slab routed as the reference's body routes it
    b, s, d = x.shape
    bl, sl = b // mesh.size("data"), s // mesh.size("model")
    di, r = mesh.index("data"), mesh.index("model")
    xf = x.detach()[di * bl:(di + 1) * bl, r * sl:(r + 1) * sl].reshape(bl * sl, d)
    logits = xf.float() @ mp["router"]["w"].float()
    _, (eid_s, pos, tok_s, _, keep) = moe_lib._local_dispatch(
        xf, logits, mcfg.moe.n_experts, mcfg.moe.top_k, moe_lib.capacity(bl * sl, mcfg.moe),
        xf.dtype)
    out["moe/slab"] = (di, r)
    out["moe/route"] = {"eid": eid_s, "pos": pos, "tok": tok_s, "keep": keep}


def _pipeline(inp, mesh, out, key="pp", n_layers=2):
    """GPipe PP 2 x DP 4 on the smoke Yi-6B at ``n_layers`` layers (its
    weights ``inp[key/...]``, the 2-layer ones under ``p/``): the loss and
    its gradient, the unsharded ``loss_fn``'s, and the collectives live and
    counted, under ``out[key/...]``."""
    cfg = get_smoke_config("yi_6b").replace(seq_shard=False, n_layers=n_layers)
    params = tree(inp, "p/" if key == "pp" else f"{key}/")
    local = shd.shard_tree(params, pp.stage_shardings(params, mesh))
    local = layers.tree_map(lambda t: t.detach().requires_grad_(), local)
    coll.reset_stats(mesh)
    with shd.use_mesh(mesh):
        loss, _ = pp.pipelined_loss_fn(local, {"tokens": inp["tokens"]}, cfg, n_micro=2,
                                       device="cpu")
    grads = torch.autograd.grad(loss, tree_leaves(local))
    out[f"{key}/stats"] = coll.collective_stats(mesh)
    out[f"{key}/loss"] = float(loss)
    out[f"{key}/grads"] = tree_unflatten(local, list(grads))
    from repro_torch.models import transformer
    full = layers.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss1, _ = transformer.loss_fn(full, {"tokens": inp["tokens"]}, cfg, device="cpu")
    out[f"{key}/loss1"] = float(loss1)
    out[f"{key}/grads1"] = tree_unflatten(full, list(torch.autograd.grad(loss1, tree_leaves(full))))
    out[f"{key}/stage"] = mesh.index("model")
    cmesh = counting_mesh(mesh)
    ab = {k: layers.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), v)
          for k, v in params.items()}
    local_m = layers.tree_map(lambda t: t.requires_grad_(),
                              shd.shard_tree(ab, pp.stage_shardings(ab, cmesh)))
    with shd.use_mesh(cmesh):
        loss_m, _ = pp.pipelined_loss_fn(local_m, _meta({"tokens": inp["tokens"]}), cfg,
                                         n_micro=2, device="meta")
    torch.autograd.grad(loss_m, tree_leaves(local_m))
    out[f"{key}/count"] = coll.collective_stats(cmesh)


def rank_main(rank: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'pg')}", rank=rank,
                            world_size=WORLD)
    try:
        inp = dict(np.load(os.path.join(d, "inputs.npz")))
        mesh = make_host_mesh(2, device="cpu")  # (4, 2)
        mesh_b = Mesh.from_world((2, 4), ("data", "model"), device="cpu")
        out = {"mesh": (mesh.shape, mesh.index("data"), mesh.index("model"))}
        _train_step(inp, mesh, "none", out)
        state_a, st_a = _train_step(inp, mesh, "horner", out)
        for family in FAMILIES:
            for quant in ("none", "horner"):
                _train_step(inp, mesh, quant, out, family)
        for family in ("ssm", "hybrid", "encdec"):
            _float32_grads(inp, mesh, family, out)
        # under (2, 4) a rank holds half of one of RWKV6's two heads: every
        # head runs on every rank
        _float32_grads(inp, mesh_b, "ssm", out, "ssm_model4")
        _moe_global(inp, mesh, out)
        _elastic(d, state_a, st_a, mesh_b, out)
        _compressed(inp, out)
        _moe(inp, mesh, out)
        _pipeline(inp, mesh, out)
        _pipeline(inp, mesh, out, key="pp4", n_layers=4)  # two layers per stage
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
        dist.barrier()
        if rank == 0:
            shutil.rmtree(os.path.join(d, "ckpt"), ignore_errors=True)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ sharded serving
# The port's side of ``tests/test_torch_serve_sharded.py``: each family's
# smoke model served on the (data 2, model 4) mesh through
# ``serve_step.make_prefill`` / ``make_decode`` with the mesh, against the
# same steps unsharded; every call also counted on meta tensors.

SERVE_ARCHS = {"dense": "yi_6b", "moe": "olmoe_1b_7b", "vlm": "internvl2_76b",
               "ssm": "rwkv6_3b", "hybrid": "zamba2_7b", "encdec": "whisper_large_v3"}
SERVE_ROUTES = ("none", "int8", "kernel")
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PROMPT, SERVE_STEPS = 4, 48, 20, 3
# a writing prefill whose keys span several attention chunks: the test's
# 100 tokens into a cache of 192 positions, three chunks of the smoke
# configs' 64 keys (48 positions per rank at model 4: a chunk spans two
# ranks' slices)
SERVE_LONG_SEQ = 192
SERVE_LONG = ("dense", "moe")
SERVE_HYBRID_PREFILL = 256  # one SSD chunk (mamba2.CHUNK)
INT8_MIN_DIM = 128  # the smoke models' linears of 128 and more are pre-quantized


def serve_cfg(family: str, route: str):
    cfg = get_smoke_config(SERVE_ARCHS[family])
    if route == "none":
        return cfg
    return cfg.replace(quant=QuantConfig(mode="mma_int8", impl=route, weights_int8=True,
                                         kv_int8=True))


def serve_tree(inp: dict, prefix: str) -> dict:
    """A parameter tree saved by ``test_torch_serve_sharded._inputs``:
    leaves in their own dtypes (int8 ``w_q``, float32 ``w_scale`` and
    RWKV6's and Mamba2's float32 leaves, bf16 the rest)."""
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            t = torch.tensor(v)
            if t.dtype == torch.float32 and leaf not in FLOAT32_LEAVES + ("w_scale",):
                t = t.to(torch.bfloat16)
            node[leaf] = t
    return out


def _abstract(tree):
    return layers.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _rows(t, mesh, n: int):
    d = mesh.index("data")
    per = n // mesh.size("data")
    return t[d * per:(d + 1) * per]


class _Recorder:
    """Every int32 product of a serving call, in call order: on the sharded
    side ``sharded_lm.mma_product``'s (a row-parallel one after its
    all-reduce), on the unsharded side ``mma.mma_dot``'s; the scaled
    kernel's (fused: its int32 is not returned) recomputed by the unscaled
    kernel's plain version on its operands, on both."""

    def __init__(self, sharded: bool):
        self.calls, self.sharded = [], sharded

    def __enter__(self):
        from repro_torch.kernels import mma_matmul as mk
        from repro_torch.kernels import ops

        self.saved = (sharded_lm.mma_product, mma.mma_dot, ops.mma_matmul_scaled)
        inner_prod, inner_dot, inner_scaled = self.saved

        inside = []

        def prod(*a, **kw):
            inside.append(1)
            try:
                acc = inner_prod(*a, **kw)
            finally:
                inside.pop()
            self.calls.append(acc)
            return acc

        def dot(*a, **kw):  # a LoRA's product, or the unsharded step's
            acc = inner_dot(*a, **kw)
            if not inside:
                self.calls.append(acc)
            return acc

        def scaled(x, w, xs, ws, *, planes=8, **kw):
            self.calls.append(mk.mma_matmul_plain(x, w, planes=planes))
            return inner_scaled(x, w, xs, ws, planes=planes, **kw)

        if self.sharded:
            sharded_lm.mma_product = prod
        mma.mma_dot = dot
        ops.mma_matmul_scaled = scaled
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        sharded_lm.mma_product, mma.mma_dot, ops.mma_matmul_scaled = self.saved


def _equal_products(got: list, want: list, mesh, n_rows: int) -> list:
    """Each sharded product against the unsharded one: the rank's rows, and
    a column-parallel product's columns."""
    out = []
    r = mesh.index("model")
    for g, w in zip(got, want):
        w = _rows(w, mesh, n_rows) if w.shape[0] == n_rows else w
        if g.shape[-1] != w.shape[-1]:
            n = g.shape[-1]
            w = w[..., r * n:(r + 1) * n]
        out.append(g.dtype == torch.int32 and g.shape == w.shape and bool(torch.equal(g, w)))
    return out


def _serve_extras(inp: dict, family: str) -> dict:
    """The family's prefill extras: the vlm's patches, Whisper's frames."""
    extras = {}
    if family == "vlm":
        extras["patches"] = torch.tensor(inp["serve/patches"]).to(torch.bfloat16)
    if family == "encdec":
        extras["frames"] = torch.tensor(inp["serve/frames"]).to(torch.bfloat16)
    return extras


NEAR_TIE_ULPS = 8  # a router near tie: top-k's last two within this many bf16 ulps


@contextlib.contextmanager
def router_ties(top_k: int, out: list):
    """Appends to ``out`` a bool per token routed in the block: whether its
    router logits' k-th and (k+1)-th largest lie within ``NEAR_TIE_ULPS``
    bf16 ulps of the k-th in any layer, where a rounding elsewhere can swap
    an expert (``moe.router_logits``' bf16 product, then float32)."""
    inner, seen = moe_lib.router_logits, []

    def recording(p, xf):
        lg = inner(p, xf)
        seen.append(lg)
        return lg

    moe_lib.router_logits = recording
    try:
        yield
    finally:
        moe_lib.router_logits = inner
    tie = None
    for lg in seen:
        v = torch.sort(lg.float(), dim=-1, descending=True).values
        ulp = torch.exp2(torch.floor(torch.log2(v[:, top_k - 1].abs().clamp(min=2.0 ** -126))) - 7)
        t = v[:, top_k - 1] - v[:, top_k] <= NEAR_TIE_ULPS * ulp
        tie = t if tie is None else tie | t
    out.append(tie)


def serve_family(inp, mesh, family: str, route: str, out: dict, *, batch=SERVE_BATCH,
                 key=None, two_d=False, max_seq=SERVE_MAX_SEQ, prompt="serve/prompt",
                 prefill_of=None, ties=False) -> None:
    """One family's prefill, writing prefill (of ``inp[prompt]``) and decode
    steps against a cache of ``max_seq`` on this rank, against the unsharded
    steps; results under ``out[key/...]``.  ``prefill_of``: a case already
    run whose prefill (no cache: the same weights, tokens and route) is this
    one's, its results taken over.  ``ties``: each decode call's positions
    at a router near tie in the unsharded step (``router_ties``), the
    rank's rows."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.models import whisper
    from repro_torch.serve import serve_step as ss

    key = key or f"{family}/{route}"
    cfg = serve_cfg(family, route)
    params = serve_tree(inp, f"{family}/{'q' if route != 'none' else 'f'}/")
    n = batch
    p_ab = _abstract(params)
    if two_d:
        saved = ss.TWO_D_BYTES
        ss.TWO_D_BYTES = 0
    try:
        p_sh, mode = ss.param_shardings(p_ab, cfg, mesh)
    finally:
        if two_d:
            ss.TWO_D_BYTES = saved
    out[f"{key}/mode"] = mode
    local = shd.shard_tree(params, p_sh)
    cmesh = counting_mesh(mesh)
    cp_sh, _ = (ss.param_shardings(p_ab, cfg, cmesh) if not two_d
                else (tree_unflatten(p_sh, [NamedSharding(cmesh, s.spec) for s in tree_leaves(p_sh)]),
                      mode))
    local_m = shd.shard_tree(p_ab, cp_sh)
    ex = _serve_extras(inp, family)
    ex = {k: v[:n] for k, v in ex.items()}
    res = {}

    def counted(fn_m, *args):
        coll.reset_stats(cmesh)
        fn_m(*args)
        return coll.collective_stats(cmesh)

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    # ---- the prefill (no cache)
    if prefill_of is not None:
        res.update({k: v for k, v in out[prefill_of].items() if k.startswith("prefill/")})
    else:
        s_pre = SERVE_HYBRID_PREFILL if family == "hybrid" else 16
        tok = torch.tensor(inp[f"serve/prefill_{s_pre}"][:n])
        pre_ex = {k: v for k, v in ex.items() if k in ("patches", "frames")}
        pre = ss.make_prefill(cfg, mesh=mesh, device="cpu", shardings=p_sh)
        pre1 = ss.make_prefill(cfg, device="cpu")
        loc_ex = {k: _rows(v, mesh, n) for k, v in pre_ex.items()}
        coll.reset_stats(mesh)
        with torch.no_grad(), _Recorder(True) as rec:
            lg = pre(local, _rows(tok, mesh, n), loc_ex)
        res["prefill/stats"] = coll.collective_stats(mesh)
        res["prefill/logits"] = sharded_lm.gathered_logits(lg, lg.shape[-1] != cfg.vocab,
                                                           mesh).float()
        with torch.no_grad(), _Recorder(False) as rec1:
            lg1 = pre1(params, tok, pre_ex)
        res["prefill/logits1"] = _rows(lg1, mesh, n).float()
        res["prefill/int32"] = _equal_products(rec.calls, rec1.calls, mesh, n)
        pre_m = ss.make_prefill(cfg, mesh=cmesh, device="meta", shardings=cp_sh)
        with torch.no_grad():
            res["prefill/count"] = counted(pre_m, local_m, meta(_rows(tok, mesh, n)),
                                           {k: meta(v) for k, v in loc_ex.items()})

    # ---- decode: a writing prefill (not for the hybrid: Mamba2 decodes one
    # token per call), then single-token steps
    dec, spec = ss.make_decode(cfg, n, max_seq, mesh=mesh, device="cpu", shardings=p_sh)
    dec1, _ = ss.make_decode(cfg, n, max_seq, device="cpu")
    dec_m, _ = ss.make_decode(cfg, n, max_seq, mesh=cmesh, device="meta", shardings=cp_sh)
    c_sh = ss.cache_shardings(spec, cfg, mesh, n, max_seq)
    cdtype = torch.int8 if cfg.quant.kv_int8 else torch.bfloat16
    cache1 = ss.init_serving_cache(cfg, n, max_seq, dtype=cdtype, device="cpu")
    cache = shd.shard_tree(cache1, c_sh)
    cache_m = shd.shard_tree(spec, ss.cache_shardings(spec, cfg, cmesh, n, max_seq))
    dex, dex1 = {}, {}
    if family == "encdec":
        with torch.no_grad():
            memory = whisper.encode(params, ex["frames"], cfg, device="cpu")
            ckv = whisper.precompute_cross_kv(params, memory, cfg, device="cpu")
        dex1 = {"memory": memory, "cross_kv": ckv}
        dex = {"memory": _rows(memory, mesh, n),
               "cross_kv": {k: v[:, mesh.index("data") * (n // mesh.size("data")):]
                            [:, :n // mesh.size("data")] for k, v in ckv.items()}}
    calls = []
    if family != "hybrid":
        calls.append(torch.tensor(inp[prompt][:n]))
    steps = SERVE_STEPS + (1 if family == "hybrid" else 0)
    calls += [torch.tensor(inp["serve/steps"][i][:n]) for i in range(steps)]
    idx = 0
    res["decode"] = []
    for i, t in enumerate(calls):
        coll.reset_stats(mesh)
        with torch.no_grad(), _Recorder(True) as rec:
            lg, cache = dec(local, _rows(t, mesh, n), cache, torch.tensor(idx), dex)
        stats = coll.collective_stats(mesh)
        tie = []
        with torch.no_grad(), _Recorder(False) as rec1, \
                router_ties(cfg.moe.top_k, tie) if ties else contextlib.nullcontext():
            lg1, cache1 = dec1(params, t, cache1, torch.tensor(idx), dex1)
        with torch.no_grad():
            cnt = counted(dec_m, local_m, meta(_rows(t, mesh, n)), cache_m, meta(torch.tensor(idx)),
                          layers.tree_map(meta, dex))
        step = {"stats": stats, "count": cnt,
                "logits": sharded_lm.gathered_logits(lg, lg.shape[-1] != cfg.vocab, mesh).float(),
                "logits1": _rows(lg1, mesh, n).float(),
                "int32": _equal_products(rec.calls, rec1.calls, mesh, n)}
        if tie:
            step["tie"] = _rows(tie[0].reshape(t.shape), mesh, n)
        if i == 0:  # layer 0's new cache or state, gathered, against the unsharded one's
            whole = shd.gather_tree(cache, c_sh)
            step["cache0"] = {k: bool(torch.equal(a[0], b[0])) for k, a, b in
                              zip(_leaf_names(whole), tree_leaves(whole), tree_leaves(cache1))}
        res["decode"].append(step)
        idx += t.shape[1]
    state = sum(x.numel() * x.element_size() for x in tree_leaves(local)) + \
        sum(x.numel() * x.element_size() for x in tree_leaves(cache))
    res["state_bytes"] = state
    res["dry_bytes"] = specs_lib.sharded_bytes(p_ab, p_sh, mesh) + \
        specs_lib.sharded_bytes(spec, c_sh, mesh)
    out[key] = res


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


SERVE_CASES = [(f, r) for f in SERVE_ARCHS for r in SERVE_ROUTES]
# moe_ffn_ep's body at a decode step that drops: the test's SERVE_EP_ROWS
# rows of one token, each data rank's half routed whole on every model rank
# at cap 4 (the smoke OLMoE's 8 experts, top-2)
SERVE_EP_ROWS = 24


def _moe_ep_decode(inp, mesh, out) -> None:
    """The smoke OLMoE's layer-0 MoE with ``moe.ep`` on, unquantized (its
    experts split over 'model'), through ``sharded_lm.moe_serve`` on this
    rank's rows of ``inp["serve/moe_x"]`` (a decode step's (rows, 1, D)):
    the rank's output rows and its slab's routing, under ``moe_ep_decode/``."""
    cfg = get_smoke_config("olmoe_1b_7b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep=True))
    p = layers.layer_params(serve_tree(inp, "moe/f/")["blocks"], 0)["moe"]
    ex = NamedSharding(mesh, P("model", None, None))
    local = {**p, **{k: shd.shard(p[k], ex) for k in ("w_gate", "w_up", "w_down")}}
    x = _rows(torch.tensor(inp["serve/moe_x"]).to(torch.bfloat16), mesh, SERVE_EP_ROWS)
    routes, inner = [], moe_lib._local_dispatch

    def recording(xf, logits, n_experts, top_k, cap, dtype):
        buf, meta = inner(xf, logits, n_experts, top_k, cap, dtype)
        routes.append({"eid": meta[0], "pos": meta[1], "tok": meta[2], "keep": meta[4],
                       "cap": cap})
        return buf, meta

    moe_lib._local_dispatch = recording
    try:
        with torch.no_grad():
            y = sharded_lm.moe_serve(local, x, cfg, mesh)
    finally:
        moe_lib._local_dispatch = inner
    out["moe_ep_decode/y"] = y.float()
    out["moe_ep_decode/routes"] = routes


def serve_main(rank: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'pg')}", rank=rank,
                            world_size=WORLD)
    try:
        inp = dict(np.load(os.path.join(d, "inputs.npz")))
        mesh = make_host_mesh(4, device="cpu")  # (data 2, model 4)
        out = {"mesh": (mesh.shape, mesh.index("data"), mesh.index("model"))}
        for family, route in SERVE_CASES:
            serve_family(inp, mesh, family, route, out)
        serve_family(inp, mesh, "hybrid", "int8", out, batch=2, key="hybrid_b2/int8")
        serve_family(inp, mesh, "dense", "int8", out, key="dense_2d/int8", two_d=True)
        _moe_ep_decode(inp, mesh, out)
        for family in SERVE_LONG:
            for route in SERVE_ROUTES:
                serve_family(inp, mesh, family, route, out, key=f"{family}_long/{route}",
                             max_seq=SERVE_LONG_SEQ, prompt="serve/prompt_long",
                             prefill_of=f"{family}/{route}", ties=family == "moe")
        torch.save(out, os.path.join(d, f"serve{rank}.pt"))
    finally:
        dist.destroy_process_group()
