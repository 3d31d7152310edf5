"""The reference side of ``tests/test_torch_distributed.py``, run as a
subprocess with 8 forced host devices:

    JAX_PLATFORMS=cpu python tests/_ref_parallel.py DIR PART

Reads ``DIR/inputs.npz`` (the port's weights and the test's data) and writes
``DIR/ref_PART.npz`` (see :func:`main`).  Every mesh is built with Auto-typed axes: jax 0.9's
``jax.make_mesh`` makes Explicit axes by default, under which the reference's
sharded code raises ``ShardingTypeError``.  The reference package itself is
used as it is.
"""
import dataclasses as dc
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import QuantConfig  # noqa: E402
from repro.models import build, moe as moe_lib  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw, grad_compress as gc  # noqa: E402
from repro.parallel import sharding as shd  # noqa: E402
from repro.parallel.pipeline import pipelined_loss_fn  # noqa: E402
from repro.train import train_step as ts  # noqa: E402

EXACT = {"xla_allow_excess_precision": False, "xla_disable_hlo_passes": "algsimp"}
ROUTE_CAPACITY = 0.5  # the routing check's capacity factor (tests/_torch_ranks.py's too)
BOTH = ("none", "horner")
# family -> (smoke config, moe.ep, quant settings)
FAMILY_STEPS = {"moe": ("olmoe_1b_7b", False, BOTH), "moe_ep": ("olmoe_1b_7b", True, ("none",)),
                "vlm": ("internvl2_76b", None, BOTH), "ssm": ("rwkv6_3b", None, BOTH),
                "hybrid": ("zamba2_7b", None, BOTH), "encdec": ("whisper_large_v3", None, BOTH)}


def auto_mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


FLOAT32_LEAVES = ("w_base", "u", "a_log", "dt_bias", "d_skip")  # RWKV6's and Mamba2's


def tree(inp, prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v, jnp.float32 if leaf in FLOAT32_LEAVES else jnp.bfloat16)
    return out


def flat(t, prefix=""):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(jnp.asarray(t, jnp.float32))}


def exact(fn, *args, **jit_kw):
    return jax.jit(fn, **jit_kw).lower(*args).compile(EXACT)(*args)


def family_steps(inp, mesh, families) -> dict:
    """The sharded steps on ``mesh`` of the smoke models of ``families``
    (names of ``FAMILY_STEPS``), each under both quant settings where it
    lists them; the moe steps also unsharded."""
    out = {}
    tok = jnp.asarray(inp["tokens"])
    quants = {"none": QuantConfig(), "horner": QuantConfig(mode="mma_int8", impl="xla")}
    for family in families:
        arch, ep, names = FAMILY_STEPS[family]
        base = get_smoke_config(arch)
        if ep is not None:
            base = base.replace(moe=dc.replace(base.moe, ep=ep))
        fparams = tree(inp, f"{base.family}/")
        batch = {"tokens": jnp.asarray(inp["tokens_257"]) if family == "hybrid" else tok}
        if base.family == "vlm":
            batch["patches"] = jnp.asarray(inp["patches"], jnp.bfloat16)
        if base.family == "encdec":
            batch["frames"] = jnp.asarray(inp["frames"], jnp.bfloat16)
        for name in names:
            cfg = base.replace(quant=quants[name])
            ab = ts.abstract_state(cfg)
            st_sh = ts.state_shardings(ab, cfg, mesh)
            b_sh = ts.batch_shardings({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                       for k, v in batch.items()}, mesh)
            state = jax.device_put({"params": fparams, "opt": adamw.init(fparams)}, st_sh)

            def fstep(st, b, cfg=cfg):
                with shd.use_mesh(mesh):
                    return ts.train_step(st, b, cfg)

            _, m = exact(fstep, state, {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()},
                         in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None))
            out[f"{family}/{name}/loss"] = np.asarray(m["loss"])
            out[f"{family}/{name}/grad_norm"] = np.asarray(m["grad_norm"])
            if family != "moe":
                continue
            # the same step unsharded, on one device
            _, m = exact(lambda st, b, cfg=cfg: ts.train_step(st, b, cfg),
                         {"params": fparams, "opt": adamw.init(fparams)}, batch)
            out[f"{family}/{name}/loss_whole"] = np.asarray(m["loss"])
            out[f"{family}/{name}/grad_norm_whole"] = np.asarray(m["grad_norm"])
    return out


# tests/test_torch_serve_sharded.py: each family's smoke model served on
# the (data 2, model 4) mesh, the port's tokens, weights and cache sizes
SERVE_ARCHS = {"dense": "yi_6b", "moe": "olmoe_1b_7b", "vlm": "internvl2_76b",
               "ssm": "rwkv6_3b", "hybrid": "zamba2_7b", "encdec": "whisper_large_v3"}
SERVE_MAX_SEQ, SERVE_STEPS = 48, 3
SERVE_LONG_SEQ = 192  # the writing prefill over several attention chunks (``FAMILY_long``)


def serve_tree(inp, prefix):
    """The port's saved tree, each leaf in its own dtype (int8 ``w_q``,
    float32 ``w_scale`` and the recurrent families' float32 leaves)."""
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            if v.dtype == np.float32 and leaf not in FLOAT32_LEAVES + ("w_scale",):
                node[leaf] = jnp.asarray(v, jnp.bfloat16)
            else:
                node[leaf] = jnp.asarray(v)
    return out


def serve_family(inp, mesh, family, route, batch=4, key=None, whole=False,
                 max_seq=SERVE_MAX_SEQ, prompt="serve/prompt", prefill=True) -> dict:
    """The reference's sharded prefill and decode steps of one family, as
    ``launch.specs._build_prefill`` / ``_build_decode`` lay them out (the
    params by ``param_specs``, the rows over 'data', the cache by
    ``serve_step.cache_shardings``), compiled with ``EXACT``: the logits of
    the prefill and of every decode call (a writing prefill of the prompt,
    then single tokens; Zamba2 single tokens only) against a cache of
    ``max_seq``.  ``whole``: the same steps unsharded, on one device (under
    keys ``.../whole``).  ``prefill`` False: the decode calls only."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch import specs as rspecs
    from repro.models import whisper
    from repro.parallel import param_specs as pspecs
    from repro.serve import serve_step as ss

    key = (key or f"{family}/{route}") + ("/whole" if whole else "")
    cfg = get_smoke_config(SERVE_ARCHS[family])
    if route != "none":
        cfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl="int8", weights_int8=True,
                                            kv_int8=True))
    params = serve_tree(inp, f"{family}/{'q' if route != 'none' else 'f'}/")
    rules = rspecs._rules(cfg)
    if whole:
        mesh = auto_mesh((1, 1), ("data", "model"))
    p_sh = pspecs.named_shardings(jax.eval_shape(lambda: params), cfg, mesh)
    params = jax.device_put(params, p_sh)
    b = batch
    out = {}
    s_pre = 256 if family == "hybrid" else 16
    tok = jnp.asarray(inp[f"serve/prefill_{s_pre}"][:b])
    extras = {}
    if family == "vlm":
        extras["patches"] = jnp.asarray(inp["serve/patches"][:b], jnp.bfloat16)
    if family == "encdec":
        extras["frames"] = jnp.asarray(inp["serve/frames"][:b], jnp.bfloat16)
    prefill = ss.make_prefill(cfg)
    tok_sh = NamedSharding(mesh, P("data", None))
    ex_sh = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))) for k, v in extras.items()}

    def pre_fn(p_, t_, e_):
        with shd.use_mesh(mesh, rules):
            return prefill(p_, t_, e_)

    if prefill:
        lg = exact(pre_fn, params, jax.device_put(tok, tok_sh),
                   {k: jax.device_put(v, ex_sh[k]) for k, v in extras.items()},
                   in_shardings=(p_sh, tok_sh, ex_sh))
        out[f"{key}/prefill"] = np.asarray(jnp.asarray(lg, jnp.float32))
    if family == "hybrid" and route != "none" and not whole:
        # the same step under plain jax.jit, which skips some bf16 roundings:
        # the quantized stateless Zamba2 forward's spread between builds
        lg = jax.jit(pre_fn, in_shardings=(p_sh, tok_sh, ex_sh))(
            params, jax.device_put(tok, tok_sh), {})
        out[f"{key}/prefill_plain"] = np.asarray(jnp.asarray(lg, jnp.float32))

    decode, ab_cache = ss.make_decode(cfg, b, max_seq)
    c_sh = ss.cache_shardings(ab_cache, cfg, mesh, b, max_seq=max_seq)
    cache = jax.device_put(jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), ab_cache), c_sh)
    dex = {}
    if family == "encdec":
        memory = exact(lambda p_, f_: whisper.encode(p_, f_, cfg), params, extras["frames"])
        dex = {"memory": memory,
               "cross_kv": exact(lambda p_, m_: whisper.precompute_cross_kv(p_, m_, cfg), params,
                                 memory)}

    def ex_sharding(v):
        axes = [None] * v.ndim
        for i, d_ in enumerate(v.shape):
            if d_ == b:
                axes[i] = "data"
                break
        return NamedSharding(mesh, P(*axes))

    dex_sh = jax.tree.map(ex_sharding, dex)
    dex = jax.tree.map(lambda v, s_: jax.device_put(v, s_), dex, dex_sh)

    def dec_fn(p_, t_, c_, i_, e_):
        with shd.use_mesh(mesh, rules):
            return decode(p_, t_, c_, i_, e_)

    calls = [] if family == "hybrid" else [inp[prompt][:b]]
    calls += [inp["serve/steps"][i][:b] for i in range(SERVE_STEPS + (family == "hybrid"))]
    compiled, idx = {}, 0
    for i, t in enumerate(calls):
        t = jax.device_put(jnp.asarray(t), tok_sh)
        args = (params, t, cache, jnp.asarray(idx, jnp.int32), dex)
        if t.shape not in compiled:
            compiled[t.shape] = jax.jit(
                dec_fn, in_shardings=(p_sh, tok_sh, c_sh, NamedSharding(mesh, P()), dex_sh),
                out_shardings=(None, c_sh)).lower(*args).compile(EXACT)
        lg, cache = compiled[t.shape](*args)
        out[f"{key}/decode{i}"] = np.asarray(jnp.asarray(lg, jnp.float32))
        idx += t.shape[1]
    return out


SERVE_EP_ROWS = 24  # ``moe_ep_decode``: tests/_torch_ranks.py's


def moe_ep_decode(inp, mesh) -> dict:
    """``moe_ffn_ep`` at a decode step that drops: the smoke OLMoE's layer-0
    MoE with ``moe.ep`` on (unquantized) on ``inp["serve/moe_x"]`` (rows of
    one token) on ``mesh``: each data rank's rows routed whole on every
    model rank (``spec_for`` drops the ``seq`` split that 1 token does not
    divide), at the rows' capacity.  The output, and each data rank's slab
    routed as the body routes it (float32 router logits), outside jit."""
    cfg = get_smoke_config("olmoe_1b_7b")
    cfg = cfg.replace(moe=dc.replace(cfg.moe, ep=True))
    p = jax.tree.map(lambda a: a[0], serve_tree(inp, "moe/f/")["blocks"]["moe"])
    x = jnp.asarray(inp["serve/moe_x"], jnp.bfloat16)
    out = {}
    with shd.use_mesh(mesh):
        out["moe_ep_decode/y"] = np.asarray(jax.jit(
            lambda p_, x_: moe_lib.moe_ffn_ep(p_, x_, cfg))(p, x).astype(jnp.float32))
    m, n_data = cfg.moe, mesh.shape["data"]
    bl, dm = SERVE_EP_ROWS // n_data, x.shape[-1]
    cap = min(bl * m.top_k, max(int(bl * m.top_k / m.n_experts * m.capacity_factor), 4))
    for di in range(n_data):
        xf = x[di * bl:(di + 1) * bl].reshape(bl, dm)
        logits = xf @ p["router"]["w"].astype(jnp.float32)
        _, (eid_s, pos, tok_s, _, keep) = moe_lib._local_dispatch(
            xf, logits, m.n_experts, m.top_k, cap, xf.dtype)
        for k, v in (("eid", eid_s), ("pos", pos), ("tok", tok_s), ("keep", keep)):
            out[f"moe_ep_decode/{di}/{k}"] = np.asarray(v)
    out["moe_ep_decode/cap"] = np.asarray(cap)
    return out


def main(d, part):
    """``part``: ``base`` (every check but the ssm, hybrid and encdec
    steps), a comma-separated list of those families, or ``serve:`` and a
    comma-separated list of the families whose serving steps to run; the
    tests run the parts as concurrent subprocesses."""
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    if part.startswith("serve:"):
        mesh = auto_mesh((2, 4), ("data", "model"))
        out = {}
        for family in part[len("serve:"):].split(","):
            if family.endswith("_long"):  # a writing prefill over several attention chunks
                base = family[:-len("_long")]
                for route in ("none", "int8"):
                    # its prefill (no cache) is the base family's; moe, as
                    # its other cases, against the unsharded step only
                    out.update(serve_family(inp, mesh, base, route, key=f"{family}/{route}",
                                            max_seq=SERVE_LONG_SEQ, prompt="serve/prompt_long",
                                            prefill=False, whole=base == "moe"))
                continue
            for route in ("none", "int8"):
                # moe against the unsharded step only: GSPMD's partial sums
                # move the router's near ties
                out.update(serve_family(inp, mesh, family, route, whole=family == "moe"))
            if family == "moe":  # moe_ffn_ep at a decode step that drops
                out.update(moe_ep_decode(inp, mesh))
            if family == "hybrid":  # the rule's first dim equal to the batch: the groups
                out.update(serve_family(inp, mesh, family, "int8", batch=2, key="hybrid_b2/int8"))
        np.savez(os.path.join(d, f"ref_{part.replace(':', '_').replace(',', '_')}.npz"), **out)
        print("REF_OK")
        return
    mesh = auto_mesh((4, 2), ("data", "model"))
    if part != "base":
        out = family_steps(inp, mesh, part.split(","))
        np.savez(os.path.join(d, f"ref_{part}.npz"), **out)
        print("REF_OK")
        return
    out = {}
    params = tree(inp, "p/")
    tok = jnp.asarray(inp["tokens"])

    # the sharded train step on (4, 2)
    for name, q in (("none", QuantConfig()), ("horner", QuantConfig(mode="mma_int8", impl="xla"))):
        cfg = get_smoke_config("yi_6b").replace(quant=q)
        ab = ts.abstract_state(cfg)
        st_sh = ts.state_shardings(ab, cfg, mesh)
        b_sh = ts.batch_shardings({"tokens": jax.ShapeDtypeStruct(tok.shape, jnp.int32)}, mesh)
        state = jax.device_put({"params": params, "opt": adamw.init(params)}, st_sh)

        def step_fn(st, b, cfg=cfg):
            with shd.use_mesh(mesh):
                return ts.train_step(st, b, cfg)

        new, m = exact(step_fn, state, {"tokens": jax.device_put(tok, b_sh["tokens"])},
                       in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None))
        out[f"{name}/loss"], out[f"{name}/grad_norm"] = np.asarray(m["loss"]), np.asarray(
            m["grad_norm"])
        out.update({f"{name}/p/{k}": v for k, v in flat(new["params"]).items()})

    # the moe (ep off and on) and vlm smoke models' sharded steps on (4, 2);
    # moe_ffn_ep under quantization is moe_ffn (the reference falls back),
    # so moe/horner stands for moe_ep/horner too
    out.update(family_steps(inp, mesh, ("moe", "moe_ep", "vlm")))

    # moe_ffn's routing of the moe smoke model's layer 0 on xm: the whole
    # batch's (the global capacity and positions), at a capacity factor
    # that drops assignments
    mcfg0 = get_smoke_config("olmoe_1b_7b")
    mcfg0 = mcfg0.replace(moe=dc.replace(mcfg0.moe, capacity_factor=ROUTE_CAPACITY))
    router = tree(inp, "moe/")["blocks"]["moe"]["router"]["w"][0]
    xf = jnp.asarray(inp["xm"], jnp.bfloat16).reshape(-1, mcfg0.d_model)
    lg = jlayers.linear({"w": router}, xf).astype(jnp.float32)
    mm = mcfg0.moe
    t = xf.shape[0]
    cap = min(t * mm.top_k, max(int(t * mm.top_k / mm.n_experts * mm.capacity_factor), 4))
    _, (eid_s, pos, tok_s, _, keep) = moe_lib._local_dispatch(xf, lg, mm.n_experts, mm.top_k,
                                                              cap, xf.dtype)
    for k, v in (("eid", eid_s), ("pos", pos), ("tok", tok_s), ("keep", keep)):
        out[f"route/{k}"] = np.asarray(v)
    out["route/cap"] = np.asarray(cap)

    # compressed gradient sync: the reference test's 20 steps, compiled as
    # the source reads (XLA's fusion would contract ``e - q * s`` into one
    # FMA, an ulp of the residual per step)
    mesh1 = auto_mesh((8,), ("data",))
    g_local = jnp.asarray(inp["g_local"], jnp.float32)
    err = jnp.zeros_like(g_local)
    f = jax.jit(gc.compressed_psum_shardmap(mesh1, ("data",))).lower(g_local, err).compile(
        {"xla_disable_hlo_passes": "algsimp,fusion"})
    synced_all = []
    for _ in range(20):
        synced, err = f(g_local, err)
        synced_all.append(np.asarray(synced))
    out["gc/synced"], out["gc/err"] = np.stack(synced_all), np.asarray(err)

    # expert-parallel MoE on (4, 2), dropless; each slab's routing
    mcfg = get_smoke_config("olmoe_1b_7b")
    mcfg = mcfg.replace(moe=dc.replace(mcfg.moe, capacity_factor=64.0, ep=True))
    mp = tree(inp, "m/")
    xm = jnp.asarray(inp["xm"], jnp.bfloat16)
    with shd.use_mesh(mesh):
        out["moe/plain"] = np.asarray(jax.jit(
            lambda p_, x_: moe_lib.moe_ffn(p_, x_, mcfg))(mp, xm).astype(jnp.float32))
        out["moe/ep"] = np.asarray(jax.jit(
            lambda p_, x_: moe_lib.moe_ffn_ep(p_, x_, mcfg))(mp, xm).astype(jnp.float32))
    b, s, dm = xm.shape
    bl, sl = b // 4, s // 2
    m = mcfg.moe
    cap = min(bl * sl * m.top_k, max(int(bl * sl * m.top_k / m.n_experts * m.capacity_factor), 4))
    for di in range(4):
        for r in range(2):
            xf = xm[di * bl:(di + 1) * bl, r * sl:(r + 1) * sl].reshape(bl * sl, dm)
            logits = xf @ mp["router"]["w"].astype(jnp.float32)
            _, (eid_s, pos, tok_s, _, keep) = moe_lib._local_dispatch(
                xf, logits, m.n_experts, m.top_k, cap, xf.dtype)
            for k, v in (("eid", eid_s), ("pos", pos), ("tok", tok_s), ("keep", keep)):
                out[f"moe/{di}{r}/{k}"] = np.asarray(v)

    # GPipe: PP 2 x DP 4
    pcfg = get_smoke_config("yi_6b").replace(seq_shard=False)
    batch = {"tokens": tok}
    out["pp/ref"] = np.asarray(build(pcfg).loss_fn(params, batch, pcfg)[0])
    with shd.use_mesh(mesh):
        out["pp/loss"] = np.asarray(jax.jit(
            lambda p_, b_: pipelined_loss_fn(p_, b_, pcfg, n_micro=2)[0])(params, batch))
    # the same at 4 layers: two per stage
    pcfg4, params4 = pcfg.replace(n_layers=4), tree(inp, "pp4/")
    with shd.use_mesh(mesh):
        out["pp4/loss"] = np.asarray(jax.jit(
            lambda p_, b_: pipelined_loss_fn(p_, b_, pcfg4, n_micro=2)[0])(params4, batch))
    np.savez(os.path.join(d, "ref_base.npz"), **out)
    print("REF_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
