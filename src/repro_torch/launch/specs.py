"""Allocation-free stand-ins for every (arch x shape) cell: the port's
counterpart of the reference's ``launch/specs.py``, on the ``meta`` device.

``build_cell(cfg, shape_name, mesh)`` returns a dict with:

  kind:    'train' | 'prefill' | 'decode'
  fn:      one rank's sharded step: for train
           ``train.train_step.build_jitted_train_step``'s, for prefill and
           decode ``serve.serve_step.make_prefill`` / ``make_decode``'s
           with the mesh
  args:    its arguments as global ``meta`` tensors (the step takes the
           rank's slices: ``sharding.shard_tree`` by ``in_shardings``)
  in_shardings / out_shardings: NamedShardings on ``mesh``
  meta:    params, active_params, tokens, serve_mode and ``mem_in``, the
           inputs of ``hlo_analysis.analytic_hbm_bytes`` (bytes per chip)

``mesh`` is a shape-only ``parallel.sharding.Mesh`` (the production mesh,
``launch.mesh.make_production_mesh``); its ``device`` (``meta`` unless it
names one) is where ``fn`` runs.  Nothing is allocated or run here.

Serving mode: TP by default; where the TP-split bf16 weights would pass
10 GiB per chip, 2-D (each weight's first free dim that the data axes
divide is split over them too, FSDP-style gathering), as the reference
switches (``serve_step.param_shardings``).  The serving step's activation
quantization is per tensor on the kernel route (``models.layers.linear``,
quirk 1 of the reference): under data parallelism that tensor's amax spans
every data rank's rows (``parallel.sharded_lm.wq_product``).
"""
from __future__ import annotations

import math

import torch

from repro_torch import models
from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.parallel import param_specs as pspecs
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.serve import serve_step as ss
from repro_torch.train import train_step as ts


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def sharded_bytes(abstract_tree, shardings, mesh) -> int:
    """Exact per-chip bytes of a sharded tree (leaf bytes / shard count)."""
    total = 0
    for leaf, sh in zip(tree_leaves(abstract_tree), tree_leaves(shardings)):
        factor = 1
        for entry in sh.spec:
            for a in shd.axis_tuple(entry):
                factor *= mesh.shape[a]
        total += math.prod(leaf.shape) * leaf.element_size() // factor
    return total


def param_count(abstract_params) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(abstract_params))


def active_param_count(abstract_params, cfg) -> int:
    """MoE: expert leaves counted at top_k / E utilization."""

    def active(path, leaf):
        n, p = math.prod(leaf.shape), pspecs._path_str(path)
        if "moe/" in p and any(s in p for s in ("w_gate", "w_up", "w_down")) and cfg.moe.n_experts:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        return n

    return sum(tree_leaves(pspecs._map_with_path(active, abstract_params)))


def _abstract_params(cfg, *, max_dec_pos: int = 4096):
    mod = models.build(cfg)
    if cfg.family == "encdec":
        p = mod.init_params(0, cfg, device="meta", max_dec_pos=max_dec_pos)
    else:
        p = mod.init_params(0, cfg, device="meta")
    if cfg.quant.weights_int8:
        from repro_torch.core.quant import quantize_params_int8

        p = quantize_params_int8(p)
    return p


def _train_batch_specs(cfg, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    mb = cfg.microbatches

    def with_mb(shp):
        return (mb, shp[0] // mb) + shp[1:] if mb > 1 else shp

    batch = {"tokens": sds(with_mb((b, s + 1)), torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = sds(with_mb((b, cfg.vlm_patches, cfg.d_model)), torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = sds(with_mb((b, cfg.enc_seq, cfg.d_model)), torch.bfloat16)
    return batch


def _rules(cfg) -> dict:
    return shd.RULE_SETS.get(getattr(cfg, "shard_rules", "default"), shd.DEFAULT_RULES)


def _device(mesh) -> torch.device:
    return mesh.device if mesh.device is not None else torch.device("meta")


def build_cell(cfg, shape_name: str, mesh) -> dict:
    shape = SHAPES[shape_name]
    with shd.use_mesh(mesh, _rules(cfg)):
        if shape.kind == "train":
            return _build_train(cfg, shape, mesh)
        if shape.kind == "prefill":
            return _build_prefill(cfg, shape, mesh)
        return _build_decode(cfg, shape, mesh)


def _mesh_sizes(mesh) -> tuple[int, int]:
    return mesh.size(("pod", "data")), mesh.shape.get("model", 1)


def _dp(mesh):
    dpa = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return dpa if len(dpa) > 1 else dpa[0]


def _build_train(cfg, shape, mesh) -> dict:
    ab_state = ts.abstract_state(cfg)
    batch = _train_batch_specs(cfg, shape)
    st_sh = ts.state_shardings(ab_state, cfg, mesh)
    b_sh = ts.batch_shardings(batch, mesh, mb_leading=cfg.microbatches > 1)
    step = ts.build_jitted_train_step(cfg, mesh, ab_state, batch)
    n = param_count(ab_state["params"])
    return dict(
        kind="train", fn=step, args=(ab_state, batch),
        in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None),
        meta=dict(params=n, active_params=active_param_count(ab_state["params"], cfg),
                  tokens=shape.global_batch * shape.seq_len,
                  mem_in=train_mem_in(cfg, ab_state, st_sh, mesh, shape.global_batch,
                                      shape.seq_len)),
    )


def train_mem_in(cfg, ab_state, st_sh, mesh, global_batch: int, seq_len: int) -> dict:
    """``analytic_hbm_bytes``' inputs for a train step of ``global_batch``
    sequences of ``seq_len`` tokens: per-chip bytes of the sharded params,
    optimizer state, one layer's residual and the logits."""
    dp, ms = _mesh_sizes(mesh)
    mb = cfg.microbatches
    b_loc = global_batch // dp // mb
    s_loc = seq_len // ms if cfg.seq_shard else seq_len
    v_sh = cfg.vocab // ms if cfg.vocab % ms == 0 else cfg.vocab
    opt, opt_sh = ab_state["opt"], st_sh["opt"]
    return dict(
        w_bytes=sharded_bytes(ab_state["params"], st_sh["params"], mesh),
        opt_bytes=(sharded_bytes(opt.master, opt_sh.master, mesh)
                   + sharded_bytes(opt.m, opt_sh.m, mesh)
                   + sharded_bytes(opt.v, opt_sh.v, mesh)),
        resid_bytes=b_loc * max(s_loc, 1) * cfg.d_model * 2,
        n_layers=cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0),
        logits_bytes=b_loc * seq_len * v_sh * 4,
        microbatches=mb,
    )


def _serve_params(cfg, mesh, *, max_dec_pos: int = 4096):
    """Abstract params and their shardings for serving, and the mode: 'tp',
    or '2d' where the TP-split bf16 weights pass 10 GiB per chip
    (``serve_step.param_shardings``)."""
    ab = _abstract_params(cfg, max_dec_pos=max_dec_pos)
    p_sh, mode = ss.param_shardings(ab, cfg, mesh)
    return ab, p_sh, mode


def _build_prefill(cfg, shape, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    ab_params, p_sh, mode = _serve_params(cfg, mesh, max_dec_pos=s + 1)
    prefill = ss.make_prefill(cfg, mesh=mesh, device=_device(mesh), shardings=p_sh)
    tokens = sds((b, s), torch.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = sds((b, cfg.vlm_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        extras["frames"] = sds((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    dp = _dp(mesh)
    tok_sh = NamedSharding(mesh, P(dp, None))
    ex_sh = {k: NamedSharding(mesh, P(dp, *([None] * (v.ndim - 1)))) for k, v in extras.items()}

    n = param_count(ab_params)
    dps, ms = _mesh_sizes(mesh)
    b_loc = b // dps if b % dps == 0 else b
    s_loc = s // ms if cfg.seq_shard else s
    v_sh = cfg.vocab // ms if cfg.vocab % ms == 0 else cfg.vocab
    n_layers_eff = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    mem_in = dict(
        w_bytes=sharded_bytes(ab_params, p_sh, mesh),
        resid_bytes=b_loc * max(s_loc, 1) * cfg.d_model * 2,
        n_layers=n_layers_eff,
        logits_bytes=b_loc * s * v_sh * 4,
    )
    return dict(
        kind="prefill", fn=prefill, args=(ab_params, tokens, extras),
        in_shardings=(p_sh, tok_sh, ex_sh), out_shardings=None,
        meta=dict(params=n, active_params=active_param_count(ab_params, cfg), tokens=b * s,
                  serve_mode=mode, mem_in=mem_in),
    )


def _build_decode(cfg, shape, mesh) -> dict:
    b, s = shape.global_batch, shape.seq_len
    ab_params, p_sh, mode = _serve_params(cfg, mesh, max_dec_pos=s + 1)
    decode, ab_cache = ss.make_decode(cfg, b, s, mesh=mesh, device=_device(mesh), shardings=p_sh)
    c_sh = ss.cache_shardings(ab_cache, cfg, mesh, b, max_seq=s)
    tokens = sds((b, 1), torch.int32)
    extras = {}
    if cfg.family == "encdec":
        extras["memory"] = sds((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
        # per-request cross-attention K/V, projected once at admission
        xkv = (cfg.n_layers, b, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
        extras["cross_kv"] = {"k": sds(xkv, torch.bfloat16), "v": sds(xkv, torch.bfloat16)}
    dpa = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dsize = mesh.size(dpa)
    dp = _dp(mesh)
    tok_sh = NamedSharding(mesh, P(dp, None) if b % dsize == 0 else P())

    def ex_sharding(v):
        axes: list = [None] * v.ndim
        if b % dsize == 0:
            for i, d in enumerate(v.shape):
                if d == b:
                    axes[i] = dp
                    break
        return NamedSharding(mesh, P(*axes))

    ex_sh = tree_unflatten(extras, [ex_sharding(v) for v in tree_leaves(extras)])
    idx = sds((), torch.int32)

    n = param_count(ab_params)
    dps, ms = _mesh_sizes(mesh)
    b_loc = b // dps if b % dps == 0 else b
    v_sh = cfg.vocab // ms if cfg.vocab % ms == 0 else cfg.vocab
    # per-token reads: the cache and any per-request extras (encdec's
    # cross-K/V and encoder memory) cross HBM every step
    extras_bytes = sharded_bytes(extras, ex_sh, mesh) if extras else 0
    mem_in = dict(
        w_bytes=sharded_bytes(ab_params, p_sh, mesh),
        cache_bytes=sharded_bytes(ab_cache, c_sh, mesh) + extras_bytes,
        logits_bytes=b_loc * v_sh * 4,
        n_layers=cfg.n_layers,
    )
    return dict(
        kind="decode", fn=decode, args=(ab_params, tokens, ab_cache, idx, extras),
        in_shardings=(p_sh, tok_sh, c_sh, NamedSharding(mesh, P()), ex_sh),
        out_shardings=(None, c_sh),
        meta=dict(params=n, active_params=active_param_count(ab_params, cfg), tokens=b,
                  serve_mode=mode, mem_in=mem_in),
    )
