"""Serving steps: prefill (prompt -> logits) and decode (one token against a
KV cache of ``max_seq``, or an O(1) recurrent state) for the LM families
the port serves: the transformer families (dense, moe, vlm), Zamba2
(hybrid), RWKV6 (ssm) and Whisper (encdec: the encoder runs once per
request, outside the decode step, which reads its memory from ``extras``).

With a ``mesh`` (``parallel.sharding.Mesh``) :func:`make_prefill` and
:func:`make_decode` return one rank's step, as the reference's run under
``use_mesh``: it takes the rank's slices of the parameters
(``sharding.shard_tree(params, p_sh)``, ``p_sh`` from
:func:`param_shardings`), of the rows (tokens and extras over the data
axes) and of the cache (:func:`cache_shardings`' layout), and returns the
rank's logits (the rank's vocab slice where the head splits over
``model``) and its slice of the new cache.  The step computes in the
layout its family's sharded module needs (``parallel.sharded_lm``,
``sharded_rwkv6``, ``sharded_zamba2``, ``sharded_whisper``); where the
stored layout differs (a recurrent state's split dim, the rule's first dim
equal to ``batch``), the leaves are resharded around the step, every
gather counted.

The MMA quantized datapath (cfg.quant.mode='mma_int8') applies here — this
is where the paper's early-termination knob (quant.planes) meets LM serving.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.device import resolve_device

RECURRENT_FAMILIES = ("hybrid", "ssm")
# the serving mode switches from TP to 2-D where the TP-split bf16 weights
# would pass this many bytes per chip (the reference's 10 GiB).  No
# full-width model small enough for one 80 GB card passes it at a model
# axis of 2, so the card runs the 2-D mode with it lowered to 0
# (chip_smoke.py's phase 17, as tests/test_torch_serve_sharded.py does)
TWO_D_BYTES = 10 * (1 << 30)


def _lm_module(cfg):
    mod = models.build(cfg)
    if cfg.family not in models.PLANE_SCHEDULE_FAMILIES + RECURRENT_FAMILIES + ("encdec",):
        raise ValueError(f"no LM serving step for family {cfg.family!r}")
    return mod


def param_shardings(abstract_params, cfg, mesh):
    """NamedShardings of a serving model's parameters (a tree of tensors,
    ``meta`` or real) and the mode: ``'tp'`` (``param_specs``' rules), or
    ``'2d'`` where the TP-split bf16 weights would pass ``TWO_D_BYTES`` per
    chip: each leaf's first free dim that the data axes divide is split
    over them too, and the step gathers it before use (FSDP-style)."""
    import math

    from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
    from repro_torch.parallel import param_specs as pspecs
    from repro_torch.parallel.sharding import NamedSharding, P

    n = sum(math.prod(t.shape) for t in tree_leaves(abstract_params))
    mode = "2d" if 2 * n / mesh.shape.get("model", 1) > TWO_D_BYTES else "tp"
    p_sh = pspecs.named_shardings(abstract_params, cfg, mesh)
    if mode == "2d":
        dpa = tuple(a for a in ("pod", "data") if a in mesh.shape)
        dsize = mesh.size(dpa)

        def widen(sh, leaf):
            spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
            for i, (sp, dim) in enumerate(zip(spec, leaf.shape)):
                if sp is None and dim % dsize == 0 and dim >= dsize:
                    spec[i] = dpa if len(dpa) > 1 else dpa[0]
                    break
            return NamedSharding(mesh, P(*spec))

        p_sh = tree_unflatten(p_sh, [widen(sh, leaf) for sh, leaf in
                                     zip(tree_leaves(p_sh), tree_leaves(abstract_params))])
    return p_sh, mode


def _specs_2d(shardings):
    """The params' specs where any leaf splits over a data axis (the 2-D
    mode), else None."""
    if shardings is None:
        return None
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.parallel.sharding import axis_tuple

    if not any(a in ("pod", "data") for sh in tree_leaves(shardings) for e in sh.spec
               for a in axis_tuple(e)):
        return None

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else node.spec

    return walk(shardings)


def make_prefill(cfg, *, mesh=None, device=None, shardings=None):
    """prefill(params, tokens, extras) -> logits.  With ``mesh``: one
    rank's step (see the module's docstring); ``shardings``, the params'
    NamedShardings (:func:`param_shardings`), matter only in the 2-D
    mode."""
    mod = _lm_module(cfg)
    dev = resolve_device(device)
    if mesh is not None:
        from repro_torch.parallel import sharded_lm

        specs = _specs_2d(shardings)
        rows = sharded_lm.dp_axes(mesh)

        def sharded_prefill(params, tokens, extras):
            with sharded_lm.rows_over(rows):
                return sharded_lm.serve_prefill(params, tokens, extras, cfg, mesh, dev, specs)[0]

        return sharded_prefill

    def prefill(params, tokens, extras):
        if cfg.family in RECURRENT_FAMILIES:
            return mod.forward(params, tokens, cfg, device=dev)
        if cfg.family == "encdec":
            memory = mod.encode(params, extras["frames"], cfg, device=dev)
            return mod.decode(params, tokens, memory, cfg, device=dev)
        return mod.forward(params, tokens, cfg, prefix_embeds=extras.get("patches"), device=dev)

    return prefill


def init_serving_cache(cfg, batch: int, max_seq: int, *, dtype=torch.bfloat16, device=None):
    """The decode cache a family serves from: the transformer's or Whisper's
    decoder KV cache (of ``dtype``), Zamba2's state of ``max_seq`` (its
    shared block's KV caches are bf16) or RWKV6's (no sequence dim)."""
    mod = _lm_module(cfg)
    if cfg.family == "hybrid":
        return mod.init_state(cfg, batch, max_seq, device=device)
    if cfg.family == "ssm":
        return mod.init_state(cfg, batch, device=device)
    return mod.init_cache(cfg, batch, max_seq, dtype=dtype, device=device)


def make_decode(cfg, batch: int, max_seq: int, *, mesh=None, device=None, shardings=None):
    """Returns (decode_fn, cache_spec).  decode_fn(params, tokens, cache,
    index, extras) -> (logits, cache); cache_spec is the cache's layout as
    tensors on the ``meta`` device (shapes and dtypes, no storage), the
    whole cache's.  With ``mesh``: one rank's step (see the module's
    docstring) at a scalar ``index``; ``shardings`` as
    :func:`make_prefill`'s."""
    mod = _lm_module(cfg)
    dev = resolve_device(device)
    cache_dtype = torch.int8 if cfg.quant.kv_int8 else torch.bfloat16
    spec = init_serving_cache(cfg, batch, max_seq, dtype=cache_dtype, device="meta")
    if mesh is not None:
        return _sharded_decode(cfg, batch, max_seq, mesh, dev, spec, shardings), spec

    if cfg.family == "encdec":
        def decode(params, tokens, cache, index, extras):
            return mod.decode_step(params, tokens, cache, index, cfg, memory=extras["memory"],
                                   cross_kv=extras.get("cross_kv"), device=dev)
    else:
        def decode(params, tokens, cache, index, extras):
            return mod.decode_step(params, tokens, cache, index, cfg, device=dev)

    return decode, spec


def cache_shardings(abstract_cache, cfg, mesh, batch: int, max_seq: int = 0):
    """NamedShardings of a decode cache (a tree of tensors, ``meta`` or
    real), the reference's layout.  Attention KV caches (identified by a
    ``max_seq``-sized dim) split batch over ('pod', 'data') and the
    *sequence* dim over 'model' (the 'kv_seq' rule: decode attention then
    runs as partial softmax per sequence shard).  Recurrent states split
    batch over the data axes and their last dim that |model| divides over
    'model'."""
    from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
    from repro_torch.parallel.sharding import NamedSharding, P

    dpa = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dpsize = mesh.size(dpa)
    msize = mesh.shape.get("model", 1)

    def one(t):
        shape = tuple(t.shape)
        axes: list = [None] * len(shape)
        bdim = -1
        if batch > 1 and batch % dpsize == 0:
            for i, d in enumerate(shape):
                if d == batch:
                    axes[i] = dpa if len(dpa) > 1 else dpa[0]
                    bdim = i
                    break
        sdim = -1
        if max_seq:
            for i in range(bdim + 1, len(shape)):
                if shape[i] == max_seq and shape[i] % msize == 0:
                    axes[i] = "model"
                    sdim = i
                    break
        if sdim < 0:
            for i in range(len(shape) - 1, bdim, -1):
                if axes[i] is None and shape[i] % msize == 0 and shape[i] >= msize:
                    axes[i] = "model"
                    break
        return NamedSharding(mesh, P(*axes))

    return tree_unflatten(abstract_cache, [one(t) for t in tree_leaves(abstract_cache)])


def _batch_dims(cfg, tree):
    """The batch dim of every leaf of a decode cache: Zamba2's group states
    are stacked (groups, layers, B, ...), every other leaf (L, B, ...)."""
    if cfg.family == "hybrid":
        return {k: (2 if k == "groups" else 1) if not isinstance(v, dict)
                else {kk: 2 if k == "groups" else 1 for kk in v} for k, v in tree.items()}
    return {k: 1 for k in tree}


def compute_shardings(cfg, abstract_cache, stored, mesh, rows: tuple):
    """The layout a family's sharded decode computes in, leaf by leaf (a
    tree of NamedShardings): rows over ``rows`` on each leaf's batch
    dim, and over ``model`` an attention cache's sequence (as stored),
    RWKV6's ``tm_s`` and Mamba2's ``ssm`` by the last dim (the value / head
    dim), the carried tokens and conv windows whole."""
    from repro_torch.parallel.sharding import NamedSharding, P, axis_tuple

    msize = mesh.size("model")
    bdims = _batch_dims(cfg, abstract_cache)
    row = (rows if len(rows) > 1 else rows[0]) if rows else None

    def one(name, t, sh, bdim):
        entries = [None] * t.ndim
        if row is not None:
            entries[bdim] = row
        if name in ("k", "v", "attn_k", "attn_v"):
            seq = [i for i, e in enumerate(sh.spec) if "model" in axis_tuple(e)]
            if msize > 1 and (len(seq) != 1 or seq[0] != bdim + 1):
                raise NotImplementedError(
                    f"a KV cache of {tuple(t.shape)} whose sequence 'model' ({msize}) does not "
                    "split")
            entries[bdim + 1] = "model" if msize > 1 else None
        elif name in ("tm_s", "ssm") and t.shape[-1] % msize == 0 and msize > 1:
            entries[-1] = "model"
        return NamedSharding(mesh, P(*entries))

    def walk(node, sh, bd, name=None):
        if isinstance(node, dict):
            return {k: walk(node[k], sh[k], bd[k], k if name is None else k) for k in node}
        return one(name, node, sh, bd)

    return walk(abstract_cache, stored, bdims)


def _sharded_decode(cfg, batch: int, max_seq: int, mesh, dev, spec, shardings):
    from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
    from repro_torch.parallel import sharded_lm

    stored = cache_shardings(spec, cfg, mesh, batch, max_seq)
    dpa = sharded_lm.dp_axes(mesh)
    rows = dpa if batch % mesh.size(dpa) == 0 else ()
    compute = compute_shardings(cfg, spec, stored, mesh, rows)
    stored_specs = [sh.spec for sh in tree_leaves(stored)]
    compute_specs = [sh.spec for sh in tree_leaves(compute)]
    params_2d = _specs_2d(shardings)

    def moved(tree, src, dst):
        return tree_unflatten(tree, [sharded_lm.reshard(t, a, b, mesh) for t, a, b in
                                     zip(tree_leaves(tree), src, dst)])

    def sharded_decode(params, tokens, cache, index, extras):
        with sharded_lm.rows_over(rows):
            work = moved(cache, stored_specs, compute_specs)
            lg, _, new = sharded_lm.serve_decode(params, tokens, work, index, extras, cfg, mesh,
                                                 dev, params_2d)
            return lg, moved(new, compute_specs, stored_specs)

    return sharded_decode
