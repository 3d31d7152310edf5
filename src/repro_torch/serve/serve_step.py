"""Serving steps: prefill (prompt -> logits) and decode (one token against a
KV cache of ``max_seq``, or an O(1) recurrent state) for the LM families
the port serves: the transformer families (dense, moe, vlm), Zamba2
(hybrid), RWKV6 (ssm) and Whisper (encdec: the encoder runs once per
request, outside the decode step, which reads its memory from ``extras``).

The MMA quantized datapath (cfg.quant.mode='mma_int8') applies here — this
is where the paper's early-termination knob (quant.planes) meets LM serving.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.device import resolve_device

RECURRENT_FAMILIES = ("hybrid", "ssm")


def _lm_module(cfg):
    mod = models.build(cfg)
    if cfg.family not in models.PLANE_SCHEDULE_FAMILIES + RECURRENT_FAMILIES + ("encdec",):
        raise ValueError(f"no LM serving step for family {cfg.family!r}")
    return mod


def make_prefill(cfg, *, device=None):
    mod = _lm_module(cfg)
    dev = resolve_device(device)

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


def make_decode(cfg, batch: int, max_seq: int, *, device=None):
    """Returns (decode_fn, cache_spec).  decode_fn(params, tokens, cache,
    index, extras) -> (logits, cache); cache_spec is the cache's layout as
    tensors on the ``meta`` device (shapes and dtypes, no storage)."""
    mod = _lm_module(cfg)
    dev = resolve_device(device)
    cache_dtype = torch.int8 if cfg.quant.kv_int8 else torch.bfloat16
    spec = init_serving_cache(cfg, batch, max_seq, dtype=cache_dtype, device="meta")

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
