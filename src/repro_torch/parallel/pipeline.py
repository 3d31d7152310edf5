"""Pipeline parallelism (GPipe) over a send/recv ring, the reference's
``shard_map`` + ``lax.ppermute`` schedule on ``torch.distributed`` ranks.

The layer stack is split into |axis| contiguous stages (the stacked
``(L, ...)`` block leaves split over ``axis`` on their layer dim:
:func:`stage_shardings`); microbatches flow stage to stage through
collective-permutes.  Schedule: classic GPipe fill-drain over T = n_micro +
S - 1 ticks.  At tick t stage 0 takes in microbatch t (if any), every stage
applies its layers, the last stage emits microbatch t - S + 1, and the
activations move one stage along the ring.

The embedding's output is kept on stage 0 and the head's loss on the last
stage (both replicated across stages, as in the reference).  As in the
reference, every stage computes every tick, the embedding and the head
included, and selects: so every rank builds the same graph and issues the
backward's collectives in the same order.  Gradients flow back through the
ring (the permutation's transpose is its inverse); every leaf's gradient
on every rank is the whole one (replicated leaves are marked for varying
use, ``collectives.pbroadcast``, over the axes they are used differently
on).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models import layers

from . import collectives as coll
from .sharding import NamedSharding, P, current_mesh


def _layer(blk, h, cfg, positions):
    a, _ = layers.attention(blk["attn"], layers.rmsnorm(blk["ln1"], h, cfg.norm_eps), cfg,
                            positions=positions)
    h = h + a
    return h + layers.mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], h, cfg.norm_eps), cfg)


def _stage_apply(blocks, h, cfg, positions):
    """This stage's layers, in order (remat'd under ``cfg.remat == 'full'``
    while a gradient is taken)."""
    n = tree_leaves(blocks)[0].shape[0]
    for l in range(n):
        blk = layers.layer_params(blocks, l)
        if cfg.remat == "full" and torch.is_grad_enabled():
            h = checkpoint(_layer, blk, h, cfg, positions, use_reentrant=False)
        else:
            h = _layer(blk, h, cfg, positions)
    return h


def stage_shardings(params: dict, mesh, axis: str = "model") -> dict:
    """NamedShardings placing a dense LM's params for the pipeline: every
    block leaf split over ``axis`` on its layer dim, the rest whole."""
    return {k: layers.tree_map(lambda t: NamedSharding(mesh, P(axis) if k == "blocks" else P()), v)
            for k, v in params.items()}


def pipelined_loss_fn(params, batch, cfg, *, n_micro: int, axis: str = "model", device=None):
    """Cross-entropy loss of a dense decoder-only LM under PP over ``axis``
    and DP over the mesh's ('pod', 'data') axes.

    ``params``: this rank's stage (``blocks`` its contiguous layer slice,
    the rest whole); ``batch = {"tokens": (B, S+1)}``, the global batch on
    every rank: microbatch i is rows ``[i * B/n_micro, (i+1) * B/n_micro)``,
    and a data rank takes its slice of each.  Needs an active mesh with
    ranks whose ``axis`` size divides ``cfg.n_layers`` (or a shape-only
    mesh on ``meta`` tensors: the dry run's counting mode).  Returns
    ``(loss, {"nll": loss})``, the loss equal on every rank."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("pipelined_loss_fn requires an active mesh")
    n_stages = mesh.shape[axis]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into {n_stages} stages")
    dpa = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dev = resolve_device(device)
    stage, last = mesh.index(axis), n_stages - 1

    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    b, s = tok.shape[0], tok.shape[1] - 1
    if b % n_micro or (b // n_micro) % mesh.size(dpa):
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches over "
                         f"{mesh.size(dpa)} data ranks")
    mbl = b // n_micro // mesh.size(dpa)
    rows = tok.reshape(n_micro, b // n_micro, s + 1)
    rows = rows[:, mesh.index(dpa) * mbl:(mesh.index(dpa) + 1) * mbl]
    toks, tgts = rows[..., :-1], rows[..., 1:]

    # replicated leaves used differently by stage and by data rank
    blocks = layers.tree_map(lambda t: coll.pbroadcast(t, mesh, dpa), params["blocks"])
    whole = {k: layers.tree_map(lambda t: coll.pbroadcast(t, mesh, (axis, *dpa)), params[k])
             for k in params if k != "blocks"}
    positions = torch.arange(s, device=dev)[None, :]
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == last, device=dev)
    h = torch.zeros((mbl, s, cfg.d_model), dtype=torch.bfloat16, device=dev)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_out = 0
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:  # stage 0 takes in microbatch t
            h = torch.where(first, layers.embed(whole["embed"], toks[t]), h)
        h = _stage_apply(blocks, h, cfg, positions)
        mi = t - (n_stages - 1)
        if 0 <= mi < n_micro:  # the last stage emits microbatch mi
            x = layers.rmsnorm(whole["ln_f"], h, cfg.norm_eps)
            nll = layers.next_token_nll(layers.linear(whole["head"], x, cfg.quant), tgts[mi])
            loss_sum = loss_sum + torch.where(is_last, nll, 0.0)
            n_out += 1
        h = coll.ppermute(h, mesh, axis, ring)
    # the last stage's sum, on every stage; then the mean over data ranks
    loss = coll.all_reduce(loss_sum, mesh, axis) / n_out
    loss = coll.all_reduce(loss, mesh, dpa) / mesh.size(dpa)
    return loss, {"nll": loss}


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1) / (S-1+M)."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)
