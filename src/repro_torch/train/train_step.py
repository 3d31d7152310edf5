"""The train step: gradient accumulation over microbatches, then the AdamW
update, as the reference's ``train_step`` computes it on one device.

The state is a tree in, tree out: ``{"params": ..., "opt": AdamWState}``.
Gradients come from ``torch.autograd.grad`` over the tree's leaves, each in
its leaf's dtype, as ``jax.value_and_grad`` gives them.  Under
``quant.mode == "mma_int8"`` every linear's forward is the int8 product
through the MMA datapath (the unscaled CUDA kernel for ``impl='kernel'``
on the card) and its gradient the float product's (the straight-through
estimator of ``core.mma.mma_linear``); the backward's products are stock
float32 matmuls, as the reference leaves them to XLA.

Under a device mesh (:func:`build_jitted_train_step`) the step runs on one
rank's shards: the loss is ``parallel.sharded_lm.loss_fn`` on the rank's
rows, the gradients are averaged over the data-parallel axes
(``('pod', 'data')``), and the clipping norm sums squares over every
shard, a replicated leaf once.  The reference's donated jit becomes the
in-place update the optimizer already makes.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch import models
from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.obs import timeline
from repro_torch.optim import adamw, schedule
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import param_specs as pspecs
from repro_torch.parallel import sharded_lm
from repro_torch.parallel import sharding as shd


def make_loss_fn(cfg, *, device=None, **kw) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` of the config's family,
    on ``device`` (``kw``: the family's further options, such as
    ``router_bias``)."""
    mod = models.build(cfg)
    return partial(mod.loss_fn, cfg=cfg, device=device, **kw)


def update_router_bias(bias: torch.Tensor, counts: torch.Tensor, rate: float) -> torch.Tensor:
    """DeepSeek-V3's selection-bias update after a step: each layer's
    ``b_i + rate * sign(mean_j c_j - c_i)``, ``c`` the step's assignments
    per expert (MoE layers, experts)."""
    c = counts.to(torch.float32)
    return bias + rate * torch.sign(c.mean(-1, keepdim=True) - c)


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``: the
    gradient with respect to every leaf of ``params``, in the leaf's dtype
    (zeros for a leaf the loss does not reach).  Nothing is kept for a
    later backward: loss and metrics come back detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        with timeline.span("train_step.forward"):
            loss, metrics = loss_fn(tree_unflatten(params, live), batch)
        with timeline.span("train_step.backward"):
            grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def train_step(state: dict, batch: dict, cfg, *, peak_lr=3e-4, warmup=100, total=10_000,
               device=None, shardings=None):
    """state = {"params", "opt": AdamWState}; batch leaves (numpy or
    tensors) have a leading microbatch axis (MB, ...) when
    ``cfg.microbatches`` > 1, as the data pipeline makes them.  Returns
    ``(new_state, {"loss", "grad_norm", "lr"})``.

    With several microbatches each one's gradients are summed into float32
    zeros, then divided by the count, and the loss is averaged; with one
    the gradients keep the parameters' dtype.  ``state``'s optimizer
    tensors are updated in place (``optim.adamw``): pass a state once.

    ``shardings`` (the params' NamedShardings on a mesh with ranks): the
    state is this rank's shards and the batch its rows; see the module's
    docstring.

    A held-expert config's state also holds ``"router_bias"``
    (``transformer.init_router_bias``): the forward selects with it, and it
    takes no gradient and no decay; after the update it moves by
    :func:`update_router_bias` on the step's assignments per expert, which
    the metrics give as ``"expert_counts"``.
    """
    with timeline.span("train_step"):
        dev = resolve_device(device)
        mesh = None if shardings is None else tree_leaves(shardings)[0].mesh
        bias = state.get("router_bias")
        counts = None
        if bias is not None:
            loss_fn = make_loss_fn(cfg, device=dev, router_bias=bias)
        elif mesh is None:
            loss_fn = make_loss_fn(cfg, device=dev)
        else:
            loss_fn = partial(sharded_lm.loss_fn, cfg=cfg, mesh=mesh, device=dev)
        params = state["params"]
        if cfg.microbatches > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            loss = 0.0
            for i in range(cfg.microbatches):
                with timeline.span("train_step.microbatch", rid=i):
                    mb = {k: v[i] for k, v in batch.items()}
                    (mb_loss, mbm), grads = value_and_grad(loss_fn, params, mb)
                    if bias is not None:
                        c = mbm["expert_counts"]
                        counts = c if counts is None else counts + c
                    with timeline.span("train_step.accumulate"):
                        for a, g in zip(acc, tree_leaves(grads)):
                            a.add_(g)
                    del grads  # before the next microbatch's backward allocates its own
                    loss = loss + mb_loss
            grads = tree_unflatten(params, [a.div_(cfg.microbatches) for a in acc])
            del acc  # held by ``grads`` alone, which the mesh's mean below replaces
            loss = loss / cfg.microbatches
        else:
            with timeline.span("train_step.microbatch", rid=0):
                (loss, mbm), grads = value_and_grad(loss_fn, params, batch)
            counts = mbm.get("expert_counts")

        gnorm = None
        if mesh is not None:
            dp = sharded_lm.dp_axes(mesh)
            n_dp = mesh.size(dp)
            grads = tree_unflatten(params, [
                (coll.all_reduce(g.to(torch.float32), mesh, dp) / n_dp).to(g.dtype)
                for g in tree_leaves(grads)])
            loss = coll.all_reduce(torch.as_tensor(loss, dtype=torch.float32, device=dev), mesh,
                                   dp) / n_dp
            gnorm = global_norm(grads, shardings)
        lr = schedule.warmup_cosine(state["opt"].step + 1, peak_lr=peak_lr, warmup=warmup,
                                    total=total)
        new_params, new_opt, om = adamw.update(params, grads, state["opt"], lr=lr,
                                               grad_norm=gnorm)
        new_state, metrics = {"params": new_params, "opt": new_opt}, {"loss": loss, **om}
        if bias is not None:
            new_state["router_bias"] = update_router_bias(bias, counts, cfg.moe.bias_rate)
            metrics["expert_counts"] = counts
        return new_state, metrics


def global_norm(grads, shardings) -> torch.Tensor:
    """The global L2 norm of a sharded gradient tree: each leaf's float32
    sum of squares over its shard, summed over the axes it is split on, a
    replicated leaf counted once."""
    by_axes: dict[tuple, torch.Tensor] = {}
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        axes = tuple(a for e in sh.spec for a in shd.axis_tuple(e))
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    mesh = tree_leaves(shardings)[0].mesh
    return torch.sqrt(sum(coll.all_reduce(sq, mesh, axes) for axes, sq in by_axes.items()))


def abstract_state(cfg) -> dict:
    """The whole train state on the ``meta`` device: shapes and dtypes, no
    allocation (the reference's ``eval_shape``)."""
    mod = models.build(cfg)
    if cfg.family == "encdec":
        p = mod.init_params(0, cfg, device="meta", max_dec_pos=4096)
    else:
        p = mod.init_params(0, cfg, device="meta")
    return {"params": p, "opt": adamw.init(p)}


def state_shardings(abstract: dict, cfg, mesh) -> dict:
    """NamedShardings for the whole train state: the optimizer's master
    copies and moments follow the params, the step is replicated."""
    opt = abstract["opt"]
    return {
        "params": pspecs.named_shardings(abstract["params"], cfg, mesh),
        "opt": type(opt)(
            step=shd.NamedSharding(mesh, shd.P()),
            master=pspecs.named_shardings(opt.master, cfg, mesh),
            m=pspecs.named_shardings(opt.m, cfg, mesh),
            v=pspecs.named_shardings(opt.v, cfg, mesh),
        ),
    }


def batch_shardings(abstract_batch: dict, mesh, mb_leading: bool = False) -> dict:
    """Each batch leaf's rows split by the active rule set's 'batch' mapping
    (('pod', 'data') by default; every axis under 'ep_dp'); with
    ``mb_leading`` the leading microbatch dim stays whole and dim 1 is
    split.  Leaves are meta (or real) tensors."""

    def one(t):
        nd = t.ndim
        if nd == 0:
            return shd.NamedSharding(mesh, shd.P())
        names: list = [None] * nd
        names[1 if (mb_leading and nd > 1) else 0] = "batch"
        with shd.use_mesh(mesh, shd.active_rules()):
            return shd.named_sharding(*names, shape=tuple(t.shape))

    return {k: one(v) for k, v in abstract_batch.items()}


def build_jitted_train_step(cfg, mesh, abstract_st: dict, abstract_batch: dict):
    """The train step on ``mesh`` (the reference's jit with shardings and
    donation): ``step(state, batch) -> (state, metrics)`` where ``state`` is
    this rank's shards (``sharding.shard_tree(state, state_shardings(...))``)
    and ``batch`` the global batch, of which the step takes the rank's rows.
    The state is updated in place."""
    st_sh = state_shardings(abstract_st, cfg, mesh)
    b_sh = batch_shardings(abstract_batch, mesh, mb_leading=cfg.microbatches > 1)

    def step(state, batch):
        local = shd.shard_tree({k: torch.as_tensor(v) for k, v in batch.items()}, b_sh)
        with shd.use_mesh(mesh):
            return train_step(state, local, cfg, shardings=st_sh["params"], device=mesh.device)

    return step
