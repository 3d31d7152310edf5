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
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch import models
from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, schedule


def make_loss_fn(cfg, *, device=None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` of the config's family,
    on ``device``."""
    mod = models.build(cfg)
    return partial(mod.loss_fn, cfg=cfg, device=device)


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``: the
    gradient with respect to every leaf of ``params``, in the leaf's dtype
    (zeros for a leaf the loss does not reach).  Nothing is kept for a
    later backward: loss and metrics come back detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def train_step(state: dict, batch: dict, cfg, *, peak_lr=3e-4, warmup=100, total=10_000,
               device=None):
    """state = {"params", "opt": AdamWState}; batch leaves (numpy or
    tensors) have a leading microbatch axis (MB, ...) when
    ``cfg.microbatches`` > 1, as the data pipeline makes them.  Returns
    ``(new_state, {"loss", "grad_norm", "lr"})``.

    With several microbatches each one's gradients are summed into float32
    zeros, then divided by the count, and the loss is averaged; with one
    the gradients keep the parameters' dtype.  ``state``'s optimizer
    tensors are updated in place (``optim.adamw``): pass a state once.
    """
    loss_fn = make_loss_fn(cfg, device=resolve_device(device))
    params = state["params"]
    if cfg.microbatches > 1:
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        loss = 0.0
        for i in range(cfg.microbatches):
            mb = {k: v[i] for k, v in batch.items()}
            (mb_loss, _), grads = value_and_grad(loss_fn, params, mb)
            for a, g in zip(acc, tree_leaves(grads)):
                a.add_(g)
            del grads  # before the next microbatch's backward allocates its own
            loss = loss + mb_loss
        grads = tree_unflatten(params, [a.div_(cfg.microbatches) for a in acc])
        loss = loss / cfg.microbatches
    else:
        (loss, _), grads = value_and_grad(loss_fn, params, batch)

    lr = schedule.warmup_cosine(state["opt"].step + 1, peak_lr=peak_lr, warmup=warmup,
                                total=total)
    new_params, new_opt, om = adamw.update(params, grads, state["opt"], lr=lr)
    return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}
