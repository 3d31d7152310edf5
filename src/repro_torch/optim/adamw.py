"""AdamW with mixed precision (bf16 params, float32 master copies and
moments), global-norm clipping and decoupled weight decay, on the port's
dict trees.  The constants and the order of every operation are the
reference's, so the same gradients give the same master bits.

The update works leaf by leaf and writes ``master``, ``m`` and ``v`` in
place (each in-place op rounds exactly as its out-of-place form would): at
full width the optimizer state is most of the card's memory, and an
out-of-place update would hold two copies of it.  The state handed to
:func:`update` is therefore consumed, as the reference's jitted train step
donates its input state; read only the returned one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten
from repro_torch.obs import timeline


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    master: object  # float32 copies of the params
    m: object
    v: object


def init(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree_unflatten(params, [p.to(torch.float32, copy=True) for p in leaves]),
        m=tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                  for p in leaves]),
        v=tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                  for p in leaves]),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in ``tree_leaves`` order by a Python ``sum`` (as the reference's
    ``jax.tree.leaves`` order and ``sum``)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    grad_norm: torch.Tensor | None = None,
):
    """Returns ``(new_params, new_state, metrics)``; ``state``'s tensors are
    updated in place (see the module's docstring).  ``grad_norm``: the
    global gradient norm where ``grads`` are one rank's shards (the sharded
    train step computes it across them); else :func:`global_norm`."""
    with timeline.span("adamw.update"):
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        # a tensor numerator: ``number / tensor`` would be a reciprocal times the number
        scale = torch.clamp(gnorm.new_tensor(clip_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        lr_t = torch.as_tensor(lr, dtype=torch.float32, device=t.device)

        p_leaves = tree_leaves(params)
        new_params = []
        for p, g, mast, m, v in zip(p_leaves, tree_leaves(grads), tree_leaves(state.master),
                                    tree_leaves(state.m), tree_leaves(state.v)):
            g = g.to(torch.float32) * scale
            m.mul_(b1).add_(g * (1 - b1))  # m = b1 * m + (1 - b1) * g
            v.mul_(b2).add_(g.square_().mul_(1 - b2))  # v = b2 * v + (1 - b2) * g**2
            delta = m / bc1  # mh
            delta.div_(torch.div(v, bc2, out=g).sqrt_().add_(eps))  # mh / (sqrt(vh) + eps)
            delta.add_(torch.mul(mast, weight_decay, out=g))  # + weight_decay * master
            mast.sub_(delta.mul_(lr_t))  # master - lr * delta
            new_params.append(mast.to(p.dtype))
        new_state = AdamWState(step, state.master, state.m, state.v)
        metrics = {"grad_norm": gnorm, "lr": lr_t}
        return tree_unflatten(params, new_params), new_state, metrics
