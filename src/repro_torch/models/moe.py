"""Mixture-of-experts FFN: top-k routing and capacity-bounded sort-based
dispatch, as the reference computes them.

Dispatch: flatten the (token, k) assignments, sort them by expert id, give
each expert the first ``cap`` of its assignments (the rest are dropped,
Switch/Mixtral-style), run the expert FFN as batched products over the
stacked expert weights ``(E, cap, D)``, and add each token's weighted
outputs back.  The expert products are plain PyTorch (the reference leaves
them to XLA); the router and the experts stay bf16 under
``quantize_params_int8`` (the experts are raw arrays, not ``{"w": ...}``
linears, and the router's E columns are narrower than its ``min_dim``).

Kept from the reference, as it computes them:

- ties among router probabilities go to the lower expert index
  (``lax.top_k``): a stable descending sort, first k;
- the expert-id sort is stable and each assignment's position in its
  expert's segment is ``searchsorted(side="left")``;
- ``cap = min(T*k, max(int(T*k / E * capacity_factor), 4))``; ``T`` counts
  every token of the call, an idle decode slot's pad token too, so once an
  expert is offered more than ``cap`` tokens a token's output depends on
  its batch mates.  The floor of 4 makes decode at batch <= 4 dropless;
- the combine adds each token's k contributions in bf16 from zero, in
  expert-id order (the order of the reference's scatter-add over the
  sorted assignments).  Here it is k ordered adds, not ``index_add_``,
  whose atomics on CUDA add in no fixed order.

Expert parallelism (``moe_ffn_ep``): the reference's explicit all-to-all
over the mesh's ``model`` axis, on ``torch.distributed`` ranks; without a
mesh it is ``moe_ffn``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers


def init_moe(g: torch.Generator, cfg, *, device) -> dict:
    """The router (a ``{"w"}`` linear) and the stacked expert weights, bf16,
    each expert tensor normal / sqrt(fan_in)."""
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.expert_ff

    def ex(shape, fan_in):
        t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        return (t / math.sqrt(fan_in)).to(torch.bfloat16)

    return {
        "router": layers.init_linear(g, d, e, device=device),
        "w_gate": ex((e, d, f), d),
        "w_up": ex((e, d, f), d),
        "w_down": ex((e, f, d), f),
    }


def capacity(t: int, m) -> int:
    """Slots per expert for ``t`` tokens under ``m`` (a ``MoEConfig``)."""
    return min(t * m.top_k, max(int(t * m.top_k / m.n_experts * m.capacity_factor), 4))


def router_logits(p: dict, xf: torch.Tensor) -> torch.Tensor:
    """(T, D) -> (T, E) float32: the router's bf16 product, then float32."""
    return layers.linear(p["router"], xf).to(torch.float32)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def assignments(logits: torch.Tensor, top_k: int):
    """The top-k routing of ``logits`` (T, E) as its T*k (token, expert)
    assignments sorted by expert id (stable): ``(eid, eid_s, pos, tok_s,
    gw_s)``, ``eid`` unsorted and ``pos`` each sorted assignment's place in
    its expert's segment."""
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    tk = logits.shape[0] * top_k
    eid = idx.reshape(tk)
    tok = torch.arange(tk, device=dev) // top_k  # repeat(arange(T), k), no host sync
    gw = gate.reshape(tk)
    order = torch.argsort(eid, stable=True)
    eid_s, tok_s, gw_s = eid[order], tok[order], gw[order]
    pos = torch.arange(tk, device=dev) - torch.searchsorted(eid_s, eid_s, right=False)
    return eid, eid_s, pos, tok_s, gw_s


def _local_dispatch(xf, logits, n_experts: int, top_k: int, cap: int, dtype):
    """Routing on a token slab: the dispatch buffer ``(E, cap, D)`` and the
    combine metadata ``(eid_s, pos, tok_s, gw_s, keep)``, each over the
    T*k assignments sorted by expert id."""
    d = xf.shape[1]
    _, eid_s, pos, tok_s, gw_s = assignments(logits, top_k)
    keep = pos < cap
    # a dropped assignment writes row ``cap`` of a (cap + 1)-row buffer,
    # which is cut off: the reference's out-of-bounds scatter with mode="drop"
    pos_c = torch.where(keep, pos, cap)
    buf = torch.zeros((n_experts, cap + 1, d), dtype=dtype, device=xf.device)
    buf[eid_s, pos_c] = xf[tok_s].to(dtype)
    return buf[:, :cap], (eid_s, pos, tok_s, gw_s, keep)


def expert_ffn(p: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on the dispatch buffer: (E, C, D) -> (E, C, D)."""
    dt = xe.dtype
    g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(dt))
    h = F.silu(g.to(torch.float32)).to(dt) * u
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))


def _local_combine(oe, meta, t: int, cap: int, dtype):
    """Each token's output: its kept assignments' expert outputs times their
    gate weights, added in bf16 from zero in expert-id order."""
    eid_s, pos = meta[0], meta[1]
    return weighted_combine(oe[eid_s, torch.clamp(pos, max=cap - 1)], meta, t, dtype)


def weighted_combine(contrib, meta, t: int, dtype):
    """``_local_combine`` from each sorted assignment's expert output
    ``contrib`` (T*k, D), however it was gathered."""
    _, _, tok_s, gw_s, keep = meta
    d = contrib.shape[-1]
    k = tok_s.numel() // t
    contrib = contrib * (gw_s * keep)[:, None].to(dtype)
    # a stable sort by token keeps each token's k assignments in the
    # expert-id order of the sorted list: (T, k, D), rank r = r-th expert
    by_tok = contrib[torch.argsort(tok_s, stable=True)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=dtype, device=contrib.device)
    for r in range(k):
        out = out + by_tok[:, r]
    return out


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    cap = capacity(t, m)
    xe, meta = _local_dispatch(xf, router_logits(p, xf), m.n_experts, m.top_k, cap, x.dtype)
    return _local_combine(expert_ffn(p, xe), meta, t, cap, x.dtype).reshape(b, s, d)


def moe_ffn_ep(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Expert parallelism with an explicit all-to-all, as the reference's
    ``shard_map`` computes it.  Under an active mesh with ranks, ``x`` is
    the whole (B, S, D) on every rank and ``p``'s expert leaves
    (``w_gate``, ``w_up``, ``w_down``) are the rank's ``E / |model|``
    experts (``param_specs``: 'experts' over 'model').  Each rank routes its
    (batch, seq) slab by the active rules (default: batch over the data
    axes, seq over 'model'), packs an (M, E_loc, C, D) send buffer (M =
    |model| expert shards), all-to-alls it over 'model', runs its experts,
    all-to-alls back and combines; the slabs are summed into the whole
    output on every rank.  The router's product is float32 (bf16 tokens
    upcast), as the reference's body takes it.

    Without a mesh, or where the reference falls back to its GSPMD path
    (|model| 1, experts or slabs that do not divide, quantization on),
    this is ``moe_ffn`` — which needs every expert on the rank."""
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import axis_tuple, current_mesh, spec_for

    mesh = current_mesh()
    m = cfg.moe
    b, s, d = x.shape
    if mesh is None:
        return moe_ffn(p, x, cfg)
    msize = mesh.shape.get("model", 1)
    x_spec = spec_for(("batch", "seq", None), x.shape)
    b_fac, s_fac = mesh.size(x_spec[0]), mesh.size(x_spec[1])
    if (msize == 1 or m.n_experts % msize or b % b_fac or s % s_fac
            or cfg.quant.mode != "none"):
        if p["w_gate"].shape[0] != m.n_experts:
            raise NotImplementedError(
                "moe_ffn_ep's moe_ffn fallback needs every expert, and this rank holds "
                f"{p['w_gate'].shape[0]} of {m.n_experts}")
        return moe_ffn(p, x, cfg)

    bl, sl = b // b_fac, s // s_fac
    slab_axes = axis_tuple(x_spec[0]) + axis_tuple(x_spec[1])
    # whole tensors in varying use: their gradients sum over the slab axes
    xb = coll.pbroadcast(x, mesh, slab_axes)
    router_w = coll.pbroadcast(p["router"]["w"], mesh, slab_axes)
    w = {k: coll.pbroadcast(p[k], mesh, tuple(a for a in slab_axes if a != "model"))
         for k in ("w_gate", "w_up", "w_down")}
    b0, s0 = mesh.index(x_spec[0]) * bl, mesh.index(x_spec[1]) * sl
    xf = xb[b0:b0 + bl, s0:s0 + sl].reshape(bl * sl, d)
    y = ep_slab(w, xf, router_w, cfg, mesh).reshape(bl, sl, d)
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    out[b0:b0 + bl, s0:s0 + sl] = y.to(torch.float32)
    return coll.all_reduce(out, mesh, slab_axes).to(x.dtype)


def ep_slab(w: dict, xf: torch.Tensor, router_w: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``moe_ffn_ep``'s body on one rank's token slab ``xf`` (T_loc, D):
    route on the float32 product with the whole router ``router_w``, send
    each expert shard its (E_loc, C, D) slab over 'model' (all-to-all), run
    this rank's experts ``w`` on what arrives, send the outputs back and
    combine.  Returns the slab's (T_loc, D)."""
    from repro_torch.parallel import collectives as coll

    m = cfg.moe
    msize = mesh.shape["model"]
    e_loc = m.n_experts // msize
    t_loc, d = xf.shape
    cap = capacity(t_loc, m)
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    xe, meta = _local_dispatch(xf, logits, m.n_experts, m.top_k, cap, xf.dtype)
    # (E, C, D) -> (M, E_loc, C, D): expert e = m' * E_loc + j lives on m'
    recv = coll.all_to_all(xe.reshape(msize, e_loc, cap, d).contiguous(), mesh, "model")
    xcat = recv.transpose(0, 1).reshape(e_loc, msize * cap, d)
    oe = expert_ffn(w, xcat)
    back = oe.reshape(e_loc, msize, cap, d).transpose(0, 1).contiguous()
    oe_local = coll.all_to_all(back, mesh, "model").reshape(m.n_experts, cap, d)
    return _local_combine(oe_local, meta, t_loc, cap, xf.dtype)


def load_balance_loss(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style: E * sum(f_e * P_e))."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(router_logits(p, xf), dim=-1)
    top1 = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
    f = F.one_hot(top1, m.n_experts).to(torch.float32).mean(0)
    pmean = probs.mean(0)
    return m.n_experts * torch.sum(f * pmean)
