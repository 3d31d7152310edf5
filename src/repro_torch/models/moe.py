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

The held-expert layer (``moe_held``, DeepSeek-V3's, taken only where
``cfg.moe.held`` > 0; the layers above are untouched by it): sigmoid scores
of the float32 router product over all ``n_experts``; the top-k chosen by
score plus a selection bias (ties to the lower index), weighted by the
scores normalised over the chosen and scaled; every assignment to an
expert this rank holds computed (dropless), each held expert's three
products at its real row count through ``core.mma.mma_linear`` (one
activation scale per row, so a token's output does not depend on the
tokens routed with it); the shared experts on every token; DeepSeek-V3's
sequence-wise balance loss.  One read of the expert counts per call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import mma
from repro_torch.obs import timeline

from . import layers


def init_moe(g: torch.Generator, cfg, *, device) -> dict:
    """The router (a ``{"w"}`` linear) and the stacked expert weights, bf16,
    each expert tensor normal / sqrt(fan_in); the held-expert layer's
    router spans every expert, its stacks the held ones, and it adds the
    shared experts (an MLP of width ``n_shared * expert_ff``)."""
    m = cfg.moe
    e, d, f = m.held or m.n_experts, cfg.d_model, m.expert_ff

    def ex(shape, fan_in):
        t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        return (t / math.sqrt(fan_in)).to(torch.bfloat16)

    p = {
        "router": layers.init_linear(g, d, m.n_experts, device=device),
        "w_gate": ex((e, d, f), d),
        "w_up": ex((e, d, f), d),
        "w_down": ex((e, f, d), f),
    }
    if m.n_shared:
        p["shared"] = layers.init_mlp(g, cfg, device=device, d_ff=m.n_shared * f)
    return p


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


# ------------------------------------------------------ the held-expert layer


def route_sigmoid(logits: torch.Tensor, bias: torch.Tensor | None, m):
    """DeepSeek-V3's routing of float32 router logits (T, E): scores
    ``s = sigmoid(logits)``; the top-k by ``s + bias`` (the bias selects
    and weighs nothing; ties to the lower index); each chosen expert's
    weight ``s_i / (sum of the chosen s + 1e-20) * routed_scale``.  Returns
    ``(scores, idx, gates)``, idx and gates (T, k)."""
    scores = torch.sigmoid(logits)
    sel = scores.detach() if bias is None else scores.detach() + bias
    _, idx = _top_k(sel, m.top_k)
    top = torch.gather(scores, 1, idx)
    return scores, idx, top / (top.sum(-1, keepdim=True) + 1e-20) * m.routed_scale


def seq_balance(scores: torch.Tensor, idx: torch.Tensor, b: int, m) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance term, the mean over the ``b``
    sequences of ``sum_i f_i P_i``: ``f_i = E / (k T)`` times the tokens
    that chose expert ``i``, ``P_i`` the mean over the sequence's T tokens
    of ``s_i / sum_j s_j`` (without the coefficient)."""
    e = scores.shape[1]
    sc = scores.reshape(b, -1, e)
    t = sc.shape[1]
    p_mean = (sc / sc.sum(-1, keepdim=True)).mean(1)
    picks = idx.reshape(b, -1)
    chosen = torch.zeros((b, e), dtype=torch.float32, device=scores.device).scatter_add_(
        1, picks, torch.ones(picks.shape, dtype=torch.float32, device=scores.device))
    f = chosen * (e / (m.top_k * t))
    return (f * p_mean).sum(-1).mean()


def _expert_linear(x: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    """(M, K) @ (K, N) -> bf16: under ``mma_int8`` the MMA product with one
    activation scale per row (the STE's float32 gradient), else bf16."""
    if quant.mode == "mma_int8":
        return mma.mma_linear(x.to(torch.float32), w.to(torch.float32), planes=quant.planes,
                              impl=quant.impl, batch_axis=0).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))


def held_expert(p: dict, e: int, x: torch.Tensor, quant) -> torch.Tensor:
    """Held expert ``e``'s SwiGLU on its rows x (M, D) -> (M, D) bf16."""
    gate = _expert_linear(x, p["w_gate"][e], quant)
    up = _expert_linear(x, p["w_up"][e], quant)
    h = F.silu(gate.to(torch.float32)).to(torch.bfloat16) * up
    return _expert_linear(h, p["w_down"][e], quant)


def moe_held(p: dict, x: torch.Tensor, cfg, bias: torch.Tensor | None = None):
    """The held-expert layer on x (B, S, D): ``y = sum over the chosen
    experts this rank holds of g_i E_i(x)``, summed in float64, plus the
    shared experts ``S(x)``.  ``bias`` (E,) float32: the selection bias, or
    none.  Returns ``(y, balance, counts)``: ``counts`` (E,) int64 the
    assignments per expert over every expert, ``balance`` the
    :func:`seq_balance` term."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, lo = b * s, m.top_k, m.held_first
    xf = x.reshape(t, d)
    timeline.count("moe.calls")
    with timeline.span("moe.route"):
        logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
        scores, idx, gates = route_sigmoid(logits, bias, m)
        eid = idx.reshape(t * k)
        order = torch.argsort(eid, stable=True)  # assignments by expert, token order within
        counts = torch.bincount(eid, minlength=m.n_experts)
        n = counts.tolist()  # the layer's one read of the counts
        timeline.count("moe.count_reads")
    balance = seq_balance(scores, idx, b, m)
    with timeline.span("moe.dispatch"):
        start = sum(n[:lo])
        held_n = n[lo:lo + m.held]
        rows = order[start:start + sum(held_n)]  # flat (token, slot) ids, by expert
        tok = rows // k
        xg = xf.to(torch.float32)[tok]
        gw = gates.reshape(t * k)[rows]
    timeline.count("moe.assignments", t * k)
    timeline.count("moe.held_assignments", sum(held_n))
    with timeline.span("moe.experts"):
        outs, a = [], 0
        for e, rows_e in enumerate(held_n):
            if rows_e:
                outs.append(held_expert(p, e, xg[a:a + rows_e], cfg.quant))
                timeline.count("moe.expert_calls")
                timeline.count("moe.expert_rows", rows_e)
            a += rows_e
    timeline.count("moe.dropped", sum(held_n) - a)
    with timeline.span("moe.shared"):
        shared = layers.mlp(p["shared"], x, cfg) if m.n_shared else None
    with timeline.span("moe.combine"):
        y = torch.zeros((t, d), dtype=torch.float64, device=x.device)
        if outs:
            contrib = torch.cat(outs).to(torch.float32) * gw[:, None]
            y = y.index_add(0, tok, contrib.to(torch.float64))
        y = y.to(torch.float32).reshape(b, s, d)
        if shared is not None:
            y = y + shared.to(torch.float32)
    return y.to(x.dtype), balance, counts
