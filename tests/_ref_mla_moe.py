"""Plain reference of quantization-aware training of a DeepSeek-V3 block
model (Moonlight-16B-A3B): multi-head latent attention, sigmoid-routed
experts with a selection bias and shared experts, leading dense layers;
int8 forward, straight-through float32 backward, AdamW, the bias's sign
update.

The equations (DeepSeek-V3, arXiv:2412.19437 §2.1; MLA, arXiv:2405.04434),
x the residual stream, pre-norm blocks, a final RMSNorm, an untied head:

* attention, every layer: q = W_q x, per head [q_nope | RoPE(q_pe)];
  [c_kv | k_pe] = W_kva x, c_kv RMS-normed, k_pe = RoPE(k_pe) one head
  shared by all; per head [k_nope | v] = W_kvb c_kv, k = [k_nope | k_pe];
  causal softmax(q k / sqrt(dim q)); out = W_o concat(o);
* routing, the MoE layers: s = sigmoid(x W_r), the product and the sigmoid
  in float32; the top-k by s + b (b the selection bias, ties to the lower
  index); g_i = scale * s_i / (sum of the chosen s + 1e-20);
  y = sum over the chosen experts held of g_i E_i(x), plus S(x), the shared
  experts (one SwiGLU); an expert's rows take one activation scale each;
* balance, per sequence: alpha * sum_i f_i P_i, f_i = E / (k T) times the
  tokens that chose i, P_i the mean of s_i / sum_j s_j; the mean over the
  sequences, summed over the layers;
* after each step, b_i += rate * sign(mean_j c_j - c_i), c the step's
  assignments per expert over every expert.

As the configuration states it: bf16 parameters and activations; RMSNorm,
RoPE, the softmax, the router, an expert's gathered rows and the combine
in float32; every other
linear's forward the int8 product of the activations (symmetric, one
scale per sequence) and the weights (one scale per output column), exact
in float64, rescaled in float32; its gradient the float32 product's (the
straight-through estimator), TF32 off (the caller's flags).  RoPE rotates
the two halves (a checkpoint's interleaved pairs are the same up to a
fixed permutation of the rope columns).  So that it fits beside a card's
state, each layer and each block of query rows is recomputed in the
backward.

Plain PyTorch only: it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def linear(x: torch.Tensor, w: torch.Tensor, qmax: int | None, rows: bool = False):
    """(..., K) bf16 @ (K, N) bf16 -> bf16.  ``qmax``: the int8 (127) or
    lower-precision product's value with the float32 product's gradient,
    one activation scale per sequence (per row with ``rows``); None: the
    bf16 product."""
    if qmax is None:
        return x.to(torch.bfloat16) @ w.to(torch.bfloat16)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    dims = (-1,) if rows else tuple(range(1, xf.ndim))
    xs = torch.clamp(torch.amax(torch.abs(xf.detach()), dim=dims, keepdim=True), min=1e-8) / qmax
    ws = torch.clamp(torch.amax(torch.abs(wf.detach()), dim=0, keepdim=True), min=1e-8) / qmax
    xq = torch.clamp(torch.round(xf.detach() / xs), -qmax, qmax)
    wq = torch.clamp(torch.round(wf.detach() / ws), -qmax, qmax)
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    out = acc * (xs * ws.reshape(-1))
    full = xf @ wf
    return (out + (full - full.detach())).to(torch.bfloat16)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions 0 .. S-1, the two halves rotated."""
    half, s = x.shape[-1] // 2, x.shape[1]
    inv = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                    * (math.log(theta) / half))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attend_rows(q, k, v, r0: int):
    """Query rows r0 .. r0 + len(q) - 1 against keys 0 .. their last."""
    rows, t = q.shape[1], k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * (1.0 / math.sqrt(q.shape[-1]))
    pos = torch.arange(rows, device=q.device)[:, None] + r0
    scores = scores.masked_fill(torch.arange(t, device=q.device)[None, :] > pos, -torch.inf)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bhst,bthd->bshd", p.to(q.dtype), v).to(torch.float32)
    return (pv / p.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)


def attention(q, k, v, block: int) -> torch.Tensor:
    """Causal attention, q and k (B, S, H, Dq), v (B, S, H, Dv), bf16, in
    blocks of ``block`` query rows, each recomputed in the backward."""
    s, outs = q.shape[1], []
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        args = (q[:, r0:r1], k[:, :r1], v[:, :r1], r0)
        outs.append(checkpoint(_attend_rows, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend_rows(*args))
    return torch.cat(outs, dim=1)


def mla(p: dict, x: torch.Tensor, arch: dict, qmax) -> torch.Tensor:
    b, s, _ = x.shape
    h, dn, dr, dv, r = (arch["n_heads"], arch["qk_nope_dim"], arch["qk_rope_dim"],
                        arch["v_head_dim"], arch["kv_lora_rank"])
    q = linear(x, p["wq"]["w"], qmax).reshape(b, s, h, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], arch["rope_theta"])], dim=-1)
    kva = linear(x, p["wkv_a"]["w"], qmax)
    c_kv = rmsnorm(kva[..., :r], p["kv_norm"]["scale"], arch["norm_eps"])
    k_pe = rope(kva[..., r:].reshape(b, s, 1, dr), arch["rope_theta"])
    kv = linear(c_kv, p["wkv_b"]["w"], qmax).reshape(b, s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1)
    o = attention(q, k, kv[..., dn:], arch.get("attn_block", 1024))
    return linear(o.reshape(b, s, h * dv), p["wo"]["w"], qmax)


def swiglu(x, w_gate, w_up, w_down, qmax, rows: bool = False) -> torch.Tensor:
    gate = linear(x, w_gate, qmax, rows)
    up = linear(x, w_up, qmax, rows)
    return linear(F.silu(gate.to(torch.float32)).to(torch.bfloat16) * up, w_down, qmax, rows)


def route(x2: torch.Tensor, router: torch.Tensor, bias, arch: dict):
    """(T, D) -> scores (T, E), chosen (T, k), weights (T, k)."""
    scores = torch.sigmoid(x2.to(torch.float32) @ router.to(torch.float32))
    sel = scores.detach() if bias is None else scores.detach() + bias
    idx = torch.sort(sel, dim=-1, descending=True, stable=True)[1][:, :arch["top_k"]]
    top = torch.gather(scores, 1, idx)
    return scores, idx, top / (top.sum(-1, keepdim=True) + 1e-20) * arch["routed_scale"]


def moe(p: dict, x: torch.Tensor, bias, arch: dict, qmax, shared: bool = True):
    """The expert layer on x (B, S, D): ``(y, balance, counts)``."""
    b, s, d = x.shape
    e_all, k, lo = arch["n_experts"], arch["top_k"], arch["held_first"]
    x2 = x.reshape(b * s, d)
    scores, idx, g = route(x2, p["router"]["w"], bias, arch)
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for j in range(arch["held"]):
        hit = idx == lo + j
        tok = torch.nonzero(hit.any(dim=1))[:, 0]
        if tok.numel():
            ge = (g * hit)[tok].sum(dim=1)
            out = swiglu(x2.to(torch.float32)[tok], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                         qmax, rows=True)
            y = y.index_add(0, tok, out.to(torch.float32) * ge[:, None])
    y = y.reshape(b, s, d)
    if shared and "shared" in p:
        sp = p["shared"]
        y = y + swiglu(x, sp["w_gate"]["w"], sp["w_up"]["w"], sp["w_down"]["w"], qmax).to(
            torch.float32)
    sc = scores.reshape(b, s, e_all)
    frac = torch.zeros((b, e_all), dtype=torch.float32, device=x.device)
    frac = frac.scatter_add(1, idx.reshape(b, -1), torch.ones((b, s * k), device=x.device))
    balance = ((frac * (e_all / (k * s))) * (sc / sc.sum(-1, keepdim=True)).mean(1)).sum(-1).mean()
    counts = torch.bincount(idx.reshape(-1), minlength=e_all)
    return y.to(x.dtype), balance, counts


def _dense_layer(blk, x, arch, qmax):
    eps = arch["norm_eps"]
    x = x + mla(blk["attn"], rmsnorm(x, blk["ln1"]["scale"], eps), arch, qmax)
    m = blk["mlp"]
    return x + swiglu(rmsnorm(x, blk["ln2"]["scale"], eps), m["w_gate"]["w"], m["w_up"]["w"],
                      m["w_down"]["w"], qmax)


def _moe_layer(blk, x, bias, arch, qmax, shared):
    eps = arch["norm_eps"]
    x = x + mla(blk["attn"], rmsnorm(x, blk["ln1"]["scale"], eps), arch, qmax)
    y, bal, counts = moe(blk["moe"], rmsnorm(x, blk["ln2"]["scale"], eps), bias, arch, qmax,
                         shared)
    return x + y, bal, counts


def _layer(stack: dict, i: int) -> dict:
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def forward(params: dict, tokens: torch.Tensor, arch: dict, bias=None, qmax: int | None = 127,
            *, use_bias: bool = True, shared: bool = True):
    """(B, S) tokens -> ``(logits, aux, counts)``: float32 logits, the
    balance terms summed over the layers, and each MoE layer's assignments
    per expert (layers, experts).  ``bias`` (MoE layers, experts) or None;
    the faults: ``use_bias`` False selects without it, ``shared`` False
    leaves the shared experts out."""
    table = params["embed"]["table"]
    x = table.to(torch.float32)[tokens].to(table.dtype)
    ckpt = torch.is_grad_enabled()
    nd = arch["first_dense"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = []
    for i in range(arch["n_layers"]):
        if i < nd:
            args = (_layer(params["dense_blocks"], i), x, arch, qmax)
            x = checkpoint(_dense_layer, *args, use_reentrant=False) if ckpt else \
                _dense_layer(*args)
            continue
        b = None if bias is None or not use_bias else bias[i - nd]
        args = (_layer(params["blocks"], i - nd), x, b, arch, qmax, shared)
        x, bal, c = checkpoint(_moe_layer, *args, use_reentrant=False) if ckpt else \
            _moe_layer(*args)
        aux = aux + bal
        counts.append(c)
    logits = linear(rmsnorm(x, params["ln_f"]["scale"], arch["norm_eps"]), params["head"]["w"],
                    qmax).to(torch.float32)
    return logits, aux, torch.stack(counts)


def loss(params: dict, tokens: torch.Tensor, arch: dict, bias=None, qmax: int | None = 127,
         **fault):
    """Mean next-token cross-entropy of (B, S + 1) tokens plus ``aux_coef``
    times the balance terms, and the assignments per expert (see
    :func:`forward`)."""
    logits, aux, counts = forward(params, tokens[:, :-1], arch, bias, qmax, **fault)
    gold = torch.take_along_dim(logits, tokens[:, 1:, None], dim=-1)[..., 0]
    nll = (torch.logsumexp(logits, dim=-1) - gold).mean()
    return nll + arch["aux_coef"] * aux, counts


def leaves(tree) -> list:
    """Leaves by sorted key, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: list):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        return next(it)

    return build(like)


def lr_at(step: int, opt: dict) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total"]
    s = torch.tensor(float(step), dtype=torch.float32)
    if step < warm:
        return peak * s / max(warm, 1)
    prog = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * prog)))


def bias_update(bias: torch.Tensor, counts: torch.Tensor, rate: float) -> torch.Tensor:
    c = counts.to(torch.float32)
    return bias + rate * torch.sign(c.mean(-1, keepdim=True) - c)


def train(params: dict, batches, arch: dict, opt: dict, *, qmax: int | None = 127,
          use_bias: bool = True, shared: bool = True) -> dict:
    """Steps 1 .. len(batches) from ``params`` (updated in place) and a zero
    selection bias.  Each batch is (microbatches, rows, S + 1) tokens on
    the params' device.  Returns each step's loss, assignments per expert
    (MoE layers, experts) and the bias it selected with, each leaf's norm of
    the first step's
    gradient as the optimizer takes it (clipped), of each leaf's master
    weights' change over all the steps, and the bias."""
    flat = leaves(params)
    dev = flat[0].device
    master = [p.to(torch.float32) for p in flat]
    start = [p.clone() for p in flat]  # the bf16 values the masters start from
    m_st = [torch.zeros_like(m) for m in master]
    v_st = [torch.zeros_like(m) for m in master]
    bias = torch.zeros((arch["n_layers"] - arch["first_dense"], arch["n_experts"]),
                       dtype=torch.float32, device=dev)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad, step_counts, step_bias = [], None, [], []
    for step, batch in enumerate(batches, start=1):
        grads, total, counts = None, 0.0, 0
        for mb in batch:
            live = [p.detach().requires_grad_() for p in flat]
            with torch.enable_grad():
                val, c = loss(unflatten(params, live), mb, arch, bias, qmax,
                              use_bias=use_bias, shared=shared)
                got = torch.autograd.grad(val, live, allow_unused=True)
            got = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)]
            if len(batch) == 1:  # one microbatch: the leaves' own dtype
                grads = list(got)
            elif grads is None:
                grads = [g.to(torch.float32) for g in got]
            else:
                for a, g in zip(grads, got):
                    a.add_(g)
            total, counts = total + float(val.detach()), counts + c
            del got, live
        if len(batch) > 1:
            grads = [a.div_(len(batch)) for a in grads]
        losses.append(total / len(batch))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        if first_grad is None:
            first_grad = [float(torch.linalg.vector_norm(g.to(torch.float32) * scale))
                          for g in grads]
        t = torch.tensor(float(step))
        bc1, bc2 = (1.0 - torch.pow(b1, t)).item(), (1.0 - torch.pow(b2, t)).item()
        lr = lr_at(step, opt)
        for i in range(len(grads)):
            g = grads[i].to(torch.float32) * scale
            m_st[i].mul_(b1).add_(g * (1 - b1))
            v_st[i].mul_(b2).add_(g.mul_(g).mul_(1 - b2))
            grads[i] = None
            delta = (m_st[i] / bc1).div_(torch.sqrt(v_st[i] / bc2).add_(eps))
            master[i].sub_(delta.add_(master[i] * wd).mul_(lr))
            flat[i].copy_(master[i].to(flat[i].dtype))
            del g, delta
        step_counts.append(counts.cpu())
        step_bias.append(bias.cpu())
        bias = bias_update(bias, counts, arch["bias_rate"])
    return {"losses": losses, "first_grad": first_grad, "bias": bias, "counts": step_counts,
            "biases": step_bias,
            "change": [float(torch.linalg.vector_norm(m - s.to(torch.float32)))
                       for m, s in zip(master, start)]}
