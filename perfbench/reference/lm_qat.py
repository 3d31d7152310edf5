"""Plain reference of quantization-aware training of a dense (Llama-style)
decoder: int8 forward, straight-through float32 backward, AdamW.

As the configuration states it, and worked out from the weights and tokens
alone:

* bf16 parameters and activations; RMSNorm, RoPE and the softmax in float32;
* every linear's forward the int8 product of the activations (symmetric,
  one scale per sequence) and the weights (one scale per output column),
  exact in float64, rescaled in float32; its gradient the float32 product's
  (the straight-through estimator), TF32 off;
* causal grouped-query attention, SwiGLU, next-token cross-entropy in
  float32; the embedding's gradient summed in float32;
* gradients summed over the microbatches in float32 and divided by their
  number; AdamW with float32 master weights and moments, global-norm
  clipping, decoupled weight decay, a linear warm-up to a cosine.

Plain PyTorch only: it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _linear(x: torch.Tensor, w: torch.Tensor, qmax: int) -> torch.Tensor:
    """(B, S, K) bf16 @ (K, N) bf16: the int8 product's value, the float32
    product's gradient, rounded to bf16."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    xs = torch.clamp(torch.amax(torch.abs(xf.detach()), dim=(1, 2), keepdim=True), min=1e-8) / qmax
    ws = torch.clamp(torch.amax(torch.abs(wf.detach()), dim=0, keepdim=True), min=1e-8) / qmax
    xq = torch.clamp(torch.round(xf.detach() / xs), -qmax, qmax)
    wq = torch.clamp(torch.round(wf.detach() / ws), -qmax, qmax)
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
    out = acc * (xs * ws.reshape(-1))
    full = xf @ wf
    return (out + (full - full.detach())).to(torch.bfloat16)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions 0 .. S-1, the two halves rotated."""
    half, s = x.shape[-1] // 2, x.shape[1]
    inv = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                    * (math.log(theta) / half))
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA; q (B, S, H, D), k and v (B, S, KV, D), bf16."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) * (1.0 / math.sqrt(d))
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -torch.inf)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v).to(torch.float32)
    out = pv / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def loss(params: dict, tokens: torch.Tensor, arch: dict, qmax: int = 127) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S + 1) tokens."""
    table = params["embed"]["table"]
    x = table.to(torch.float32)[tokens[:, :-1]].to(table.dtype)
    b, s, _ = x.shape
    hd, eps = arch["d_model"] // arch["n_heads"], arch["norm_eps"]
    blocks = params["blocks"]
    at, mlp = blocks["attn"], blocks["mlp"]
    for layer in range(arch["n_layers"]):
        h = _rmsnorm(x, blocks["ln1"]["scale"][layer], eps)
        q = _rope(_linear(h, at["wq"]["w"][layer], qmax).reshape(b, s, -1, hd), arch["rope_theta"])
        k = _rope(_linear(h, at["wk"]["w"][layer], qmax).reshape(b, s, -1, hd), arch["rope_theta"])
        v = _linear(h, at["wv"]["w"][layer], qmax).reshape(b, s, -1, hd)
        x = x + _linear(_attention(q, k, v).reshape(b, s, -1), at["wo"]["w"][layer], qmax)
        h = _rmsnorm(x, blocks["ln2"]["scale"][layer], eps)
        gate = _linear(h, mlp["w_gate"]["w"][layer], qmax)
        up = _linear(h, mlp["w_up"]["w"][layer], qmax)
        act = F.silu(gate.to(torch.float32)).to(x.dtype) * up
        x = x + _linear(act, mlp["w_down"]["w"][layer], qmax)
    logits = _linear(_rmsnorm(x, params["ln_f"]["scale"], eps), params["head"]["w"], qmax)
    logits = logits.to(torch.float32)
    gold = torch.take_along_dim(logits, tokens[:, 1:, None], dim=-1)[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


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


def train(params: dict, batches, arch: dict, opt: dict, *, qmax: int = 127,
          rows: slice | None = None) -> dict:
    """Steps 1 .. len(batches) from ``params`` (updated in place).  Each
    batch is (microbatches, rows, S + 1) tokens on the params' device.
    ``rows`` (a fault reading) keeps only those rows of each microbatch.
    Returns each step's loss, each leaf's norm of the first step's gradient
    as the optimizer takes it (clipped) and of each leaf's master weights'
    change over all the steps."""
    flat = leaves(params)
    master = [p.to(torch.float32) for p in flat]
    start = [m.clone() for m in master]
    m_st = [torch.zeros_like(m) for m in master]
    v_st = [torch.zeros_like(m) for m in master]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=1):
        acc = [torch.zeros_like(m) for m in master]
        total = 0.0
        for mb in batch:
            mb = mb if rows is None else mb[rows]
            live = [p.detach().requires_grad_() for p in flat]
            with torch.enable_grad():
                val = loss(unflatten(params, live), mb, arch, qmax)
                grads = torch.autograd.grad(val, live)
            for a, g in zip(acc, grads):
                a.add_(g)
            total = total + float(val.detach())
            del grads, live
        grads = [a / len(batch) for a in acc]
        del acc
        losses.append(total / len(batch))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        if first_grad is None:
            first_grad = [float(torch.linalg.vector_norm(g * scale)) for g in grads]
        t = torch.tensor(float(step))
        bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
        lr = lr_at(step, opt)
        for i, g in enumerate(grads):
            g = g * scale
            m_st[i] = b1 * m_st[i] + g * (1 - b1)
            v_st[i] = b2 * v_st[i] + (g * g) * (1 - b2)
            delta = (m_st[i] / bc1.item()) / (torch.sqrt(v_st[i] / bc2.item()) + eps)
            master[i] = master[i] - lr * (delta + wd * master[i])
            flat[i].copy_(master[i].to(flat[i].dtype))
        del grads
    return {"losses": losses, "first_grad": first_grad,
            "change": [float(torch.linalg.vector_norm(m - s)) for m, s in zip(master, start)]}
