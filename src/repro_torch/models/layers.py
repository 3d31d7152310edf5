"""Shared building blocks of the LM families: linear (with the MMA quantized
paths), RMSNorm, RoPE, flash attention (chunked online softmax, SWA-capable),
attention with a KV cache, MLPs, embeddings.

Parameters are plain dicts of tensors with the reference's tree; the
``init_*`` functions draw them from a ``torch.Generator`` on the target
device (the reference's ``jax.random`` draws cannot be reproduced — carry
those over with ``transformer.params_from_jax``).  Activations run in the
parameters' dtype (bf16), with every float32 excursion and cast where the
reference makes it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.core import mma
from repro_torch.core import quant as quant_lib
from repro_torch.kernels import ops
from repro_torch.obs import timeline

# Static scale for the int8 KV cache (post-RMSNorm K/V magnitudes are
# ~O(1); 0.05 gives +-6.35 of dynamic range).
KV_CACHE_SCALE = 0.05

# ------------------------------------------------------------ param trees


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_trees(trees: list[dict]) -> dict:
    """Trees of one structure stacked leaf by leaf along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_drawn(make, n: int) -> dict:
    """``stack_trees([make() for _ in range(n)])`` without holding the ``n``
    trees at once: each tree is drawn in turn and copied into its slot of
    the stacked leaves, so the peak is the stack and one tree (a DBRX-132B
    layer holds 6.3 GB of bf16 experts)."""
    first = make()
    out = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                         device=t.device), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def layer_params(blocks: dict, l: int) -> dict:
    """Layer ``l``'s parameters: views ``leaf[l]`` of a stacked tree."""
    return tree_map(lambda t: t[l], blocks)


def remat_on(cfg, blocks) -> bool:
    """Whether a stateless forward rematerialises each of its blocks, as the
    reference's ``jax.checkpoint`` of its scan body under ``cfg.remat ==
    'full'``: only where a gradient of ``blocks`` is being taken (serving
    keeps one forward per block)."""
    return (cfg.remat == "full" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(blocks)))


def params_to(params, device) -> dict:
    """The same parameter tree with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), params)


def params_from_numpy(tree, *, device, float32_keys=None) -> dict:
    """A tree of numpy leaves (the reference's parameters carried over) as
    tensors on ``device``, each leaf keeping its dtype: int8 stays int8,
    numpy bf16 becomes bf16, float32 stays float32.  With
    ``float32_keys``, a float32 leaf stays float32 only under one of those
    keys and becomes bf16 elsewhere (for trees whose bf16 leaves were
    handed over as exact float32)."""

    def leaf(key, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        t = torch.tensor(a, device=device)
        if t.dtype == torch.float32 and float32_keys is not None and key not in float32_keys:
            return t.to(torch.bfloat16)
        return t

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return leaf(key, node)

    return walk(tree)


# ---------------------------------------------------------------- init utils


def generator(seed: int, device: torch.device) -> torch.Generator | None:
    """The seeded generator the ``init_*`` functions draw from on
    ``device``; none on the ``meta`` device, where a draw allocates nothing
    (``train.train_step.abstract_state``)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _dense_init(g: torch.Generator, shape, *, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    return (w / math.sqrt(shape[0])).to(torch.bfloat16)


def init_linear(g: torch.Generator, d_in: int, d_out: int, *, device, bias: bool = False) -> dict:
    p = {"w": _dense_init(g, (d_in, d_out), device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.bfloat16, device=device)
    return p


def init_norm(d: int, *, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.bfloat16, device=device)}


# ------------------------------------------------------------------- kernels


def linear(p: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """Dense layer, routed as the reference routes it:

    - ``w_q`` leaves (pre-quantized int8, ``quant.quantize_params_int8``)
      with ``impl='kernel'``: the scaled CUDA kernel, one activation scale
      per tensor (the fused epilogue takes one scale);
    - ``w_q`` with another impl: ``mma_dot`` then ``acc * (x_scale *
      w_scale)``, one activation scale per batch row;
    - float ``w`` under ``quant.mode == 'mma_int8'``: ``mma.mma_linear``,
      per-row scales (the unscaled kernel for ``impl='kernel'``);
    - otherwise a float product.
    """
    batch_axis = 0 if x.ndim >= 3 else None
    if "w_q" in p:
        planes = quant.planes if quant is not None else 8
        impl = quant.impl if quant is not None else "horner"
        xq = quant_lib.quantize_acts(
            x.to(torch.float32), batch_axis=None if impl == "kernel" else batch_axis
        )
        w_scale = p["w_scale"].squeeze(-2)
        if impl == "kernel":
            out = ops.mma_matmul_scaled(
                xq.values, p["w_q"], xq.scale, w_scale, planes=planes, device=x.device
            ).to(x.dtype)
        else:
            out_i32 = mma.mma_dot(xq.values, p["w_q"], planes=planes, impl=impl)
            out = (out_i32.to(torch.float32) * (xq.scale * w_scale)).to(x.dtype)
    else:
        w = p["w"]
        if quant is not None and quant.mode == "mma_int8":
            out = mma.mma_linear(
                x.to(torch.float32), w.to(torch.float32), planes=quant.planes,
                impl=quant.impl, batch_axis=batch_axis,
            ).to(x.dtype)
        else:
            out = torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The float64 sum of squares over the last dim, kept.  For bf16 (or
    float32 bf16-valued) inputs every square is exact and so is the sum,
    but for a rounding of ~2**-53 of it: the same in any order, so a row
    split into parts and summed again gives the same value.  The sharded
    norms (``parallel.sharded_lm.split_rmsnorm``) all-reduce these."""
    xd = x.to(torch.float64)
    return torch.sum(xd * xd, dim=-1, keepdim=True)


def rmsnorm_exact(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """:func:`rmsnorm` with the mean square from :func:`sum_squares`: the
    norm over heads (RWKV6's ``ln_x``, Mamba2's ``norm``), which a sharded
    step takes over the rank's heads with one all-reduce, bit-equal to
    this one."""
    xf = x.to(torch.float32)
    var = (sum_squares(x) / x.shape[-1]).to(torch.float32)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def einsum_exact(eq: str, *operands: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``torch.einsum`` accumulated in float64, rounded to ``dtype``.  Each
    product of bf16 or float32 operands is exact in float64 and a sum of a
    few thousand of them nearly so, so the rounded result does not depend
    on the reduction order, which cuBLAS picks by shape (on Hopper by a
    tile's place in a stream-K split too): a rank's rows or heads of a
    sharded step come out as they do in the whole batch.  For the float
    products between the recurrent families' quantized linears, whose
    int8 levels a moved ulp can change."""
    return torch.einsum(eq, *(t.to(torch.float64) for t in operands)).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (math.log(theta) / half)
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- flash attention


def _as_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _live_chunks(q_offset, s: int, t: int, chunk: int, causal: bool, window: int) -> range:
    """The key chunks of the chunked pass that some query row may see.

    A chunk that every query row masks leaves the running max, sum and
    accumulator as they were, bit for bit (the max keeps ``m_prev``, the
    correction is exactly 1, or 0 on a sum and accumulator that are still
    0, and every ``p`` is 0, so ``p @ v`` adds zeros for finite v), so the
    pass over the live chunks alone equals the reference's pass over them
    all.  Row ``r`` sees keys ``[q - window + 1, q]`` (causal, windowed) for
    its positions ``q``; the chunks outside the union over the rows are
    skipped, which a long cache with a short query or a window needs (a
    4,096-token prompt against 524,288 positions and a window of 4,096 walks
    9 chunks of 1,024, not 512).  ``q_offset`` as given to
    :func:`flash_attention`: an int or an array is read as it is (a
    training forward's 0 costs no device sync), a device tensor is read
    back to the host; on the ``meta`` device (the dry run's counting mode)
    every chunk is walked."""
    n_chunks = (t + chunk - 1) // chunk
    if not (causal or window):
        return range(n_chunks)
    if torch.is_tensor(q_offset):
        if q_offset.device.type == "meta":
            return range(n_chunks)
        offs = q_offset.reshape(-1).tolist()
    else:
        offs = np.asarray(q_offset).reshape(-1).tolist()
    lo_q, hi_q = min(offs), max(offs) + s - 1
    hi = min(hi_q if causal else t - 1, t - 1)
    lo = max(lo_q - window + 1 if window else 0, 0)
    if hi < lo:
        return range(0)
    return range(lo // chunk, hi // chunk + 1)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    q_offset=0,
) -> torch.Tensor:
    """Chunked online-softmax attention (plain PyTorch, O(S*chunk) memory).

    q: (B, S, H, D); k: (B, T, KV, D), v: (B, T, KV, Dv) with H % KV == 0
    (GQA); the scale is 1/sqrt(D), and the output (B, S, H, Dv).
    ``window`` > 0 limits attention to the last ``window`` keys (SWA).
    ``q_offset``: absolute position of q[0] (decode: T_cache) — an int, a
    0-d tensor, or a (B,) vector of per-row offsets (slot-isolated decode).
    A query row that sees no key gives NaN on the short-query path and 0 on
    the chunked path, as in the reference.
    """
    b, s, h, d = q.shape
    _, t, kv, _ = k.shape
    dv = v.shape[-1]
    groups = h // kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    off = _as_index(q_offset, dev)
    ar_s = torch.arange(s, device=dev)
    if off.ndim > 0:  # per-row offsets
        q_pos = off.reshape(-1, 1) + ar_s[None, :]
    else:
        q_pos = (ar_s + off)[None, :]  # (1, S)
    qg = q.reshape(b, s, kv, groups, d)

    # Short-query (decode) path: one unchunked pass.
    if s <= 8:
        k_pos = torch.arange(t, device=dev)[None, :]
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) * scale
        if causal:
            ok = k_pos[None, :, :] <= q_pos[..., None]
        else:
            ok = torch.ones((1, s, t), dtype=torch.bool, device=dev)
        if window:
            ok = ok & (k_pos[None, :, :] > q_pos[..., None] - window)
        scores = torch.where(ok[:, None, None, :, :], scores, -torch.inf)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m.detach())  # the reference's stop_gradient
        out = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v).to(torch.float32)
        out = out / torch.clamp(p.sum(-1), min=1e-20).permute(0, 3, 1, 2)[..., None]
        return out.reshape(b, s, h, dv).to(q.dtype)

    m_prev = torch.full((b, kv, groups, s), -torch.inf, dtype=torch.float32, device=dev)
    l_prev = torch.zeros((b, kv, groups, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, kv, groups, dv), dtype=torch.float32, device=dev)
    for j in _live_chunks(q_offset, s, t, chunk, causal, window):
        # the last chunk padded with zero keys, as the reference pads k and v
        kj = k[:, j * chunk : (j + 1) * chunk]
        vj = v[:, j * chunk : (j + 1) * chunk]
        if kj.shape[1] < chunk:
            kj = F.pad(kj, (0, 0, 0, 0, 0, chunk - kj.shape[1]))
            vj = F.pad(vj, (0, 0, 0, 0, 0, chunk - vj.shape[1]))
        k_pos = (j * chunk + torch.arange(chunk, device=dev))[:, None]  # (chunk, 1)
        scores = torch.einsum("bskgd,bckd->bkgsc", qg, kj).to(torch.float32) * scale
        if causal:
            ok = k_pos.T <= q_pos[..., None]
        else:
            ok = torch.ones((1, s, chunk), dtype=torch.bool, device=dev)
        if window:
            ok = ok & (k_pos.T > q_pos[..., None] - window)
        ok = ok & (k_pos[:, 0] < t)[None, None, :]
        scores = torch.where(ok[:, None, None, :, :], scores, -torch.inf)
        m_new = torch.maximum(m_prev, scores.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)  # all-masked rows
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isfinite(scores), p, 0.0)
        corr = torch.exp(torch.where(torch.isfinite(m_prev), m_prev - m_safe, -torch.inf))
        corr = torch.where(torch.isfinite(corr), corr, 0.0)
        l_prev = l_prev * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgsc,bckd->bskgd", p.to(q.dtype), vj).to(torch.float32)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m_prev = m_new
    l = torch.clamp(l_prev, min=1e-20)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, dv).to(q.dtype)


# -------------------------------------------------------------------- blocks


def init_attention(g: torch.Generator, cfg, *, device) -> dict:
    hd = cfg.hd
    return {
        "wq": init_linear(g, cfg.d_model, cfg.n_heads * hd, device=device),
        "wk": init_linear(g, cfg.d_model, cfg.n_kv_heads * hd, device=device),
        "wv": init_linear(g, cfg.d_model, cfg.n_kv_heads * hd, device=device),
        "wo": init_linear(g, cfg.n_heads * hd, cfg.d_model, device=device),
    }


def cache_write(c: torch.Tensor, u: torch.Tensor, index) -> None:
    """Write ``u`` (B, s, ...) into the cache ``c`` (B, S_max, ...) in place,
    row ``b`` at position ``index[b]`` (or every row at one scalar index).

    The start is clamped to ``[0, S_max - s]``, as ``dynamic_update_slice``
    clamps it in the reference: a write past the end lands on the last
    ``s`` positions.
    """
    b, s = u.shape[:2]
    start = torch.clamp(_as_index(index, c.device), 0, c.shape[1] - s).expand(b)
    pos = start[:, None] + torch.arange(s, device=c.device)[None, :]  # (B, s)
    c[torch.arange(b, device=c.device)[:, None], pos] = u


def attention(
    p: dict,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor | None,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_index=None,
    causal: bool = True,
):
    """Multi-head attention with GQA/MQA, RoPE, SWA and an optional KV cache.

    x: (B, S, D).  cache: (k, v) each (B, S_max, KV, hd), bf16 or int8 (at
    ``KV_CACHE_SCALE``); cache_index: the write offset, a scalar (every row
    appends at the same position) or a (B,) vector of per-row positions
    (slot-isolated decode: each row writes at its own length).  The cache is
    updated in place (the reference returns a new one; in place saves a copy
    per layer and step).  Returns (out, cache).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    q = linear(p["wq"], x, cfg.quant).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x, cfg.quant).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x, cfg.quant).reshape(b, s, cfg.n_kv_heads, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        if ck.dtype == torch.int8:
            # int8 KV cache with a calibrated static scale
            kq = torch.clamp(torch.round(k.to(torch.float32) / KV_CACHE_SCALE),
                             -127, 127).to(torch.int8)
            vq = torch.clamp(torch.round(v.to(torch.float32) / KV_CACHE_SCALE),
                             -127, 127).to(torch.int8)
            cache_write(ck, kq, cache_index)
            cache_write(cv, vq, cache_index)
            k = (ck.to(torch.float32) * KV_CACHE_SCALE).to(q.dtype)
            v = (cv.to(torch.float32) * KV_CACHE_SCALE).to(q.dtype)
        else:
            cache_write(ck, k.to(ck.dtype), cache_index)
            cache_write(cv, v.to(cv.dtype), cache_index)
            k, v = ck, cv
        new_cache = (ck, cv)
        q_offset = cache_index
    else:
        q_offset = 0

    out = flash_attention(
        q, k, v, causal=causal, window=cfg.swa_window, chunk=cfg.attn_chunk,
        q_offset=q_offset,
    )
    out = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd), cfg.quant)
    return out, new_cache


def init_mla(g: torch.Generator, cfg, *, device) -> dict:
    """Multi-head latent attention's weights (``q_lora_rank`` null): the
    query, the latent KV's down-projection with the shared RoPE key, the
    latent's norm, its up-projection to per-head keys and values, and the
    output."""
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    return {
        "wq": init_linear(g, cfg.d_model, h * (dn + dr), device=device),
        "wkv_a": init_linear(g, cfg.d_model, r + dr, device=device),
        "kv_norm": init_norm(r, device=device),
        "wkv_b": init_linear(g, r, h * (dn + dv), device=device),
        "wo": init_linear(g, h * dv, cfg.d_model, device=device),
    }


def mla_attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor) -> torch.Tensor:
    """Causal multi-head latent attention (DeepSeek-V2), no cache: per head
    q = [q_nope | RoPE(q_pe)] = wq x; [c_kv | k_pe] = wkv_a x with c_kv
    RMS-normed and k_pe = RoPE(k_pe) one head shared by all; per head
    [k_nope | v] = wkv_b c_kv, k = [k_nope | k_pe]; softmax at 1/sqrt(qk
    dim); out = wo concat(o).  x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    with timeline.span("mla.attention"):
        q = linear(p["wq"], x, cfg.quant).reshape(b, s, h, dn + dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
        kva = linear(p["wkv_a"], x, cfg.quant)
        c_kv = rmsnorm(p["kv_norm"], kva[..., :r], cfg.norm_eps)
        k_pe = rope(kva[..., r:].reshape(b, s, 1, dr), positions, cfg.rope_theta)
        kv = linear(p["wkv_b"], c_kv, cfg.quant).reshape(b, s, h, dn + dv)
        k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1)
        out = flash_attention(q, k, kv[..., dn:], causal=True, chunk=cfg.attn_chunk)
        return linear(p["wo"], out.reshape(b, s, h * dv), cfg.quant)


def init_mlp(g: torch.Generator, cfg, *, device, d_ff: int | None = None) -> dict:
    ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": init_linear(g, cfg.d_model, ff, device=device),
            "w_up": init_linear(g, cfg.d_model, ff, device=device),
            "w_down": init_linear(g, ff, cfg.d_model, device=device),
        }
    return {
        "w_up": init_linear(g, cfg.d_model, ff, device=device, bias=True),
        "w_down": init_linear(g, ff, cfg.d_model, device=device, bias=True),
    }


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if "w_gate" in p:
        gate = linear(p["w_gate"], x, cfg.quant)
        up = linear(p["w_up"], x, cfg.quant)
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    else:
        # the reference's jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p["w_up"], x, cfg.quant).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    return linear(p["w_down"], h, cfg.quant)


def init_embedding(g: torch.Generator, vocab: int, d: int, *, device) -> dict:
    t = torch.randn((vocab, d), generator=g, dtype=torch.float32, device=device)
    return {"table": (t * 0.02).to(torch.bfloat16)}


class _Rows(torch.autograd.Function):
    """``table[idx]``, whose gradient sums each row's occurrences in
    float32 and rounds once to the table's dtype.  (Summed in bf16, as the
    stock index backward does, a token that fills a quarter of a batch
    loses its gradient's low bits over hundreds of adds: 4% of a
    vocab-split embedding gradient's norm at OLMoE-1B-7B's width.)"""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g.device)
        acc.index_put_((idx.reshape(-1),), g.reshape(-1, g.shape[-1]).to(torch.float32),
                       accumulate=True)
        return acc.to(g.dtype), None


def embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``table`` (see :class:`_Rows` for the gradient)."""
    return _Rows.apply(table, idx)


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return embed_rows(p["table"], tokens)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["table"].to(x.dtype).T)


def next_token_nll(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S, vocab) logits, in float32."""
    logits = logits.to(torch.float32)
    targets = torch.as_tensor(targets, dtype=torch.int64).to(logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()
