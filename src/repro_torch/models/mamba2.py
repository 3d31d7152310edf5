"""Mamba2 (SSD) block: the chunked state-space scan, plus O(1)-state decode.

A forward without state uses the chunk-parallel SSD form (quadratic inside
a chunk of ``CHUNK`` steps, the state carried across chunks in a loop);
decode carries the (H, N, P) state and a short-conv window.

Shapes follow the Mamba2 paper: d_inner = expand * d_model, P = head_dim,
H = d_inner / P heads, N = ssm_state, one B/C group (as Zamba2 has).

Dtypes follow the reference op by op: where it mixes bf16 and float32
operands (``*`` and ``einsum`` promote to float32 in JAX, not in torch) the
bf16 operand is cast to float32 here, and where it rounds to bf16 (the
``C . B`` product, the carried chunk states) so does this.  The float32
leaves (``a_log``, ``dt_bias``, ``d_skip``) stay float32.  The chunked
SSD's products and the gated ``norm``'s mean square accumulate in float64
(``layers.einsum_exact``, ``layers.rmsnorm_exact``), so a sharded step's
rank computes its rows and heads bit-equal to the whole batch's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from . import layers

CHUNK = 256

F32 = torch.float32


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    h = d_inner // p
    n = cfg.ssm_state
    return d_inner, h, p, n


def init_mamba_block(g: torch.Generator, cfg, *, device) -> dict:
    d_inner, h, p, n = dims(cfg)
    conv_dim = d_inner + 2 * n  # x plus the B and C streams get the short conv
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=g, dtype=F32, device=device)
    return {
        "z_proj": layers.init_linear(g, cfg.d_model, d_inner, device=device),
        "xbc_proj": layers.init_linear(g, cfg.d_model, conv_dim, device=device),
        "dt_proj": layers.init_linear(g, cfg.d_model, h, device=device),
        "conv_w": (conv_w / math.sqrt(cfg.ssm_conv)).to(torch.bfloat16),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.bfloat16, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=F32, device=device)),
        "dt_bias": torch.zeros((h,), dtype=F32, device=device),
        "d_skip": torch.ones((h,), dtype=F32, device=device),
        "norm": layers.init_norm(d_inner, device=device),
        "out_proj": layers.init_linear(g, d_inner, cfg.d_model, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _short_conv(p, xbc, conv_state=None):
    """Depthwise causal conv over the window ``cfg.ssm_conv``.  conv_state:
    (B, W-1, C) for decode.  Returns (out, new_state)."""
    w = p["conv_w"].to(xbc.dtype)  # (W, C)
    win = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros(xbc.shape[:1] + (win - 1,) + xbc.shape[2:], dtype=xbc.dtype,
                                 device=xbc.device)
    xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    new_state = xp[:, -(win - 1):, :]
    s = xbc.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, win):  # each product and sum rounded to bf16, left to right
        out = out + xp[:, i:i + s, :] * w[i]
    out = out + p["conv_b"].to(xbc.dtype)
    return F.silu(out.to(F32)).to(xbc.dtype), new_state


def _ssd_chunked(x, dt, a, bmat, cmat):
    """Chunk-parallel SSD.  x: (B, S, H, P) bf16; dt: (B, S, H) float32;
    a: (H,) (> 0 decay rates); bmat/cmat: (B, S, N) bf16.  Returns y:
    (B, S, H, P) float32.  S must be a multiple of ``CHUNK``."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = CHUNK
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    xs = x.reshape(b, nc, q, h, p).to(F32)
    dts = dt.reshape(b, nc, q, h)
    bs = bmat.reshape(b, nc, q, n)
    cs = cmat.reshape(b, nc, q, n)

    # log decay per step: -dt_t * a  (a > 0)
    ls = -dts * a[None, None, None, :]  # (B, NC, Q, H)
    cum = torch.cumsum(ls, dim=2)  # within-chunk cumulative log decay

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li - lj, -torch.inf))
    cb = layers.einsum_exact("bcin,bcjn->bcij", cs, bs, dtype=cs.dtype)  # bf16, as the reference's
    att = cb[..., None].to(F32) * decay * dts[:, :, None, :, :]  # (B, NC, Q, Q, H)
    y_intra = layers.einsum_exact("bcijh,bcjhp->bcihp", att, xs, dtype=F32)

    # chunk-final states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dts  # (B, NC, Q, H)
    sc = layers.einsum_exact("bcjn,bcjhp->bchnp", bs, w_end[..., None] * xs, dtype=F32)

    # inter-chunk carry: state_c = exp(sum ls_c) state_{c-1} + S_c; chunk c
    # reads the state entering it
    total = torch.exp(cum[:, :, -1, :])  # (B, NC, H)
    carry = torch.zeros((b, h, n, p), dtype=F32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = total[:, c, :, None, None] * carry + sc[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, NC, H, N, P)

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) * state_prev)
    w_in = torch.exp(cum)  # (B, NC, Q, H)
    cw = cs.to(F32)[:, :, :, :, None] * w_in[:, :, :, None, :]  # (B, NC, Q, N, H)
    y_inter = layers.einsum_exact("bcinh,bchnp->bcihp", cw, prev_states.to(cmat.dtype), dtype=F32)
    return (y_intra + y_inter).reshape(b, s, h, p)


def ssd_step(ssm, x, dt, a, bmat, cmat):
    """One step of the SSD recurrence: state' = exp(-dt a) state + dt B x^T,
    y = C . state'.  ssm: (B, H, N, P) float32; x: (B, H, P) bf16; dt: (B, H)
    float32; bmat/cmat: (B, N) bf16.  Returns (y (B, H, P), state')."""
    decay = torch.exp(-dt * a[None, :])
    bx = (bmat.to(F32)[:, None, :, None] * dt[:, :, None, None]) \
        * x.to(F32)[:, :, None, :]  # (B, H, N, P)
    new = decay[..., None, None] * ssm + bx
    return torch.einsum("bn,bhnp->bhp", cmat.to(F32), new), new


def mamba_forward(p, x, cfg, *, state=None):
    """x: (B, S, D).  state (decode): {"conv": (B, W-1, C), "ssm": (B, H, N,
    P)}.  Returns (out, new_state); the state given is not changed."""
    d_inner, h, pd, n = dims(cfg)
    bsz, s, _ = x.shape
    z = layers.linear(p["z_proj"], x, cfg.quant)
    xbc = layers.linear(p["xbc_proj"], x, cfg.quant)
    dt = layers.linear(p["dt_proj"], x, cfg.quant)
    dt = _softplus(dt.to(F32) + p["dt_bias"])  # (B, S, H)
    a = torch.exp(p["a_log"])  # (H,) positive decay rates

    xbc, new_conv = _short_conv(p, xbc, None if state is None else state["conv"])
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(bsz, s, h, pd)

    if state is None:
        y = _ssd_chunked(xs, dt, a, bmat, cmat)
        new_ssm = None
    else:
        if s != 1:
            raise ValueError(f"Mamba2 decode takes one token per call, got {s}")
        y, new_ssm = ssd_step(state["ssm"], xs[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0])
        y = y[:, None]

    y = y.to(x.dtype) + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, d_inner)
    y = layers.rmsnorm_exact(p["norm"], y * F.silu(z.to(F32)).to(x.dtype), cfg.norm_eps)
    out = layers.linear(p["out_proj"], y, cfg.quant)
    new_state = None if state is None else {"conv": new_conv, "ssm": new_ssm}
    return out, new_state


def init_state(cfg, batch: int, *, lead: tuple = (), device=None) -> dict:
    """Zero decode state of ``batch`` rows on ``device`` (the CUDA card
    unless ``device='cpu'``); ``lead`` dims go in front (a stack of
    layers)."""
    device = resolve_device(device)
    d_inner, h, pd, n = dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros(lead + (batch, h, n, pd), dtype=F32, device=device),
    }
