"""RWKV6's loss on one rank of a device mesh (the 'ssm' family), under the
reference's rules (``param_specs``): what GSPMD computes, with the layouts
and collectives written out on ``sharded_lm``'s pieces.

The time-mix runs the rank's heads.  ``wr``/``wk``/``wv``/``wg`` are
column-parallel (the rank's heads' columns) and ``wo`` row-parallel.  The
leaves the rules split off the head boundary come whole first
(``sharded_lm._gathered``): ``mix_lora_a``'s 5 x 64 LoRA columns,
``mix_base`` and ``w_lora_b`` (split on d), ``w_lora_a`` (on its 64
columns) and ``u`` (on the head dim).  So the ddlerp and the decay LoRA are
the unsharded products on every rank (``rwkv6.lora_linear``), and each rank
takes its heads' decay and rows of ``u``.  The WKV recurrence runs on the rank's heads;
``ln_x``, a norm over every head, is ``sharded_lm.split_rmsnorm``.  Where
the head count does not divide the model axis, r, k and v are gathered and
every head runs on every rank; ``ln_x`` is then whole and each rank keeps
the slice of ``y`` that ``wo`` contracts.

The channel mix: ``wk`` column-parallel, ``wv`` row-parallel, and ``wr``'s
split output gathered (for replicated use: ``r * kv`` is the residual's)
before the product.

Each sublayer's input is marked for varying use over ``model`` at its
start, so each rank's gradient of it is its share (summed in the
backward); replicated leaves used inside are marked the same way.  Under
``mma_int8`` the quantized linears are ``sharded_lm``'s (global maxes,
int32 partials all-reduced); the LoRAs are float products, as in the
reference.  Blocks are rematerialised as the unsharded forward's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models import rwkv6

from . import collectives as coll
from .sharded_lm import MODEL, _column, _gathered, _row, _slice, _varying, embed, linear, \
    logits, nll, split_rmsnorm, w_dims


def _whole(p: dict, full: int, mesh) -> dict:
    """A LoRA's linear whole on every rank, float or pre-quantized."""
    if "w" in p:
        return {"w": _gathered(p["w"], full, mesh)}
    return {"w_q": _gathered(p["w_q"], full, mesh), "w_scale": _gathered(p["w_scale"], full, mesh)}


def _tm_inputs(p: dict, x: torch.Tensor, cfg, mesh, last=None):
    """The time mix up to the WKV: r, k, v and g (the rank's columns) and
    the log decay (every channel); ``last`` the carried token (whole)."""
    b, s, d = x.shape
    quant, lr = cfg.quant, rwkv6.LORA_R
    xb = _varying(x, mesh)
    delta = rwkv6._shift(xb, last) - xb
    lora = torch.tanh(rwkv6.lora_linear(_whole(p["mix_lora_a"], 5 * lr, mesh), xb)
                      .reshape(b, s, 5, lr))
    dyn = layers.einsum_exact("bsfr,frd->bsfd", lora, _varying(p["mix_lora_b"], mesh),
                              dtype=x.dtype)
    mix = _gathered(p["mix_base"], d, mesh).to(x.dtype)[None, None] + dyn
    xr, xk, xv, xw, xg = [xb + delta * mix[:, :, i, :] for i in range(5)]
    r = _column(p["wr"], xr, quant, mesh, d)
    k = _column(p["wk"], xk, quant, mesh, d)
    v = _column(p["wv"], xv, quant, mesh, d)
    g = F.silu(_column(p["wg"], xg, quant, mesh, d).to(torch.float32))
    wl = torch.tanh(rwkv6.lora_linear(_whole(p["w_lora_a"], lr, mesh), xw))
    wd = rwkv6.lora_linear({"w": _gathered(p["w_lora_b"], d, mesh)}, wl)
    logw = _varying(p["w_base"], mesh)[None, None, :] + wd.to(torch.float32)
    return r, k, v, g, logw


def _out(p: dict, y: torch.Tensor, g: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``wo`` on ``y * g``: ``y`` whole, ``g`` the rank's columns."""
    if w_dims(p["wo"])[0] == y.shape[-1]:
        return linear(p["wo"], (y.to(torch.float32) * g).to(y.dtype), cfg.quant, mesh)
    return _row(p["wo"], (_slice(y, 2, mesh).to(torch.float32) * g).to(y.dtype), cfg.quant, mesh)


def time_mix(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``rwkv6.time_mix`` (no state) on this rank's heads; ``x`` replicated."""
    h, pd = rwkv6.dims(cfg)
    b, s, d = x.shape
    m, quant = mesh.size(MODEL), cfg.quant
    r, k, v, g, logw = _tm_inputs(p, x, cfg, mesh)
    heads_ok = h % m == 0
    if heads_ok:  # the rank's heads
        logw = _slice(logw, 2, mesh)
        u = _slice(_gathered(p["u"], pd, mesh), 0, mesh)
    else:  # every head on every rank
        r, k, v = (_gathered(t, d, mesh) for t in (r, k, v))
        u = _gathered(p["u"], pd, mesh)
    hl = u.shape[0]
    w = torch.exp(-torch.exp(logw)).reshape(b, s, hl, pd)
    f32 = torch.float32
    y, _ = rwkv6.wkv(*(t.reshape(b, s, hl, pd).to(f32) for t in (r, k, v)), w, u.to(f32),
                     torch.zeros((b, hl, pd, pd), dtype=f32, device=x.device))
    y = y.reshape(b, s, hl * pd).to(x.dtype)
    if heads_ok:
        y = split_rmsnorm(p["ln_x"], y, cfg.norm_eps, mesh)
    else:
        ln_x = {"scale": _varying(p["ln_x"]["scale"], mesh)}
        y = _slice(layers.rmsnorm_exact(ln_x, y, cfg.norm_eps), 2, mesh)  # wo's rows
    return _row(p["wo"], (y.to(f32) * g).to(x.dtype), quant, mesh)


def time_mix_state(p: dict, x: torch.Tensor, cfg, mesh, st: torch.Tensor, last: torch.Tensor):
    """``rwkv6.time_mix`` with a state, in the decode state's layout: ``st``
    (B, H, P, P_l) holds the rank's slice of the *value* dim (the
    reference's ``cache_shardings``), ``last`` (B, D) the carried token,
    whole.  r, k and every head's decay come whole on every rank (one
    all-gather), v as the rank's value columns of each head; the WKV
    recurrence then runs on the rank's slice of every head's state, bit for
    bit the unsharded one's columns (its sums run over the key dim, whole
    here).  ``ln_x``'s float64 sum of squares is all-reduced over
    ``model``; ``y`` is gathered (O(B·S·D)) for ``wo``.  Returns (out, new
    state slice)."""
    h, pd = rwkv6.dims(cfg)
    b, s, d = x.shape
    f32 = torch.float32
    r, k, v, g, logw = _tm_inputs(p, x, cfg, mesh, last)
    r, k, v = _qkv_cat((r, k, v), d, mesh)
    ql = st.shape[-1]
    q0 = mesh.index(MODEL) * ql if ql != pd else 0
    v = v.reshape(b, s, h, pd)[..., q0:q0 + ql]
    u = _gathered(p["u"], pd, mesh)
    w = torch.exp(-torch.exp(logw)).reshape(b, s, h, pd)
    y, st = rwkv6.wkv(r.reshape(b, s, h, pd).to(f32), k.reshape(b, s, h, pd).to(f32),
                      v.to(f32), w, u.to(f32), st)
    y = y.to(x.dtype)  # (B, S, H, P_l)
    ss = coll.all_reduce(layers.sum_squares(y.reshape(b, s, h * ql)), mesh, MODEL) \
        if ql != pd else layers.sum_squares(y.reshape(b, s, d))
    scale = p["ln_x"]["scale"].reshape(h, pd)[:, q0:q0 + ql]
    yn = y.to(f32) * torch.rsqrt((ss / d).to(f32) + cfg.norm_eps)[..., None]
    yn = (yn * scale.to(f32)).to(x.dtype)
    if ql != pd:
        yn = coll.all_gather(yn, mesh, MODEL, dim=-1, replicated=True)
    return _out(p, yn.reshape(b, s, d), g, cfg, mesh), st


def _qkv_cat(parts, full: int, mesh):
    """Tensors of the rank's ``full / |model|`` columns each, whole: one
    all-gather of the three side by side (where they are split)."""
    m = mesh.size(MODEL)
    if m == 1 or parts[0].shape[-1] == full:
        return parts
    g = coll.all_gather(torch.cat(parts, -1), mesh, MODEL, dim=-1, replicated=True)
    w = parts[0].shape[-1]
    g = g.reshape(*g.shape[:-1], m, len(parts), w)
    return [g[..., i, :].reshape(*g.shape[:-3], m * w) for i in range(len(parts))]


def channel_mix(p: dict, x: torch.Tensor, cfg, mesh, last=None) -> torch.Tensor:
    """``rwkv6.channel_mix``; ``x`` replicated, ``last`` the carried token
    (whole) or None (no state)."""
    d, quant = x.shape[-1], cfg.quant
    xb = _varying(x, mesh)
    delta = rwkv6._shift(xb, last) - xb
    xk = xb + delta * _varying(p["mix_k"], mesh).to(x.dtype)
    xr = xb + delta * _varying(p["mix_r"], mesh).to(x.dtype)
    k = _column(p["wk"], xk, quant, mesh, cfg.d_ff)
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    kv = _row(p["wv"], k, quant, mesh)
    r = _gathered(_column(p["wr"], xr, quant, mesh, d), d, mesh, replicated=True)
    r = torch.sigmoid(r.to(torch.float32))
    return (r * kv.to(torch.float32)).to(x.dtype)


def block(blk: dict, h: torch.Tensor, cfg, mesh) -> torch.Tensor:
    h = h + time_mix(blk["time_mix"], layers.rmsnorm(blk["ln1"], h, cfg.norm_eps), cfg, mesh)
    return h + channel_mix(blk["channel_mix"], layers.rmsnorm(blk["ln2"], h, cfg.norm_eps), cfg,
                           mesh)


def loss_fn(params: dict, batch: dict, cfg, mesh, dev):
    """``rwkv6.loss_fn`` of this rank's rows (see ``sharded_lm.loss_fn``)."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    out = nll(*forward(params, tok[:, :-1], cfg, mesh), tok[:, 1:], mesh)
    return out, {"nll": out}


def forward(params: dict, tokens: torch.Tensor, cfg, mesh) -> tuple[torch.Tensor, bool]:
    """The stateless forward of this rank's rows: the head's logits and
    whether they are split by vocab."""
    x = embed(params["embed"], tokens, cfg, mesh)
    remat = layers.remat_on(cfg, params["blocks"])
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["blocks"], l)
        x = checkpoint(block, blk, x, cfg, mesh, use_reentrant=False) if remat else \
            block(blk, x, cfg, mesh)
    return logits(params, layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), cfg, mesh)


def serve_prefill(params: dict, tokens, extras: dict, cfg, mesh, dev):
    """``serve_step.make_prefill``'s step on this rank: the stateless
    forward (the rank's heads)."""
    return forward(params, torch.as_tensor(tokens, dtype=torch.int64, device=dev), cfg, mesh)


def serve_decode(params: dict, tokens, state: dict, index, extras: dict, cfg, mesh, dev):
    """``rwkv6.decode_step`` on this rank: ``state`` in the compute layout
    (``serve_step``): ``tm_s`` (L, B_local, H, P, P_l) the rank's value
    columns, ``tm_x`` and ``cm_x`` (L, B_local, D) whole.  Returns
    (logits, split, new state)."""
    del index
    x = embed(params["embed"], torch.as_tensor(tokens, dtype=torch.int64, device=dev), cfg, mesh)
    new = []
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["blocks"], l)
        xa = layers.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        tm, tm_s = time_mix_state(blk["time_mix"], xa, cfg, mesh, state["tm_s"][l],
                                  state["tm_x"][l])
        x = x + tm
        xc = layers.rmsnorm(blk["ln2"], x, cfg.norm_eps)
        x = x + channel_mix(blk["channel_mix"], xc, cfg, mesh, last=state["cm_x"][l])
        new.append((tm_s, xa[:, -1, :], xc[:, -1, :]))
    lg, split = logits(params, layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), cfg, mesh)
    tm_s, tm_x, cm_x = (torch.stack(t) for t in zip(*new))
    return lg, split, {"tm_s": tm_s, "tm_x": tm_x, "cm_x": cm_x}
