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

from .sharded_lm import MODEL, _column, _gathered, _row, _slice, _varying, embed, logits, \
    nll, split_rmsnorm


def time_mix(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``rwkv6.time_mix`` (no state) on this rank's heads; ``x`` replicated."""
    h, pd = rwkv6.dims(cfg)
    b, s, d = x.shape
    m, quant, lr = mesh.size(MODEL), cfg.quant, rwkv6.LORA_R
    xb = _varying(x, mesh)
    delta = rwkv6._shift(xb) - xb
    lora_a = {"w": _gathered(p["mix_lora_a"]["w"], 5 * lr, mesh)}
    lora = torch.tanh(rwkv6.lora_linear(lora_a, xb).reshape(b, s, 5, lr))
    dyn = layers.einsum_exact("bsfr,frd->bsfd", lora, _varying(p["mix_lora_b"], mesh),
                              dtype=x.dtype)
    mix = _gathered(p["mix_base"], d, mesh).to(x.dtype)[None, None] + dyn
    xr, xk, xv, xw, xg = [xb + delta * mix[:, :, i, :] for i in range(5)]
    r = _column(p["wr"], xr, quant, mesh, d)
    k = _column(p["wk"], xk, quant, mesh, d)
    v = _column(p["wv"], xv, quant, mesh, d)
    g = F.silu(_column(p["wg"], xg, quant, mesh, d).to(torch.float32))
    wl = torch.tanh(rwkv6.lora_linear({"w": _gathered(p["w_lora_a"]["w"], lr, mesh)}, xw))
    wd = rwkv6.lora_linear({"w": _gathered(p["w_lora_b"], d, mesh)}, wl)
    logw = _varying(p["w_base"], mesh)[None, None, :] + wd.to(torch.float32)
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


def channel_mix(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``rwkv6.channel_mix`` (no state); ``x`` replicated."""
    d, quant = x.shape[-1], cfg.quant
    xb = _varying(x, mesh)
    delta = rwkv6._shift(xb) - xb
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
    x = embed(params["embed"], tok[:, :-1], cfg, mesh)
    remat = layers.remat_on(cfg, params["blocks"])
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["blocks"], l)
        x = checkpoint(block, blk, x, cfg, mesh, use_reentrant=False) if remat else \
            block(blk, x, cfg, mesh)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    out = nll(*logits(params, x, cfg, mesh), tok[:, 1:], mesh)
    return out, {"nll": out}
