"""Zamba2's loss on one rank of a device mesh (the 'hybrid' family), with
the sharded Mamba2 block, under the reference's rules (``param_specs``):
what GSPMD computes, with the layouts and collectives written out on
``sharded_lm``'s pieces.

Mamba2 block: ``ROW_PARALLEL_NAMES`` holds ``proj`` and the rule tests the
path's ``proj/w`` suffix, so every in-projection (``z_proj``, ``xbc_proj``,
``dt_proj``) is row-parallel, as ``out_proj`` is: each contracts the rank's
slice of d_model and ends in a sum all-reduce (``sharded_lm._row``: global
quantization maxes, the int32 partials summed), so z, xBC and dt come out
whole on every rank.  ``conv_w`` is split on its channels at a boundary
that is neither the x/B/C split nor a head's: it is gathered, and each rank
takes the channels it convolves, its heads' x and the whole B and C.  The
SSD runs the rank's heads (S a multiple of ``mamba2.CHUNK``); the gated
``norm`` over all of d_inner is ``sharded_lm.split_rmsnorm``; then
``out_proj`` row-parallel.  The whole outputs of the in-projections are
marked for varying use before each rank takes its part, so their gradients
are summed over ``model``.

The shared block runs on [x ; emb] (2 x d_model wide): attention over the
rank's heads (``sharded_lm.attention``), then ``proj`` row-parallel on the
rank's slice of the attention's output.  Groups, then the tail, as the
unsharded forward; each Mamba2 layer rematerialised as it is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, mamba2, zamba2

from . import collectives as coll
from .sharded_lm import MODEL, _gathered, _row, _slice, _varying, attention, cached_attention, \
    embed, logits, nll, split_rmsnorm, w_dims

F32 = torch.float32


def mamba_forward(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``mamba2.mamba_forward`` (no state) on this rank's heads; ``x``
    replicated."""
    d_inner, h, pd, n = mamba2.dims(cfg)
    m, quant = mesh.size(MODEL), cfg.quant
    if h % m or w_dims(p["out_proj"])[0] != d_inner // m:
        raise NotImplementedError(f"Mamba2 with {h} heads and out_proj "
                                  f"{w_dims(p['out_proj'])} over 'model' ({m})")
    bsz, s, _ = x.shape
    xs_in = _slice(_varying(x, mesh), 2, mesh)  # the K slice of the row-parallel in-projections
    z = _row(p["z_proj"], xs_in, quant, mesh)
    xbc = _row(p["xbc_proj"], xs_in, quant, mesh)
    dt = _row(p["dt_proj"], xs_in, quant, mesh)
    hl, dl = h // m, d_inner // m
    heads = slice(mesh.index(MODEL) * hl, (mesh.index(MODEL) + 1) * hl)
    chans = slice(heads.start * pd, heads.stop * pd)  # the rank's heads' x channels

    def mine(t):  # the rank's x channels, the whole B and C
        return torch.cat([t[..., chans], t[..., d_inner:]], dim=-1)

    conv_dim = d_inner + 2 * n
    conv = {"conv_w": mine(_gathered(p["conv_w"], conv_dim, mesh)),
            "conv_b": mine(_varying(p["conv_b"], mesh))}
    xbc, _ = mamba2._short_conv(conv, mine(_varying(xbc, mesh)))
    xs, bmat, cmat = torch.split(xbc, [dl, n, n], dim=-1)
    xs = xs.reshape(bsz, s, hl, pd)
    dt = _varying(dt, mesh)[..., heads]
    dt = mamba2._softplus(dt.to(F32) + _varying(p["dt_bias"], mesh)[heads])
    a = torch.exp(_varying(p["a_log"], mesh)[heads])
    y = mamba2._ssd_chunked(xs, dt, a, bmat, cmat)
    y = y.to(x.dtype) + xs * _varying(p["d_skip"], mesh)[heads].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, dl)
    z = _varying(z, mesh)[..., chans]
    y = split_rmsnorm(p["norm"], y * F.silu(z.to(F32)).to(x.dtype), cfg.norm_eps, mesh)
    return _row(p["out_proj"], y, quant, mesh)


def _mamba_layer(blk: dict, h: torch.Tensor, cfg, mesh) -> torch.Tensor:
    return h + mamba_forward(blk["mamba"], layers.rmsnorm(blk["ln"], h, cfg.norm_eps), cfg, mesh)


def _mamba_group(h: torch.Tensor, gp: dict, cfg, mesh) -> torch.Tensor:
    remat = layers.remat_on(cfg, gp)
    for i in range(gp["ln"]["scale"].shape[0]):
        blk = layers.layer_params(gp, i)
        h = checkpoint(_mamba_layer, blk, h, cfg, mesh, use_reentrant=False) if remat else \
            _mamba_layer(blk, h, cfg, mesh)
    return h


def shared_attn(p: dict, x: torch.Tensor, emb: torch.Tensor, cfg, mesh, positions
                ) -> torch.Tensor:
    """``zamba2._shared_attn`` (no cache): attention over the rank's heads
    of the 2 x d_model block, then ``proj`` row-parallel."""
    scfg = zamba2._shared_cfg(cfg)
    cat = layers.rmsnorm(p["ln"], torch.cat([x, emb], dim=-1), cfg.norm_eps)
    a = attention(p["attn"], cat, scfg, mesh, positions)
    return x + _row(p["proj"], _slice(_varying(a, mesh), 2, mesh), cfg.quant, mesh)


def forward(params: dict, tokens: torch.Tensor, cfg, mesh) -> tuple[torch.Tensor, bool]:
    """The stateless forward of this rank's rows: the head's logits and
    whether they are split by vocab."""
    _, n_groups, tail = zamba2._group_split(cfg)
    emb = embed(params["embed"], tokens, cfg, mesh)
    positions = torch.arange(emb.shape[1], device=emb.device)[None, :]
    x = emb
    for gi in range(n_groups):
        x = _mamba_group(x, layers.layer_params(params["groups"], gi), cfg, mesh)
        x = shared_attn(params["shared"], x, emb, cfg, mesh, positions)
    if tail:
        x = _mamba_group(x, params["tail"], cfg, mesh)
    return logits(params, layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), cfg, mesh)


def loss_fn(params: dict, batch: dict, cfg, mesh, dev):
    """``zamba2.loss_fn`` of this rank's rows (see ``sharded_lm.loss_fn``)."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    out = nll(*forward(params, tok[:, :-1], cfg, mesh), tok[:, 1:], mesh)
    return out, {"nll": out}


def mamba_step(p: dict, x: torch.Tensor, cfg, mesh, conv: torch.Tensor, ssm: torch.Tensor):
    """``mamba2.mamba_forward`` of one token with a state, in the decode
    state's layout: ``conv`` (B, W-1, C) whole (the stored slice of
    ``conv_dim`` is gathered for the step: the split crosses the x/B/C
    boundary), ``ssm`` (B, H, N, P_l) the rank's slice of the head dim
    ``P`` (the reference's ``cache_shardings``).  The in-projections are
    row-parallel (whole outputs), the short conv runs on every channel,
    the SSD step on the rank's columns of every head, the gated norm's
    float64 sum of squares is all-reduced over ``model`` and ``y`` gathered
    (O(B·d_inner)) for ``out_proj``.  Returns (out, conv, ssm)."""
    d_inner, h, pd, n = mamba2.dims(cfg)
    bsz, s, _ = x.shape
    if s != 1:
        raise ValueError(f"Mamba2 decode takes one token per call, got {s}")
    quant = cfg.quant
    xs_in = _slice(_varying(x, mesh), 2, mesh)
    z = _row(p["z_proj"], xs_in, quant, mesh)
    xbc = _row(p["xbc_proj"], xs_in, quant, mesh)
    dt = _row(p["dt_proj"], xs_in, quant, mesh)
    conv_dim = d_inner + 2 * n
    cw = {"conv_w": _gathered(p["conv_w"], conv_dim, mesh), "conv_b": p["conv_b"]}
    xbc, conv = mamba2._short_conv(cw, xbc, conv)
    xs, bmat, cmat = torch.split(xbc, [d_inner, n, n], dim=-1)
    ql = ssm.shape[-1]
    q0 = mesh.index(MODEL) * ql if ql != pd else 0
    xs = xs.reshape(bsz, s, h, pd)[..., q0:q0 + ql]
    dt = mamba2._softplus(dt.to(F32) + p["dt_bias"])
    a = torch.exp(p["a_log"])
    y, ssm = mamba2.ssd_step(ssm, xs[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0])
    y = y[:, None].to(x.dtype) + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    zg = F.silu(z.to(F32)).to(x.dtype).reshape(bsz, s, h, pd)[..., q0:q0 + ql]
    y = y * zg  # (B, 1, H, P_l)
    if ql != pd:
        ss = coll.all_reduce(layers.sum_squares(y.reshape(bsz, s, h * ql)), mesh, MODEL)
    else:
        ss = layers.sum_squares(y.reshape(bsz, s, d_inner))
    scale = p["norm"]["scale"].reshape(h, pd)[:, q0:q0 + ql]
    yn = y.to(F32) * torch.rsqrt((ss / d_inner).to(F32) + cfg.norm_eps)[..., None]
    yn = (yn * scale.to(F32)).to(x.dtype)
    if ql != pd:
        yn = coll.all_gather(yn, mesh, MODEL, dim=-1, replicated=True)
    yn = yn.reshape(bsz, s, d_inner)
    return _row(p["out_proj"], _slice(yn, 2, mesh), quant, mesh), conv, ssm


def _mamba_group_step(h: torch.Tensor, gp: dict, gstate: dict, cfg, mesh):
    new = []
    for i in range(gp["ln"]["scale"].shape[0]):
        blk = layers.layer_params(gp, i)
        out, conv, ssm = mamba_step(blk["mamba"], layers.rmsnorm(blk["ln"], h, cfg.norm_eps),
                                    cfg, mesh, gstate["conv"][i], gstate["ssm"][i])
        h = h + out
        new.append({"conv": conv, "ssm": ssm})
    return h, layers.stack_trees(new)


def serve_prefill(params: dict, tokens, extras: dict, cfg, mesh, dev):
    """``serve_step.make_prefill``'s step on this rank: the stateless
    forward (S a multiple of ``mamba2.CHUNK``)."""
    return forward(params, torch.as_tensor(tokens, dtype=torch.int64, device=dev), cfg, mesh)


def serve_decode(params: dict, tokens, state: dict, index, extras: dict, cfg, mesh, dev):
    """``zamba2.decode_step`` on this rank (one token at the scalar
    ``index``): ``state`` in the compute layout (``serve_step``): each
    Mamba2 layer's conv window whole and SSM state by the rank's slice of
    ``P``, the shared block's caches by the rank's slice of the sequence
    (written in place).  Returns (logits, split, new state)."""
    _, n_groups, tail = zamba2._group_split(cfg)
    scfg = zamba2._shared_cfg(cfg)
    emb = embed(params["embed"], torch.as_tensor(tokens, dtype=torch.int64, device=dev), cfg, mesh)
    base = torch.as_tensor(index, device=dev)
    if base.ndim:
        raise ValueError("zamba2 decodes at one scalar cache index for every row")
    positions = base + torch.arange(emb.shape[1], device=dev)[None, :]
    sp = params["shared"]
    x, groups = emb, []
    for gi in range(n_groups):
        x, gnew = _mamba_group_step(x, layers.layer_params(params["groups"], gi),
                                    layers.layer_params(state["groups"], gi), cfg, mesh)
        groups.append(gnew)
        cat = layers.rmsnorm(sp["ln"], torch.cat([x, emb], dim=-1), cfg.norm_eps)
        a = cached_attention(sp["attn"], cat, scfg, mesh, positions,
                             (state["attn_k"][gi], state["attn_v"][gi]), base)
        x = x + _row(sp["proj"], _slice(_varying(a, mesh), 2, mesh), cfg.quant, mesh)
    out = {"groups": layers.stack_trees(groups), "attn_k": state["attn_k"],
           "attn_v": state["attn_v"]}
    if tail:
        x, out["tail"] = _mamba_group_step(x, params["tail"], state["tail"], cfg, mesh)
    lg, split = logits(params, layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), cfg, mesh)
    return lg, split, out
