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

from .sharded_lm import MODEL, _gathered, _row, _slice, _varying, attention, embed, logits, \
    nll, split_rmsnorm

F32 = torch.float32


def mamba_forward(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``mamba2.mamba_forward`` (no state) on this rank's heads; ``x``
    replicated."""
    d_inner, h, pd, n = mamba2.dims(cfg)
    m, quant = mesh.size(MODEL), cfg.quant
    if h % m or p["out_proj"]["w"].shape[0] != d_inner // m:
        raise NotImplementedError(f"Mamba2 with {h} heads and out_proj "
                                  f"{tuple(p['out_proj']['w'].shape)} over 'model' ({m})")
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


def loss_fn(params: dict, batch: dict, cfg, mesh, dev):
    """``zamba2.loss_fn`` of this rank's rows (see ``sharded_lm.loss_fn``)."""
    _, n_groups, tail = zamba2._group_split(cfg)
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    emb = embed(params["embed"], tok[:, :-1], cfg, mesh)
    positions = torch.arange(emb.shape[1], device=dev)[None, :]
    x = emb
    for gi in range(n_groups):
        x = _mamba_group(x, layers.layer_params(params["groups"], gi), cfg, mesh)
        x = shared_attn(params["shared"], x, emb, cfg, mesh, positions)
    if tail:
        x = _mamba_group(x, params["tail"], cfg, mesh)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    out = nll(*logits(params, x, cfg, mesh), tok[:, 1:], mesh)
    return out, {"nll": out}
