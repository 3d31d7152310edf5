"""Whisper's loss on one rank of a device mesh (the 'encdec' family), under
the reference's rules (``param_specs``): what GSPMD computes, with the
layouts and collectives written out on ``sharded_lm``'s pieces.

Attention and MLP are laid out as the dense family's.  The encoder runs
over the rank's rows of ``frames`` (split over the data axes as
``tokens``), its self-attention bidirectional and without RoPE; the
decoder's self-attention is causal, also without RoPE, and its
cross-attention takes the rank's heads of q from the decoder and of k and v
from the encoder's output (``sharded_lm.cross_attention``).  The learned
position tables ``enc_pos`` and ``dec_pos`` are split on d: the rows a step
adds are gathered (for replicated use: they join the residual).  The head
is tied to the embedding, vocab-parallel where the vocab splits over the
model axis and whole where it does not (51,866 rows split at 2, not at 4).
Every encoder and decoder block is rematerialised as the unsharded
forward's.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, whisper

from .sharded_lm import MODEL, _column, _gathered, _row, _slice, _varying, attention, \
    cached_attention, cross_attention, embed, linear, mlp, nll, tied_logits, w_dims


def enc_block(blk: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    x = x + attention(blk["attn"], layers.rmsnorm(blk["ln1"], x, cfg.norm_eps), cfg, mesh, None,
                      causal=False)
    return x + mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg, mesh)


def dec_block(blk: dict, x: torch.Tensor, memory: torch.Tensor, cfg, mesh) -> torch.Tensor:
    x = x + attention(blk["self_attn"], layers.rmsnorm(blk["ln1"], x, cfg.norm_eps), cfg, mesh,
                      None)
    x = x + cross_attention(blk["cross_attn"], layers.rmsnorm(blk["ln_x"], x, cfg.norm_eps),
                            memory, cfg, mesh)
    return x + mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg, mesh)


def _positions(table: torch.Tensor, n: int, cfg, mesh) -> torch.Tensor:
    """The first ``n`` rows of a position table, whole."""
    return _gathered(table[:n], cfg.d_model, mesh, replicated=True)


def encode(params: dict, frames: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``whisper.encode`` of this rank's frames."""
    x = frames.to(torch.bfloat16) + _positions(params["enc_pos"], frames.shape[1], cfg, mesh)[None]
    remat = layers.remat_on(cfg, params["enc_blocks"])
    for l in range(cfg.enc_layers or cfg.n_layers):
        blk = layers.layer_params(params["enc_blocks"], l)
        x = checkpoint(enc_block, blk, x, cfg, mesh, use_reentrant=False) if remat else \
            enc_block(blk, x, cfg, mesh)
    return layers.rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def decode(params: dict, tokens: torch.Tensor, memory: torch.Tensor, cfg, mesh):
    """``whisper.decode`` (no cache) of this rank's tokens: the tied head's
    logits and whether they are split by vocab."""
    x = embed(params["embed"], tokens, cfg, mesh)
    x = x + _positions(params["dec_pos"], x.shape[1], cfg, mesh)[None]
    remat = layers.remat_on(cfg, params["dec_blocks"])
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["dec_blocks"], l)
        x = checkpoint(dec_block, blk, x, memory, cfg, mesh, use_reentrant=False) if remat else \
            dec_block(blk, x, memory, cfg, mesh)
    x = layers.rmsnorm(params["dec_ln"], x, cfg.norm_eps)
    return tied_logits(params["embed"], x, cfg, mesh)


def loss_fn(params: dict, batch: dict, cfg, mesh, dev):
    """``whisper.loss_fn`` of this rank's rows (see ``sharded_lm.loss_fn``)."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    memory = encode(params, torch.as_tensor(batch["frames"], device=dev), cfg, mesh)
    out = nll(*decode(params, tok[:, :-1], memory, cfg, mesh), tok[:, 1:], mesh)
    return out, {"nll": out}


def cross_attention_kv(p: dict, x: torch.Tensor, ckv, cfg, mesh) -> torch.Tensor:
    """Cross-attention over a request's precomputed cross K/V ``ckv`` = (k,
    v), (B_local, T, KV, hd), whole on the rank (split over the data axes
    only): the rank's heads of q (column-parallel) against its heads' k and
    v, taken locally (no collective), ``wo`` row-parallel; where the heads
    do not divide ``model``, every head on every rank (the ``_attend``
    fallback) and ``wo``'s rows of the output."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    m, r = mesh.size(MODEL), mesh.index(MODEL)
    k, v = ckv
    q = _column(p["wq"], _varying(x, mesh), cfg.quant, mesh, h * hd)
    heads_ok = h % m == 0 and q.shape[-1] != h * hd
    if heads_ok:
        hl = h // m
        idx = (r * hl + torch.arange(hl, device=x.device)) // (h // kvh)
        if kvh % m == 0:
            k, v = _slice(k, 2, mesh), _slice(v, 2, mesh)
        else:  # the kv head of each of the rank's q heads
            k, v = k[:, :, idx], v[:, :, idx]
    else:
        q = _gathered(q, h * hd, mesh)
    out = layers.flash_attention(q.reshape(b, s, -1, hd), k, v, causal=False,
                                 chunk=cfg.attn_chunk).reshape(b, s, -1)
    if w_dims(p["wo"])[0] == h * hd:
        return linear(p["wo"], out, cfg.quant, mesh)
    if not heads_ok:
        out = _slice(out, 2, mesh)
    return _row(p["wo"], out, cfg.quant, mesh)


def precompute_cross_kv(params: dict, memory: torch.Tensor, cfg, mesh) -> dict:
    """``whisper.precompute_cross_kv`` of this rank's rows of ``memory``:
    every decoder layer's cross-attention k and v, every head on the rank
    (``wk``/``wv`` column-parallel, gathered over ``model``), as
    ``serve_decode``'s ``extras["cross_kv"]`` holds them."""
    b, t, _ = memory.shape
    kvd = cfg.n_kv_heads * cfg.hd
    mb = _varying(memory, mesh)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p = layers.layer_params(params["dec_blocks"], l)["cross_attn"]
        for name, into in (("wk", ks), ("wv", vs)):
            t_ = _gathered(_column(p[name], mb, cfg.quant, mesh, kvd), kvd, mesh, replicated=True)
            into.append(t_.reshape(b, t, cfg.n_kv_heads, cfg.hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def serve_prefill(params: dict, tokens, extras: dict, cfg, mesh, dev):
    """``serve_step.make_prefill``'s step on this rank: the encoder over the
    rank's rows of ``extras["frames"]``, then the decoder (no cache)."""
    memory = encode(params, torch.as_tensor(extras["frames"], device=dev), cfg, mesh)
    return decode(params, torch.as_tensor(tokens, dtype=torch.int64, device=dev), memory, cfg,
                  mesh)


def serve_decode(params: dict, tokens, cache: dict, index, extras: dict, cfg, mesh, dev):
    """``whisper.decode_step`` on this rank: the self-attention cache by the
    rank's slice of the sequence (written in place at the scalar
    ``index``), the cross-attention over ``extras["cross_kv"]`` where given
    (else the encoder ``memory``, projected again), both the rank's rows.
    Returns (logits, split, cache)."""
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    memory = extras.get("memory")
    if memory is None:
        raise ValueError("whisper.decode_step needs the encoder memory")
    memory = torch.as_tensor(memory, device=dev)
    cross_kv = extras.get("cross_kv")
    x = embed(params["embed"], tok, cfg, mesh)
    pos = whisper._dec_positions(params["dec_pos"], index, x.shape[1])
    x = x + _gathered(pos, cfg.d_model, mesh, replicated=True)[None]
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["dec_blocks"], l)
        h = layers.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + cached_attention(blk["self_attn"], h, cfg, mesh, None,
                                 (cache["k"][l], cache["v"][l]), index)
        h = layers.rmsnorm(blk["ln_x"], x, cfg.norm_eps)
        if cross_kv is None:
            x = x + cross_attention(blk["cross_attn"], h, memory, cfg, mesh)
        else:
            x = x + cross_attention_kv(blk["cross_attn"], h,
                                       (cross_kv["k"][l], cross_kv["v"][l]), cfg, mesh)
        x = x + mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg, mesh)
    x = layers.rmsnorm(params["dec_ln"], x, cfg.norm_eps)
    lg, split = tied_logits(params["embed"], x, cfg, mesh)
    return lg, split, cache
