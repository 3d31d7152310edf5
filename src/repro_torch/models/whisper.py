"""Whisper (encoder-decoder audio), the 'encdec' family: the transformer
backbone only.  The conv/mel frontend is a stub: callers hand in
precomputed frame embeddings ``(B, enc_seq, d_model)``.  32 encoder and 32
decoder layers at full size, learned absolute positions (no RoPE), GELU
MLPs, the output projection tied to the token embedding.

The parameter tree is the reference's: every encoder leaf stacked
``(L_enc, ...)`` under ``params["enc_blocks"]``, every decoder leaf
``(L, ...)`` under ``params["dec_blocks"]``.  The reference scans over the
stacks; here a Python loop takes layer ``l``'s views, each encoder and
(cacheless) decoder block rematerialised where a gradient is taken under
``cfg.remat == 'full'``, as the reference's ``jax.checkpoint`` of its scan
bodies.  The decoder's KV cache is updated in place, as in
:mod:`.transformer`.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quant
from repro_torch.device import resolve_device

from . import layers

params_to = layers.params_to


# ------------------------------------------------------------------ params


def init_cross_attention(g: torch.Generator, cfg, *, device) -> dict:
    return layers.init_attention(g, cfg, device=device)


def init_enc_block(g: torch.Generator, cfg, *, device) -> dict:
    return {
        "ln1": layers.init_norm(cfg.d_model, device=device),
        "attn": layers.init_attention(g, cfg, device=device),
        "ln2": layers.init_norm(cfg.d_model, device=device),
        "mlp": layers.init_mlp(g, cfg, device=device),
    }


def init_dec_block(g: torch.Generator, cfg, *, device) -> dict:
    return {
        "ln1": layers.init_norm(cfg.d_model, device=device),
        "self_attn": layers.init_attention(g, cfg, device=device),
        "ln_x": layers.init_norm(cfg.d_model, device=device),
        "cross_attn": init_cross_attention(g, cfg, device=device),
        "ln2": layers.init_norm(cfg.d_model, device=device),
        "mlp": layers.init_mlp(g, cfg, device=device),
    }


def _positions(g: torch.Generator, n: int, d: int, *, device) -> torch.Tensor:
    t = torch.randn((n, d), generator=g, dtype=torch.float32, device=device)
    return (t * 0.01).to(torch.bfloat16)


def init_params(seed: int, cfg, *, device=None, int8_min_dim: int | None = None,
                max_dec_pos: int = 4096) -> dict:
    """Seeded random parameters drawn on ``device`` (the reference's
    ``jax.random`` draws cannot be reproduced: carry those over with
    :func:`params_from_jax`).  ``int8_min_dim``: quantize each layer with
    ``quant.quantize_params_int8(min_dim=int8_min_dim)`` as soon as it is
    drawn, so no float copy of the whole model is ever held."""
    dev = resolve_device(device)
    g = layers.generator(seed, dev)

    def made(tree):
        if int8_min_dim is None:
            return tree
        return quant.quantize_params_int8(tree, min_dim=int8_min_dim)

    return {
        "enc_pos": _positions(g, cfg.enc_seq, cfg.d_model, device=dev),
        "enc_blocks": layers.stack_trees([made(init_enc_block(g, cfg, device=dev))
                                          for _ in range(cfg.enc_layers or cfg.n_layers)]),
        "enc_ln": layers.init_norm(cfg.d_model, device=dev),
        "embed": layers.init_embedding(g, cfg.vocab, cfg.d_model, device=dev),
        "dec_pos": _positions(g, max_dec_pos, cfg.d_model, device=dev),
        "dec_blocks": layers.stack_trees([made(init_dec_block(g, cfg, device=dev))
                                          for _ in range(cfg.n_layers)]),
        "dec_ln": layers.init_norm(cfg.d_model, device=dev),
    }


def params_from_jax(tree, *, device=None) -> dict:
    """The reference's parameter tree (leaves as numpy arrays, bf16 leaves as
    numpy bf16) on ``device``, each leaf keeping its dtype."""
    return layers.params_from_numpy(tree, device=resolve_device(device))


# ----------------------------------------------------------------- encoder


def encode(params, frames, cfg, *, device=None) -> torch.Tensor:
    """frames: (B, T_enc, D) stub embeddings -> encoder memory (B, T_enc, D),
    bf16, on ``device`` (the CUDA card unless ``device='cpu'``)."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    frames = torch.as_tensor(frames, device=dev)
    x = frames.to(torch.bfloat16) + params["enc_pos"][None, : frames.shape[1]]
    remat = layers.remat_on(cfg, params["enc_blocks"])
    for l in range(cfg.enc_layers or cfg.n_layers):
        blk = layers.layer_params(params["enc_blocks"], l)
        x = checkpoint(enc_block, blk, x, cfg, use_reentrant=False) if remat else \
            enc_block(blk, x, cfg)
    return layers.rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def enc_block(blk, x, cfg) -> torch.Tensor:
    """One encoder block: bidirectional self-attention (no positions: they
    were added to the frames), then the MLP."""
    a, _ = layers.attention(blk["attn"], layers.rmsnorm(blk["ln1"], x, cfg.norm_eps), cfg,
                            positions=None, causal=False)
    x = x + a
    return x + layers.mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg)


def _project_kv(p, memory, cfg):
    """Cross-attention keys and values of the encoder memory:
    (B, T_enc, KV, hd) each."""
    b, t, _ = memory.shape
    k = layers.linear(p["wk"], memory, cfg.quant).reshape(b, t, cfg.n_kv_heads, cfg.hd)
    v = layers.linear(p["wv"], memory, cfg.quant).reshape(b, t, cfg.n_kv_heads, cfg.hd)
    return k, v


def _cross_attend(p, x, memory, cfg, *, cross_kv=None):
    """Cross attention: queries from the decoder's ``x``, keys and values
    from the encoder ``memory`` — or ``cross_kv`` = (k, v), projected once
    per request by :func:`precompute_cross_kv` (re-projecting the memory
    costs 2 * T_enc * d^2 multiply-adds per layer and call)."""
    b, s, _ = x.shape
    q = layers.linear(p["wq"], x, cfg.quant).reshape(b, s, cfg.n_heads, cfg.hd)
    k, v = cross_kv if cross_kv is not None else _project_kv(p, memory, cfg)
    out = layers.flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return layers.linear(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.hd), cfg.quant)


def precompute_cross_kv(params, memory, cfg, *, device=None) -> dict:
    """The encoder memory through every decoder layer's cross-attention k/v,
    once per request: {"k", "v"}, each (L, B, T_enc, KV, hd)."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    memory = torch.as_tensor(memory, device=dev)
    kv = [_project_kv(layers.layer_params(params["dec_blocks"], l)["cross_attn"], memory, cfg)
          for l in range(cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}


# ----------------------------------------------------------------- decoder


def _dec_positions(table: torch.Tensor, base, s: int) -> torch.Tensor:
    """``s`` learned positions from ``base``.  The start is clamped to
    ``[0, max_dec_pos - s]``, as the reference's ``dynamic_slice_in_dim``
    clamps it: past the end, the last ``s`` positions.  A ``meta`` index
    (the dry run) has no value: the first ``s``, of the same shape."""
    if isinstance(base, torch.Tensor) and base.is_meta:
        return table[:s]
    start = max(0, min(int(base), table.shape[0] - s))
    return table[start:start + s]


def decode(params, tokens, memory, cfg, *, cache=None, cache_index=None, cross_kv=None,
           device=None):
    """tokens: (B, S) int -> logits (B, S, vocab) over the encoder
    ``memory``.  With ``cache`` (``{"k", "v"}``: (L, B, S_max, KV, hd),
    updated in place; ``cache_index`` one scalar for every row): returns
    (logits, cache), and the cross-attention reads ``cross_kv`` where it is
    given, else projects ``memory`` again."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    if memory is not None:
        memory = torch.as_tensor(memory, device=dev)
    x = layers.embed(params["embed"], tokens)
    base = 0 if cache_index is None else cache_index
    x = x + _dec_positions(params["dec_pos"], base, x.shape[1])[None]
    remat = cache is None and layers.remat_on(cfg, params["dec_blocks"])
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["dec_blocks"], l)
        if remat:
            x = checkpoint(dec_block, blk, x, memory, cfg, use_reentrant=False)
        elif cache is None:  # no cache: the memory is projected again
            x = dec_block(blk, x, memory, cfg)
        else:
            ckv = None if cross_kv is None else (cross_kv["k"][l], cross_kv["v"][l])
            x = dec_block(blk, x, memory, cfg, cache=(cache["k"][l], cache["v"][l]),
                          cache_index=base, cross_kv=ckv)
    x = layers.rmsnorm(params["dec_ln"], x, cfg.norm_eps)
    logits = layers.unembed(params["embed"], x)  # the output projection is tied
    return (logits, cache) if cache is not None else logits


def dec_block(blk, x, memory, cfg, *, cache=None, cache_index=None, cross_kv=None):
    """One decoder block: causal self-attention (over ``cache`` = (k, v) of
    this layer, written in place at ``cache_index``, where given), cross
    attention over the encoder memory (or this layer's ``cross_kv``), then
    the MLP."""
    a, _ = layers.attention(blk["self_attn"], layers.rmsnorm(blk["ln1"], x, cfg.norm_eps), cfg,
                            positions=None, cache=cache, cache_index=cache_index)
    x = x + a
    x = x + _cross_attend(blk["cross_attn"], layers.rmsnorm(blk["ln_x"], x, cfg.norm_eps),
                          memory, cfg, cross_kv=cross_kv)
    return x + layers.mlp(blk["mlp"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg)


def forward(params, batch, cfg, *, device=None):
    """Training forward: batch = {"frames": (B, T, D), "tokens": (B, S)}."""
    if not isinstance(batch, dict):
        raise ValueError("whisper.forward expects a batch dict")
    memory = encode(params, batch["frames"], cfg, device=device)
    return decode(params, batch["tokens"], memory, cfg, device=device)


def loss_fn(params, batch, cfg, *, device=None):
    """Next-token cross-entropy; batch = {"frames": (B, T, D), "tokens": (B,
    S+1)}.  Returns (loss, metrics); differentiable in ``params``."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    memory = encode(params, batch["frames"], cfg, device=device)
    nll = layers.next_token_nll(decode(params, tok[:, :-1], memory, cfg, device=device),
                                tok[:, 1:])
    return nll, {"nll": nll}


def init_cache(cfg, batch: int, max_seq: int, *, dtype=torch.bfloat16, device=None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, tokens, cache, cache_index, cfg, *, memory=None, cross_kv=None,
                device=None, **_):
    """One serving step over the encoder ``memory`` (and, optionally, the
    per-layer cross K/V of :func:`precompute_cross_kv`), both computed once
    at request admission."""
    if memory is None:
        raise ValueError("whisper.decode_step needs the encoder memory")
    return decode(params, tokens, memory, cfg, cache=cache, cache_index=cache_index,
                  cross_kv=cross_kv, device=device)
