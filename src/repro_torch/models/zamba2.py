"""Zamba2, the 'hybrid' family: a Mamba2 backbone with one weight-shared
attention block.

The shared attention block runs after every ``attn_every`` Mamba2 layers on
[hidden ; embedding] (2 * d_model wide), always with the same weights: the
groups are iterated in Python, the block between them.  Zamba2-7B's 81
layers are 13 groups of 6 and a tail of 3.

The parameter tree is the reference's: the Mamba2 layers stacked twice,
``(n_groups, g, ...)`` under ``params["groups"]``, the tail ``(tail,
...)`` under ``params["tail"]``.  Decode carries each layer's conv window
and SSM state, and one KV cache per group for the shared block, written at
one scalar index for every row (the family has no per-row positions).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quant
from repro_torch.device import resolve_device

from . import layers, mamba2

params_to = layers.params_to


def _group_split(cfg):
    g = cfg.attn_every or 6
    n_groups = cfg.n_layers // g
    tail = cfg.n_layers - n_groups * g
    return g, n_groups, tail


def _shared_cfg(cfg):
    """The shared block's config: [hidden ; embedding] is 2 * d_model wide."""
    return cfg.replace(d_model=2 * cfg.d_model)


# ------------------------------------------------------------------ params


def init_params(seed: int, cfg, *, device=None, int8_min_dim: int | None = None) -> dict:
    """Seeded random parameters drawn on ``device`` (the reference's
    ``jax.random`` draws cannot be reproduced: carry those over with
    :func:`params_from_jax`).  ``int8_min_dim``: quantize each layer with
    ``quant.quantize_params_int8(min_dim=int8_min_dim)`` as soon as it is
    drawn, so no float copy of the whole model is ever held."""
    dev = resolve_device(device)
    g = layers.generator(seed, dev)
    gs, n_groups, tail = _group_split(cfg)

    def made(tree):
        if int8_min_dim is None:
            return tree
        return quant.quantize_params_int8(tree, min_dim=int8_min_dim)

    def mamba_layers(n):
        return layers.stack_trees([
            made({"ln": layers.init_norm(cfg.d_model, device=dev),
                  "mamba": mamba2.init_mamba_block(g, cfg, device=dev)}) for _ in range(n)])

    d = cfg.d_model
    p = {"embed": layers.init_embedding(g, cfg.vocab, d, device=dev)}
    p["groups"] = layers.tree_map(lambda t: t.reshape((n_groups, gs) + t.shape[1:]),
                                  mamba_layers(n_groups * gs))
    p["shared"] = made({
        "ln": layers.init_norm(2 * d, device=dev),
        "attn": layers.init_attention(g, _shared_cfg(cfg), device=dev),
        "proj": layers.init_linear(g, 2 * d, d, device=dev),
    })
    p["ln_f"] = layers.init_norm(d, device=dev)
    p["head"] = made(layers.init_linear(g, d, cfg.vocab, device=dev))
    if tail:
        p["tail"] = mamba_layers(tail)
    return p


def params_from_jax(tree, *, device=None) -> dict:
    """The reference's parameter tree (leaves as numpy arrays, bf16 leaves as
    numpy bf16) on ``device``, each leaf keeping its dtype."""
    return layers.params_from_numpy(tree, device=resolve_device(device))


# ----------------------------------------------------------------- forward


def _shared_attn(p, x, emb, cfg, scfg, *, positions, cache=None, cache_index=None):
    """The weight-shared attention block on [x ; emb]; ``scfg`` is
    :func:`_shared_cfg` of ``cfg``.  The cache is written in place."""
    cat = torch.cat([x, emb], dim=-1)
    h, new_cache = layers.attention(
        p["attn"], layers.rmsnorm(p["ln"], cat, cfg.norm_eps), scfg,
        positions=positions, cache=cache, cache_index=cache_index,
    )
    return x + layers.linear(p["proj"], h, cfg.quant), new_cache


def _mamba_layer(blk, h, cfg):
    out, _ = mamba2.mamba_forward(blk["mamba"], layers.rmsnorm(blk["ln"], h, cfg.norm_eps), cfg)
    return h + out


def _mamba_group(h, gp, cfg, gstate=None):
    """The Mamba2 layers of one group (``gp`` stacked ``(g, ...)``) on the
    residual stream; with ``gstate`` also their new states, stacked.
    Without state each layer is rematerialised where a gradient is taken
    under ``cfg.remat == 'full'`` (the reference's ``jax.checkpoint`` of
    its inner scan body; the shared block is not)."""
    remat = gstate is None and layers.remat_on(cfg, gp)
    new = []
    for i in range(gp["ln"]["scale"].shape[0]):
        blk = layers.layer_params(gp, i)
        if remat:
            h = checkpoint(_mamba_layer, blk, h, cfg, use_reentrant=False)
            continue
        st = None if gstate is None else layers.layer_params(gstate, i)
        out, ns = mamba2.mamba_forward(blk["mamba"], layers.rmsnorm(blk["ln"], h, cfg.norm_eps),
                                       cfg, state=st)
        h = h + out
        new.append(ns)
    return h, None if gstate is None else layers.stack_trees(new)


def forward(params, tokens, cfg, *, state=None, cache_index=None, device=None, **_):
    """tokens: (B, S) int -> logits (B, S, vocab) on ``device`` (the CUDA
    card unless ``device='cpu'``).  Without state every S must be a multiple
    of ``mamba2.CHUNK``.

    With ``state`` (decode; see :func:`init_state`) and a scalar
    ``cache_index``: returns (logits, new_state).  The Mamba2 states of the
    new state are new tensors; the shared block's KV caches are the ones
    given, written in place at ``cache_index``.
    """
    dev = resolve_device(device)
    params = params_to(params, dev)
    gs, n_groups, tail = _group_split(cfg)
    scfg = _shared_cfg(cfg)
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    emb = layers.embed(params["embed"], tokens)
    x = emb
    base = torch.as_tensor(0 if cache_index is None else cache_index, device=dev)
    if base.ndim:
        raise ValueError("zamba2 decodes at one scalar cache index for every row")
    positions = base + torch.arange(x.shape[1], device=dev)[None, :]

    new_groups = []
    for gi in range(n_groups):
        gp = layers.layer_params(params["groups"], gi)
        gstate = None if state is None else layers.layer_params(state["groups"], gi)
        x, gnew = _mamba_group(x, gp, cfg, gstate)
        cache = None if state is None else (state["attn_k"][gi], state["attn_v"][gi])
        x, _ = _shared_attn(params["shared"], x, emb, cfg, scfg, positions=positions,
                            cache=cache, cache_index=None if state is None else base)
        new_groups.append(gnew)

    new_tail = None
    if tail:
        x, new_tail = _mamba_group(x, params["tail"], cfg,
                                   None if state is None else state["tail"])

    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = layers.linear(params["head"], x, cfg.quant)
    if state is None:
        return logits
    out = {"groups": layers.stack_trees(new_groups), "attn_k": state["attn_k"],
           "attn_v": state["attn_v"]}
    if tail:
        out["tail"] = new_tail
    return logits, out


def init_state(cfg, batch: int, max_seq: int, *, device=None) -> dict:
    """Zero decode state: every Mamba2 layer's conv window and SSM state, and
    the shared block's KV cache per group, bf16, of head dim ``2 * d_model
    // n_heads`` (the block attends over [x ; emb])."""
    dev = resolve_device(device)
    gs, n_groups, tail = _group_split(cfg)
    shared_hd = 2 * cfg.d_model // cfg.n_heads
    kv_shape = (n_groups, batch, max_seq, cfg.n_kv_heads, shared_hd)
    st = {
        "groups": mamba2.init_state(cfg, batch, lead=(n_groups, gs), device=dev),
        "attn_k": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
        "attn_v": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
    }
    if tail:
        st["tail"] = mamba2.init_state(cfg, batch, lead=(tail,), device=dev)
    return st


def loss_fn(params, batch, cfg, *, device=None):
    """Next-token cross-entropy; batch = {"tokens": (B, S+1)}.  Returns (loss,
    metrics); differentiable in ``params``."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    nll = layers.next_token_nll(forward(params, tok[:, :-1], cfg, device=device), tok[:, 1:])
    return nll, {"nll": nll}


def decode_step(params, tokens, state, cache_index, cfg, *, device=None, **_):
    """One serving step: tokens (B, 1) at the scalar ``cache_index``."""
    return forward(params, tokens, cfg, state=state, cache_index=cache_index, device=device)
