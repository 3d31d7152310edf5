"""Decoder-only transformer LM, the 'dense', 'moe' and 'vlm' families (vlm:
the dense LM behind a stub frontend's patch embeddings, prepended to the
token stream as ``prefix_embeds``).

The parameter tree is the reference's: every block leaf is stacked
``(L, ...)`` under ``params["blocks"]``.  The reference scans over that
stack; here a Python loop takes layer ``l``'s views ``leaf[l]``.  Under a
per-layer plane schedule each layer runs with its static budget
``PlaneSchedule.planes_for(l)``, so the MMA kernel runs its ``p{b}``
variant; the reference folds a traced budget into the data instead, which
the bit-mask identity makes bit-identical.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quant
from repro_torch.core.plane_schedule import PlaneSchedule
from repro_torch.device import resolve_device
from repro_torch.obs import timeline

from . import layers
from . import moe as moe_lib

def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"not a transformer LM family: {cfg.family!r}")


# ------------------------------------------------------------------ params

layer_params = layers.layer_params
params_to = layers.params_to


def init_block(g: torch.Generator, cfg, *, device, dense: bool = False) -> dict:
    """One block's weights; ``dense``: a leading dense layer of an MoE
    config (an MLP of width ``d_ff``)."""
    init_attn = layers.init_mla if cfg.kv_lora_rank else layers.init_attention
    p = {
        "ln1": layers.init_norm(cfg.d_model, device=device),
        "attn": init_attn(g, cfg, device=device),
        "ln2": layers.init_norm(cfg.d_model, device=device),
    }
    if cfg.moe.n_experts and not dense:
        p["moe"] = moe_lib.init_moe(g, cfg, device=device)
    else:
        p["mlp"] = layers.init_mlp(g, cfg, device=device)
    return p


def init_router_bias(cfg, *, device=None) -> torch.Tensor | None:
    """The held-expert layers' selection biases, zeros (MoE layers,
    experts) float32: training state outside the parameters
    (``train.train_step``); None where the config has none."""
    m = cfg.moe
    if not (m.held and m.bias_rate):
        return None
    return torch.zeros((cfg.n_layers - m.first_dense, m.n_experts), dtype=torch.float32,
                       device=resolve_device(device))


def init_params(seed: int, cfg, *, device=None, int8_min_dim: int | None = None) -> dict:
    """Seeded random parameters, drawn on ``device`` from a
    ``torch.Generator`` (the reference's ``jax.random`` draws cannot be
    reproduced — carry those over with :func:`params_from_jax`).

    ``int8_min_dim``: quantize each layer with
    ``quant.quantize_params_int8(min_dim=int8_min_dim)`` as soon as it is
    drawn, so no float copy of the whole model is ever held — the way to
    build a full-width serving model on the card.  MoE experts and the
    router stay bf16, as ``quantize_params_int8`` leaves them.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    g = layers.generator(seed, dev)

    def made(tree):
        if int8_min_dim is None:
            return tree
        return quant.quantize_params_int8(tree, min_dim=int8_min_dim)

    p = {"embed": layers.init_embedding(g, cfg.vocab, cfg.d_model, device=dev)}
    nd = cfg.moe.first_dense
    if nd:  # leading dense layers: a tree of their own beside the MoE stack
        p["dense_blocks"] = layers.stack_drawn(
            lambda: made(init_block(g, cfg, device=dev, dense=True)), nd)
    p["blocks"] = layers.stack_drawn(lambda: made(init_block(g, cfg, device=dev)),
                                     cfg.n_layers - nd)
    p["ln_f"] = layers.init_norm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        p["head"] = made(layers.init_linear(g, cfg.d_model, cfg.vocab, device=dev))
    return p


def params_from_jax(tree, *, device=None) -> dict:
    """Carry the reference's parameter tree (leaves as numpy arrays) into the
    port's: the same tree and shapes on ``device``.  Int8 leaves (``w_q``)
    and ``w_scale`` keep their type; every other leaf (the MoE subtree's
    raw expert arrays and router ``{"w"}`` too) is the reference's bf16,
    handed over as float32 (exact) or as numpy bf16, and becomes bf16 again
    here."""
    return layers.params_from_numpy(tree, device=resolve_device(device),
                                    float32_keys={"w_scale"})


# ----------------------------------------------------------------- forward


def _attend(p, x, cfg, *, positions, cache=None, cache_index=None):
    """The block's attention on ``rmsnorm(ln1, x)``: ``(out, new_cache)``."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if not cfg.kv_lora_rank:
        return layers.attention(p["attn"], h, cfg, positions=positions, cache=cache,
                                cache_index=cache_index)
    if cache is not None:
        raise NotImplementedError("latent attention has no KV cache in the port: "
                                  f"{cfg.name} trains, and is not served")
    return layers.mla_attention(p["attn"], h, cfg, positions=positions), None


def _block(p, x, cfg, *, positions, cache=None, cache_index=None):
    h, new_cache = _attend(p, x, cfg, positions=positions, cache=cache, cache_index=cache_index)
    x = x + h
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        ffn = moe_lib.moe_ffn_ep if cfg.moe.ep else moe_lib.moe_ffn
        h2 = ffn(p["moe"], h2, cfg)
    else:
        h2 = layers.mlp(p["mlp"], h2, cfg)
    return x + h2, new_cache


def _layer(blk, x, aux, cfg, positions, moe_aux: bool):
    """One layer of the cacheless forward: the MoE load-balance aux, taken on
    the block's input as the reference takes it, then the block."""
    if moe_aux:
        aux = aux + moe_lib.load_balance_loss(
            blk["moe"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps), cfg)
    x, _ = _block(blk, x, cfg, positions=positions)
    return x, aux


def _held_layer(blk, x, aux, cfg, positions, bias):
    """One held-expert MoE layer of the cacheless forward: attention, then
    ``moe.moe_held``, whose balance term adds to ``aux``.  Also returns the
    layer's assignments per expert."""
    x = x + _attend(blk, x, cfg, positions=positions)[0]
    y, bal, counts = moe_lib.moe_held(blk["moe"], layers.rmsnorm(blk["ln2"], x, cfg.norm_eps),
                                      cfg, bias)
    return x + y, aux + bal, counts


def _layer_cfgs(cfg) -> list:
    """Each layer's config: under a plane schedule, layer ``l`` carries its
    static budget as ``quant.planes`` (the head keeps the global one)."""
    if cfg.quant.mode != "mma_int8" or cfg.quant.plane_schedule is None:
        return [cfg] * cfg.n_layers
    ps = PlaneSchedule.from_list(cfg.quant.plane_schedule)
    return [
        cfg.replace(quant=dataclasses.replace(
            cfg.quant, planes=ps.planes_for(l), plane_schedule=None))
        for l in range(cfg.n_layers)
    ]


def forward(
    params: dict,
    tokens,
    cfg,
    *,
    prefix_embeds=None,
    cache: dict | None = None,
    cache_index=None,
    return_aux: bool = False,
    router_bias=None,
    expert_counts: list | None = None,
    device=None,
):
    """tokens: (B, S) int -> logits (B, P + S, vocab), on ``device`` (the
    CUDA card unless ``device='cpu'``).  ``prefix_embeds`` (B, P, D): the
    vlm stub frontend's patch embeddings, placed before the token
    embeddings; positions run over all P + S.

    With ``cache`` (decode / prefill into the cache): returns (logits,
    cache), the cache ``{"k": (L, B, S_max, KV, hd), "v": ...}`` updated in
    place.  ``cache_index`` is a scalar or a (B,) vector of per-row write
    positions.  ``return_aux`` (no cache): also the MoE load-balance loss
    summed over layers (zero for 'dense'), each layer's taken, as the
    reference takes it, on ``rmsnorm(ln2, h)`` of the block's input ``h``.

    Held-expert configs (``cfg.moe.held``): the leading dense layers
    (``params["dense_blocks"]``) run first; each MoE layer ``l`` selects
    with ``router_bias[l]`` (zeros if None), its balance term adds to the
    aux, and its assignments per expert are appended to ``expert_counts``
    if a list is given.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    params = params_to(params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    x = layers.embed(params["embed"], tokens)
    if prefix_embeds is not None:  # the vlm stub frontend
        prefix = torch.as_tensor(prefix_embeds, device=dev).to(x.dtype)
        x = torch.cat([prefix, x], dim=1)
    b, s, _ = x.shape
    base = torch.as_tensor(0 if cache_index is None else cache_index, device=dev)
    ar = torch.arange(s, device=dev)
    if base.ndim > 0:  # per-row cache positions (slot-isolated decode)
        positions = base.reshape(-1, 1) + ar[None, :]
    else:
        positions = base + ar[None, :]

    aux = torch.zeros((), dtype=torch.float32, device=dev) if return_aux else None
    moe_aux = return_aux and bool(cfg.moe.n_experts)
    remat = cache is None and layers.remat_on(cfg, params["blocks"])
    nd, held = cfg.moe.first_dense, bool(cfg.moe.held)
    if held:
        if cache is not None:
            raise NotImplementedError(f"{cfg.name} trains, and is not served")
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=dev)
    for l, lcfg in enumerate(_layer_cfgs(cfg)):
        if l < nd:
            blk = layer_params(params["dense_blocks"], l)
        else:
            blk = layer_params(params["blocks"], l - nd)
        if held and l >= nd:
            bias = None if router_bias is None else router_bias[l - nd]
            fn = partial(checkpoint, _held_layer, use_reentrant=False) if remat else _held_layer
            x, aux, counts = fn(blk, x, aux, lcfg, positions, bias)
            if expert_counts is not None:
                expert_counts.append(counts)
        elif cache is None:
            layer_aux = moe_aux and not held  # a held config's dense layers take none
            if remat:
                x, aux = checkpoint(_layer, blk, x, aux, lcfg, positions, layer_aux,
                                    use_reentrant=False)
            else:
                x, aux = _layer(blk, x, aux, lcfg, positions, layer_aux)
        else:
            x, _ = _block(blk, x, lcfg, positions=positions,
                          cache=(cache["k"][l], cache["v"][l]), cache_index=base)

    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["head"], x, cfg.quant)
    if cache is not None:
        return logits, cache
    if return_aux:
        return logits, aux
    return logits


# --------------------------------------------------------------------- loss


def loss_fn(params, batch, cfg, *, router_bias=None, device=None):
    """Next-token cross-entropy plus ``cfg.moe.aux_coef`` times the MoE aux;
    batch = {"tokens": (B, S+1)} (+ "patches" (B, P, D) for vlm: the
    prefix's logits are dropped).  Returns (loss, metrics); differentiable
    in ``params`` (``train.train_step`` takes its gradient).  Held-expert
    configs select with ``router_bias`` and add ``metrics["expert_counts"]``
    (MoE layers, experts): the forward's assignments per expert."""
    with timeline.span("lm.tokens"):  # from host memory, the copy waits for the card
        tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=resolve_device(device))
    prefix = batch.get("patches")
    counts = [] if cfg.moe.held else None
    logits, aux = forward(params, tok[:, :-1], cfg, prefix_embeds=prefix, return_aux=True,
                          router_bias=router_bias, expert_counts=counts, device=device)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:, :]
    nll = layers.next_token_nll(logits, tok[:, 1:])
    loss = nll + cfg.moe.aux_coef * aux
    metrics = {"nll": nll, "aux": aux}
    if counts:
        metrics["expert_counts"] = torch.stack(counts)
    return loss, metrics


# ------------------------------------------------------------------- decode


def init_cache(cfg, batch: int, max_seq: int, *, dtype=torch.bfloat16, device=None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, tokens, cache, cache_index, cfg, *, prefix_embeds=None, device=None):
    """One serving step: tokens (B, S_new) appended at ``cache_index``.

    prefill: S_new = prompt length; decode: S_new = 1.
    Returns (logits for the new positions, the updated cache).
    """
    return forward(params, tokens, cfg, prefix_embeds=prefix_embeds, cache=cache,
                   cache_index=cache_index, device=device)
