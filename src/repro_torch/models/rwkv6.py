"""RWKV6 ("Finch"), the 'ssm' family: an attention-free LM with a
data-dependent decay.

Time-mix: per-head state S (P x P) updated as
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with w_t data-dependent (a LoRA on the shifted-token mix).  The reference
scans the recurrence over the sequence; here it is a Python loop over S in
float32, ``y`` read before the update.  Decode carries (S, last token) per
layer, so the state is O(1) in the sequence length.

Channel-mix: token shift and a squared-ReLU MLP.

The parameter tree is the reference's, every block leaf stacked ``(L, ...)``
under ``params["blocks"]``; a Python loop takes layer ``l``'s views, each
block rematerialised where a gradient is taken under ``cfg.remat == 'full'``
(the reference's ``jax.checkpoint`` of its scan body).  The float32 leaves
(``w_base``, ``u``) stay float32.  ``ln_x``'s mean square, the LoRAs' and
the WKV step's products accumulate in float64 (``layers.rmsnorm_exact``,
``layers.einsum_exact``), so a sharded step's rank computes its rows and
heads bit-equal to the whole batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quant
from repro_torch.device import resolve_device

from . import layers

LORA_R = 64

params_to = layers.params_to


def dims(cfg):
    p = cfg.ssm_head_dim or 64
    h = cfg.d_model // p
    return h, p


# ------------------------------------------------------------------ params


def _normal(g, shape, scale, *, device) -> torch.Tensor:
    t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return (t * scale).to(torch.bfloat16)


def init_time_mix(g: torch.Generator, cfg, *, device) -> dict:
    h, p = dims(cfg)
    d = cfg.d_model
    return {
        "mix_base": torch.zeros((5, d), dtype=torch.bfloat16, device=device),  # r,k,v,w,g
        "mix_lora_a": layers.init_linear(g, d, LORA_R * 5, device=device),
        "mix_lora_b": _normal(g, (5, LORA_R, d), 0.01, device=device),
        "wr": layers.init_linear(g, d, d, device=device),
        "wk": layers.init_linear(g, d, d, device=device),
        "wv": layers.init_linear(g, d, d, device=device),
        "wg": layers.init_linear(g, d, d, device=device),
        "wo": layers.init_linear(g, d, d, device=device),
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=device),  # decay bias
        "w_lora_a": layers.init_linear(g, d, LORA_R, device=device),
        "w_lora_b": _normal(g, (LORA_R, d), 0.01, device=device),
        "u": torch.zeros((h, p), dtype=torch.float32, device=device),  # current-token bonus
        "ln_x": layers.init_norm(d, device=device),
    }


def init_channel_mix(g: torch.Generator, cfg, *, device) -> dict:
    d = cfg.d_model
    return {
        "mix_k": torch.zeros((d,), dtype=torch.bfloat16, device=device),
        "mix_r": torch.zeros((d,), dtype=torch.bfloat16, device=device),
        "wk": layers.init_linear(g, d, cfg.d_ff, device=device),
        "wv": layers.init_linear(g, cfg.d_ff, d, device=device),
        "wr": layers.init_linear(g, d, d, device=device),
    }


def init_block(g: torch.Generator, cfg, *, device) -> dict:
    return {
        "ln1": layers.init_norm(cfg.d_model, device=device),
        "time_mix": init_time_mix(g, cfg, device=device),
        "ln2": layers.init_norm(cfg.d_model, device=device),
        "channel_mix": init_channel_mix(g, cfg, device=device),
    }


def init_params(seed: int, cfg, *, device=None, int8_min_dim: int | None = None) -> dict:
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
        "embed": layers.init_embedding(g, cfg.vocab, cfg.d_model, device=dev),
        "blocks": layers.stack_trees([made(init_block(g, cfg, device=dev))
                                      for _ in range(cfg.n_layers)]),
        "ln_f": layers.init_norm(cfg.d_model, device=dev),
        "head": made(layers.init_linear(g, cfg.d_model, cfg.vocab, device=dev)),
    }


def params_from_jax(tree, *, device=None) -> dict:
    """The reference's parameter tree (leaves as numpy arrays, bf16 leaves as
    numpy bf16) on ``device``, each leaf keeping its dtype."""
    return layers.params_from_numpy(tree, device=resolve_device(device))


# ----------------------------------------------------------------- forward


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried last token, at t = 0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def lora_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A LoRA's product (no quant config, as the reference's): a float
    weight's accumulated in float64 (``layers.einsum_exact``), an int8
    leaf's on the Horner route at 8 planes (``layers.linear``)."""
    if "w" in p:
        return layers.einsum_exact("...k,kn->...n", x, p["w"], dtype=x.dtype)
    return layers.linear(p, x)


def wkv(r, k, v, w, u, s0):
    """The WKV recurrence over the sequence, in float32.  r, k, v, w:
    (B, S, H, P); u: (H, P); s0: (B, H, P, P).  Returns y (B, S, H, P) and
    the final state."""
    st = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, P, P)
        ys.append(layers.einsum_exact("bhp,bhpq->bhq", r[:, t], st + u[None, :, :, None] * kv,
                                      dtype=st.dtype))
        st = w[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1), st


def time_mix(p, x, cfg, *, state=None):
    """x: (B, S, D) -> (out, new_state); state = {"s": (B, H, P, P), "x": (B, D)}."""
    h, pd = dims(cfg)
    b, s, d = x.shape
    xprev = _shift(x, None if state is None else state["x"])
    # data-dependent interpolation (the RWKV6 "ddlerp"); mix_lora_a takes no
    # quant config: int8 leaves run the Horner route at 8 planes
    delta = xprev - x
    lora = torch.tanh(lora_linear(p["mix_lora_a"], x).reshape(b, s, 5, LORA_R))
    dyn = layers.einsum_exact("bsfr,frd->bsfd", lora, p["mix_lora_b"], dtype=x.dtype)
    mix = p["mix_base"].to(x.dtype)[None, None] + dyn  # (B, S, 5, D)
    xr, xk, xv, xw, xg = [x + delta * mix[:, :, i, :] for i in range(5)]
    r = layers.linear(p["wr"], xr, cfg.quant).reshape(b, s, h, pd)
    k = layers.linear(p["wk"], xk, cfg.quant).reshape(b, s, h, pd)
    v = layers.linear(p["wv"], xv, cfg.quant).reshape(b, s, h, pd)
    g = F.silu(layers.linear(p["wg"], xg, cfg.quant).to(torch.float32))
    # data-dependent decay  w_t = exp(-exp(base + lora_w(xw)))
    wl = torch.tanh(lora_linear(p["w_lora_a"], xw))
    wd = lora_linear({"w": p["w_lora_b"]}, wl)
    logw = p["w_base"][None, None, :] + wd.to(torch.float32)
    w = torch.exp(-torch.exp(logw)).reshape(b, s, h, pd)  # in (0, 1)

    s0 = (torch.zeros((b, h, pd, pd), dtype=torch.float32, device=x.device)
          if state is None else state["s"])
    f32 = torch.float32
    y, s_final = wkv(r.to(f32), k.to(f32), v.to(f32), w, p["u"].to(f32), s0)
    y = layers.rmsnorm_exact(p["ln_x"], y.reshape(b, s, d).to(x.dtype), cfg.norm_eps)
    out = layers.linear(p["wo"], (y.to(f32) * g).to(x.dtype), cfg.quant)
    new_state = None if state is None else {"s": s_final, "x": x[:, -1, :]}
    return out, new_state


def channel_mix(p, x, cfg, *, last=None):
    xprev = _shift(x, last)
    xk = x + (xprev - x) * p["mix_k"].to(x.dtype)
    xr = x + (xprev - x) * p["mix_r"].to(x.dtype)
    k = layers.linear(p["wk"], xk, cfg.quant)
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    kv = layers.linear(p["wv"], k, cfg.quant)
    r = torch.sigmoid(layers.linear(p["wr"], xr, cfg.quant).to(torch.float32))
    out = (r * kv.to(torch.float32)).to(x.dtype)
    new_last = None if last is None else x[:, -1, :]
    return out, new_last


def block(blk, h, cfg, *, state=None):
    """One RWKV6 block on the residual stream ``h``.  ``state`` (decode):
    ``(tm_s, tm_x, cm_x)`` of this layer; returns (h, new state or None)."""
    tm_state = None if state is None else {"s": state[0], "x": state[1]}
    tm, new_tm = time_mix(blk["time_mix"], layers.rmsnorm(blk["ln1"], h, cfg.norm_eps), cfg,
                          state=tm_state)
    h = h + tm
    cm, new_cm = channel_mix(blk["channel_mix"], layers.rmsnorm(blk["ln2"], h, cfg.norm_eps),
                             cfg, last=None if state is None else state[2])
    h = h + cm
    return h, None if state is None else (new_tm["s"], new_tm["x"], new_cm)


def _stateless_block(blk, h, cfg):
    return block(blk, h, cfg)[0]


def forward(params, tokens, cfg, *, state=None, device=None, **_):
    """tokens: (B, S) int -> logits (B, S, vocab) on ``device`` (the CUDA
    card unless ``device='cpu'``).  With ``state`` (decode; see
    :func:`init_state`): returns (logits, new_state), a new state tree (the
    one given is not changed)."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    x = layers.embed(params["embed"], tokens)
    remat = state is None and layers.remat_on(cfg, params["blocks"])
    new = []
    for l in range(cfg.n_layers):
        blk = layers.layer_params(params["blocks"], l)
        if remat:
            x = checkpoint(_stateless_block, blk, x, cfg, use_reentrant=False)
            continue
        lstate = None if state is None else (state["tm_s"][l], state["tm_x"][l],
                                             state["cm_x"][l])
        x, ns = block(blk, x, cfg, state=lstate)
        new.append(ns)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = layers.linear(params["head"], x, cfg.quant)
    if state is None:
        return logits
    tm_s, tm_x, cm_x = (torch.stack(t) for t in zip(*new))
    return logits, {"tm_s": tm_s, "tm_x": tm_x, "cm_x": cm_x}


def init_state(cfg, batch: int, *, device=None) -> dict:
    dev = resolve_device(device)
    h, pd = dims(cfg)
    return {
        "tm_s": torch.zeros((cfg.n_layers, batch, h, pd, pd), dtype=torch.float32, device=dev),
        "tm_x": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=torch.bfloat16, device=dev),
        "cm_x": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=torch.bfloat16, device=dev),
    }


def loss_fn(params, batch, cfg, *, device=None):
    """Next-token cross-entropy; batch = {"tokens": (B, S+1)}.  Returns (loss,
    metrics); differentiable in ``params``."""
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64)
    nll = layers.next_token_nll(forward(params, tok[:, :-1], cfg, device=device), tok[:, 1:])
    return nll, {"nll": nll}


def decode_step(params, tokens, state, cache_index, cfg, *, device=None, **_):
    """One serving step: tokens (B, S_new) through the recurrent state (the
    cache index is not read: the state is not position-addressed)."""
    del cache_index
    return forward(params, tokens, cfg, state=state, device=device)
