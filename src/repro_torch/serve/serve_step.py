"""Serving steps: prefill (prompt -> logits) and decode (one token against a
KV cache of ``max_seq``) for the transformer LM families the port serves.

The MMA quantized datapath (cfg.quant.mode='mma_int8') applies here — this
is where the paper's early-termination knob (quant.planes) meets LM serving.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.device import resolve_device


def _lm_module(cfg):
    mod = models.build(cfg)  # raises for the families not ported yet
    if cfg.family not in models.PLANE_SCHEDULE_FAMILIES:
        raise ValueError(f"no LM serving step for family {cfg.family!r}")
    return mod


def make_prefill(cfg, *, device=None):
    mod = _lm_module(cfg)
    dev = resolve_device(device)

    def prefill(params, tokens, extras):
        return mod.forward(params, tokens, cfg, prefix_embeds=extras.get("patches"), device=dev)

    return prefill


def make_decode(cfg, batch: int, max_seq: int, *, device=None):
    """Returns (decode_fn, cache_spec).  decode_fn(params, tokens, cache,
    index, extras) -> (logits, cache); cache_spec is the cache's layout as
    tensors on the ``meta`` device (shapes and dtypes, no storage)."""
    mod = _lm_module(cfg)
    dev = resolve_device(device)
    cache_dtype = torch.int8 if cfg.quant.kv_int8 else torch.bfloat16
    spec = mod.init_cache(cfg, batch, max_seq, dtype=cache_dtype, device="meta")

    def decode(params, tokens, cache, index, extras):
        return mod.decode_step(params, tokens, cache, index, cfg, device=dev)

    return decode, spec
