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

from repro_torch.models import layers

from .sharded_lm import _gathered, attention, cross_attention, embed, mlp, nll, tied_logits


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
