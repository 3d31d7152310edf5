"""The dense transformer's loss on one rank of a device mesh: what GSPMD
computes for the reference's rules, with the layouts and collectives
written out.

Each rank holds its slices of the parameters (``sharding.shard_tree`` by
``param_specs.named_shardings``) and its rows of the batch (batch over
``('pod', 'data')``).  Over ``model``, Megatron-style tensor parallelism:

- the embedding is vocab-parallel: a masked lookup in the rank's rows of
  the table, then a sum all-reduce;
- column-parallel linears (None, 'ffn') compute the rank's output columns
  from the whole input; row-parallel ones ('ffn', None) contract the
  rank's slice of K and end in a sum all-reduce;
- attention runs the rank's heads; where ``n_heads`` does not divide the
  model axis (the reference's fallback, ``layers.constrain_qkv``) every
  head is computed on every rank from the gathered q/k/v, and each rank
  keeps the slice ``wo`` contracts;
- the head is vocab-parallel: the logsumexp takes a max all-reduce, then a
  sum all-reduce, and the gold logit a sum all-reduce.

Under ``quant.mode == 'mma_int8'`` every quantization max is the global
tensor's, as GSPMD takes it: a row-parallel linear's per-row activation
amax and per-channel weight amax are max all-reduced over ``model``, its
int32 accumulator is sum all-reduced before the dequantization (exact: the
sharded integer product equals the unsharded one bit for bit), and the
straight-through estimator's float32 product is a float all-reduce
(equal within rounding).  A column-parallel linear's maxes are local
already (whole K, whole rows).

Sequence parallelism of the residual (``seq`` -> ``model``) and the decode
cache's ``kv_seq`` change only where a value lives, not what it is; the
residual here is replicated over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.core import mma
from repro_torch.core import quant as quant_lib
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import _layer_cfgs

from . import collectives as coll
from .sharding import current_mesh

MODEL = "model"


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present on ``mesh``."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _slice(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` over ``model``."""
    size = t.shape[dim] // mesh.size(MODEL)
    return t.narrow(dim, mesh.index(MODEL) * size, size)


def mma_product(xq: torch.Tensor, wq: torch.Tensor, *, planes, impl, mesh, reduce: bool):
    """The int32 product of one quantized linear through the MMA datapath;
    with ``reduce`` (a row-parallel linear's partial over its K slice) sum
    all-reduced over ``model``."""
    acc = mma.mma_dot(xq, wq, planes=planes, impl=impl)
    return coll.all_reduce(acc, mesh, MODEL) if reduce else acc


def _product(w: torch.Tensor, x: torch.Tensor, quant, mesh, *, reduce: bool) -> torch.Tensor:
    """``x @ w`` as ``layers.linear`` routes a float weight; with ``reduce``
    the product of the rank's K slices, completed over ``model``."""
    if quant is not None and quant.mode == "mma_int8":
        xf, wf = x.to(torch.float32), w.to(torch.float32)
        if x.ndim >= 3:  # per batch row, as layers.linear quantizes
            x_amax = torch.amax(torch.abs(xf.detach()), dim=tuple(range(1, x.ndim)), keepdim=True)
        else:
            x_amax = torch.amax(torch.abs(xf.detach()))
        w_amax = torch.amax(torch.abs(wf.detach()), dim=0, keepdim=True)  # per output channel
        if reduce:
            x_amax = coll.all_reduce(x_amax, mesh, MODEL, "max")
            w_amax = coll.all_reduce(w_amax, mesh, MODEL, "max")
        xq, wq = quant_lib.quantize_amax(xf, x_amax), quant_lib.quantize_amax(wf, w_amax)
        acc = mma_product(xq.values, wq.values, planes=quant.planes, impl=quant.impl,
                          mesh=mesh, reduce=reduce)
        out = acc.to(torch.float32) * quant_lib.quantized_matmul_scale(xq.scale, wq.scale)
        full = xf @ wf
        if reduce:
            full = coll.all_reduce(full, mesh, MODEL)
        return (full + (out - full).detach()).to(x.dtype)
    if reduce:
        return coll.all_reduce(x.to(torch.float32) @ w.to(torch.float32), mesh, MODEL).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def _column(p: dict, x: torch.Tensor, quant, mesh, n_full: int) -> torch.Tensor:
    """A column-parallel linear inside a tensor-parallel sublayer (``x``
    already marked for varying use): the rank's columns, or every column
    from a weight that could not be split."""
    if "w_q" in p:
        raise NotImplementedError("pre-quantized (w_q) weights under a mesh: serving's slice")
    w, b = p["w"], p.get("b")
    if w.shape[-1] == n_full:  # replicated weight in varying use: sum its gradient
        w = coll.pbroadcast(w, mesh, MODEL)
        b = None if b is None else coll.pbroadcast(b, mesh, MODEL)
    elif b is not None:
        b = _slice(coll.pbroadcast(b, mesh, MODEL), 0, mesh)
    out = _product(w, x, quant, mesh, reduce=False)
    return out if b is None else out + b.to(out.dtype)


def _row(p: dict, x: torch.Tensor, quant, mesh) -> torch.Tensor:
    """A row-parallel linear: ``x`` holds the rank's slice of K."""
    if p["w"].shape[0] != x.shape[-1]:
        raise ValueError(f"row-parallel weight {tuple(p['w'].shape)} for input {tuple(x.shape)}")
    out = _product(p["w"], x, quant, mesh, reduce=True)
    return out + p["b"].to(out.dtype) if "b" in p else out


def _gathered(t: torch.Tensor, full: int, mesh) -> torch.Tensor:
    return t if t.shape[-1] == full else coll.all_gather(t, mesh, MODEL, dim=-1)


def attention(p: dict, x: torch.Tensor, cfg, mesh, positions) -> torch.Tensor:
    b, s, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    if p["wo"]["w"].shape[0] == h * hd:  # wo unsplit: the sublayer is replicated
        return layers.attention(p, x, cfg, positions=positions)[0]
    m, quant = mesh.size(MODEL), cfg.quant
    xb = coll.pbroadcast(x, mesh, MODEL)
    q = _column(p["wq"], xb, quant, mesh, h * hd)
    k = _column(p["wk"], xb, quant, mesh, kv * hd)
    v = _column(p["wv"], xb, quant, mesh, kv * hd)
    heads_ok = h % m == 0
    if not heads_ok:  # every head on every rank
        q = _gathered(q, h * hd, mesh)
    if not (heads_ok and kv % m == 0):
        k, v = _gathered(k, kv * hd, mesh), _gathered(v, kv * hd, mesh)
        if heads_ok:  # the kv head of each of the rank's q heads
            hl = h // m
            idx = (mesh.index(MODEL) * hl + torch.arange(hl, device=x.device)) // (h // kv)
            k = k.reshape(b, s, kv, hd)[:, :, idx]
            v = v.reshape(b, s, kv, hd)[:, :, idx]
    q = layers.rope(q.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    k = layers.rope(k.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, -1, hd)
    out = layers.flash_attention(q, k, v, causal=True, window=cfg.swa_window,
                                 chunk=cfg.attn_chunk).reshape(b, s, -1)
    if not heads_ok:
        out = _slice(out, 2, mesh)  # the rows of wo this rank holds
    return _row(p["wo"], out, quant, mesh)


def mlp(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    ff, quant = cfg.d_ff, cfg.quant
    if p["w_down"]["w"].shape[0] == ff:
        return layers.mlp(p, x, cfg)
    xb = coll.pbroadcast(x, mesh, MODEL)
    if "w_gate" in p:
        gate = _column(p["w_gate"], xb, quant, mesh, ff)
        up = _column(p["w_up"], xb, quant, mesh, ff)
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    else:
        h = F.gelu(_column(p["w_up"], xb, quant, mesh, ff).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    return _row(p["w_down"], h, quant, mesh)


def embed(p: dict, tokens: torch.Tensor, cfg, mesh) -> torch.Tensor:
    table = p["table"]
    if table.shape[0] == cfg.vocab:
        return layers.embed(p, tokens)
    vl = table.shape[0]
    local = tokens - mesh.index(MODEL) * vl
    ok = (local >= 0) & (local < vl)
    x = table[torch.where(ok, local, 0)] * ok[..., None].to(table.dtype)
    return coll.all_reduce(x.to(torch.float32), mesh, MODEL).to(table.dtype)


def logits(params: dict, x: torch.Tensor, cfg, mesh) -> tuple[torch.Tensor, bool]:
    """The head's logits (the rank's vocab slice when the head is split)
    and whether they are split."""
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        if table.shape[0] == cfg.vocab:
            return layers.unembed(params["embed"], x), False
        return torch.matmul(coll.pbroadcast(x, mesh, MODEL), table.to(x.dtype).T), True
    head = params["head"]
    if head["w"].shape[-1] == cfg.vocab:
        return layers.linear(head, x, cfg.quant), False
    return _column(head, coll.pbroadcast(x, mesh, MODEL), cfg.quant, mesh, cfg.vocab), True


def next_token_nll(lg: torch.Tensor, targets: torch.Tensor, mesh) -> torch.Tensor:
    """``layers.next_token_nll`` of logits split over ``model`` by vocab."""
    lf = lg.to(torch.float32)
    vl = lf.shape[-1]
    mx = coll.all_reduce(lf.detach().amax(-1, keepdim=True), mesh, MODEL, "max")
    logz = mx[..., 0] + torch.log(coll.all_reduce(torch.exp(lf - mx).sum(-1), mesh, MODEL))
    t = targets - mesh.index(MODEL) * vl
    ok = (t >= 0) & (t < vl)
    gold = torch.take_along_dim(lf, torch.clamp(t, 0, vl - 1)[..., None], dim=-1)[..., 0]
    gold = coll.all_reduce(torch.where(ok, gold, 0.0), mesh, MODEL)
    return (logz - gold).mean()


def _block(p: dict, x: torch.Tensor, cfg, mesh, positions) -> torch.Tensor:
    x = x + attention(p["attn"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, mesh, positions)
    return x + mlp(p["mlp"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, mesh)


def loss_fn(params: dict, batch: dict, cfg, *, mesh=None, device=None):
    """Next-token cross-entropy of this rank's rows (``batch["tokens"]``:
    (B_local, S+1)) under ``mesh`` (default: the active one), ``params``
    this rank's slices on ``device``.  Returns ``(loss, metrics)`` as
    ``transformer.loss_fn`` does; the loss is the mean over the rank's rows
    and is equal on every rank of a ``model`` group.  The dense family
    only."""
    mesh = mesh or current_mesh()
    if mesh is None or not mesh.has_ranks:
        raise RuntimeError("sharded_lm.loss_fn needs an active mesh with ranks")
    if cfg.family != "dense":
        raise NotImplementedError(f"the sharded loss covers the dense family, not {cfg.family!r}")
    dev = resolve_device(device)
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    x = embed(params["embed"], tok[:, :-1], cfg, mesh)
    positions = torch.arange(x.shape[1], device=dev)[None, :]
    remat = (cfg.remat == "full" and torch.is_grad_enabled()
             and any(t.requires_grad for t in tree_leaves(params["blocks"])))
    for l, lcfg in enumerate(_layer_cfgs(cfg)):
        blk = layers.layer_params(params["blocks"], l)
        if remat:
            x = checkpoint(_block, blk, x, lcfg, mesh, positions, use_reentrant=False)
        else:
            x = _block(blk, x, lcfg, mesh, positions)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    lg, split = logits(params, x, cfg, mesh)
    targets = tok[:, 1:]
    nll = next_token_nll(lg, targets, mesh) if split else layers.next_token_nll(lg, targets)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}
