"""The transformer families' loss on one rank of a device mesh (dense,
moe, vlm): what GSPMD computes for the reference's rules, with the layouts
and collectives written out; and the pieces the other families' sharded
losses share (``sharded_rwkv6``, ``sharded_zamba2``, ``sharded_whisper``):
column- and row-parallel linears, attention (with or without RoPE and the
causal mask), cross-attention, the split RMSNorm, gathered leaves, the
vocab-parallel embedding, head and NLL.

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
(equal within rounding; the forward value is the quantized product's,
``core.mma.straight_through``).  A column-parallel linear's maxes are local
already (whole K, whole rows).

Sequence parallelism of the residual (``seq`` -> ``model``) and the decode
cache's ``kv_seq`` change only where a value lives, not what it is; the
residual here is replicated over ``model``.

The ``moe`` family (experts over ``model``, the router's E columns
column-parallel):

- under ``moe.ep`` where the reference takes ``moe_ffn_ep`` (|model| > 1,
  whole slabs, no quantization), each rank routes its rows' ``seq`` slab
  on the float32 product with the gathered router and exchanges expert
  slabs over ``model`` (``models.moe.ep_slab``), with the reference's
  local capacity;
- otherwise the reference's ``moe_ffn`` under GSPMD, whose semantics are
  global: ``cap`` is taken from every data rank's tokens, and an
  assignment's position in its expert's segment counts the assignments of
  every lower data rank (an all-gather of the per-expert counts over the
  data axes).  Each rank runs its experts on its own rows' kept
  assignments; the per-assignment outputs are summed over ``model`` (each
  is nonzero on one rank: exact) and combined as ``moe_ffn`` combines.

The router is a bf16 product under every ``quant`` (the reference's
``moe_ffn`` and ``load_balance_loss`` call ``layers.linear`` without it).

Routing decisions cross data ranks but carry no gradient, so each rank
differentiates its own rows.  The load-balance aux (on the block's input,
as the reference takes it) is a mean over global tokens: its sums are
all-reduced over the data axes, and the probabilities' sum is marked for
varying use there (``pbroadcast``), so the train step's mean over data
ranks gives the aux's whole gradient.

The ``vlm`` family prepends the batch's ``patches`` (split over the data
axes like ``tokens``) and drops their positions' logits before the NLL.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mma
from repro_torch.core import quant as quant_lib
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
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
        return mma.straight_through(out, full).to(x.dtype)
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


def _varying(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (replicated over ``model``) marked for varying use there."""
    return coll.pbroadcast(t, mesh, MODEL)


def _gathered(t: torch.Tensor, full: int, mesh, *, replicated: bool = False) -> torch.Tensor:
    """``t`` whole along its last dim (``full`` wide): gathered over
    ``model`` where the rank holds a slice.  This is how a leaf split off
    the head boundary (RWKV6's ``u``, ``mix_base``, LoRAs; Mamba2's
    ``conv_w``; Whisper's position tables) comes whole; ``replicated`` for a
    consumer that is alike on every rank (``collectives.all_gather``)."""
    if t.shape[-1] == full:
        return t
    return coll.all_gather(t, mesh, MODEL, dim=-1, replicated=replicated)


def split_rmsnorm(p: dict, x: torch.Tensor, eps: float, mesh) -> torch.Tensor:
    """``layers.rmsnorm_exact`` over a last dim of which ``x`` holds the
    rank's slice (``p["scale"]`` whole, replicated): the float64 sum of
    squares sum all-reduced over ``model``, then each rank scales its slice.
    Equal bit for bit to the unsharded norm (the partial sums are exact)."""
    full = p["scale"].shape[0]
    ss = _varying(coll.all_reduce(layers.sum_squares(x), mesh, MODEL), mesh)
    y = x.to(torch.float32) * torch.rsqrt((ss / full).to(torch.float32) + eps)
    scale = _slice(_varying(p["scale"], mesh), 0, mesh)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _attend(p: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg, mesh, positions,
            causal: bool) -> torch.Tensor:
    """The rank's heads of attention: q from ``xq``, k and v from ``xkv``
    (both marked for varying use), RoPE where ``positions`` are given, then
    ``wo`` row-parallel.  Where ``n_heads`` does not divide the model axis
    every head runs on every rank (the reference's ``constrain_qkv``
    fallback)."""
    b, s, _ = xq.shape
    t = xkv.shape[1]
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    m, quant = mesh.size(MODEL), cfg.quant
    q = _column(p["wq"], xq, quant, mesh, h * hd)
    k = _column(p["wk"], xkv, quant, mesh, kv * hd)
    v = _column(p["wv"], xkv, quant, mesh, kv * hd)
    heads_ok = h % m == 0
    if not heads_ok:  # every head on every rank
        q = _gathered(q, h * hd, mesh)
    if not (heads_ok and kv % m == 0):
        k, v = _gathered(k, kv * hd, mesh), _gathered(v, kv * hd, mesh)
        if heads_ok:  # the kv head of each of the rank's q heads
            hl = h // m
            idx = (mesh.index(MODEL) * hl + torch.arange(hl, device=xq.device)) // (h // kv)
            k = k.reshape(b, t, kv, hd)[:, :, idx]
            v = v.reshape(b, t, kv, hd)[:, :, idx]
    q, k, v = q.reshape(b, s, -1, hd), k.reshape(b, t, -1, hd), v.reshape(b, t, -1, hd)
    if positions is not None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    out = layers.flash_attention(q, k, v, causal=causal, window=cfg.swa_window,
                                 chunk=cfg.attn_chunk).reshape(b, s, -1)
    if not heads_ok:
        out = _slice(out, 2, mesh)  # the rows of wo this rank holds
    return _row(p["wo"], out, quant, mesh)


def attention(p: dict, x: torch.Tensor, cfg, mesh, positions, *, causal: bool = True
              ) -> torch.Tensor:
    """Self-attention (``positions`` None: no RoPE, as Whisper's)."""
    if p["wo"]["w"].shape[0] == cfg.n_heads * cfg.hd:  # wo unsplit: replicated
        return layers.attention(p, x, cfg, positions=positions, causal=causal)[0]
    xb = _varying(x, mesh)
    return _attend(p, xb, xb, cfg, mesh, positions, causal)


def cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """Whisper's cross-attention: the rank's heads of q from ``x``, of k and
    v from the encoder ``memory`` through the same column-parallel linears,
    no mask, ``wo`` row-parallel."""
    return _attend(p, _varying(x, mesh), _varying(memory, mesh), cfg, mesh, None, False)


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
    x = layers.embed_rows(table, torch.where(ok, local, 0)) * ok[..., None].to(table.dtype)
    return coll.all_reduce(x.to(torch.float32), mesh, MODEL).to(table.dtype)


def tied_logits(embed_p: dict, x: torch.Tensor, cfg, mesh) -> tuple[torch.Tensor, bool]:
    """The logits of the head tied to the embedding (a bf16 product), the
    rank's vocab slice where the table is split, and whether it is."""
    table = embed_p["table"]
    if table.shape[0] == cfg.vocab:
        return layers.unembed(embed_p, x), False
    return torch.matmul(coll.pbroadcast(x, mesh, MODEL), table.to(x.dtype).T), True


def logits(params: dict, x: torch.Tensor, cfg, mesh) -> tuple[torch.Tensor, bool]:
    """The head's logits (the rank's vocab slice when the head is split)
    and whether they are split."""
    if cfg.tie_embeddings:
        return tied_logits(params["embed"], x, cfg, mesh)
    head = params["head"]
    if head["w"].shape[-1] == cfg.vocab:
        return layers.linear(head, x, cfg.quant), False
    return _column(head, coll.pbroadcast(x, mesh, MODEL), cfg.quant, mesh, cfg.vocab), True


def nll(lg: torch.Tensor, split: bool, targets: torch.Tensor, mesh) -> torch.Tensor:
    """The mean next-token NLL of :func:`logits`' output."""
    return next_token_nll(lg, targets, mesh) if split else layers.next_token_nll(lg, targets)


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


# ------------------------------------------------------------------ MoE


def _experts_split(p: dict, cfg) -> bool:
    return p["w_gate"].shape[0] != cfg.moe.n_experts


def router_logits(p: dict, xf: torch.Tensor, cfg, mesh, *, split: bool) -> torch.Tensor:
    """(T_loc, D) -> (T_loc, E) float32, replicated over ``model``: the
    router's bf16 product, then float32 (``moe.router_logits``); with
    ``split`` ``xf`` is marked for varying use and the router's E columns
    are the rank's, whose logits are summed into place over ``model``
    (exact: one rank holds each column)."""
    lg = torch.matmul(xf, p["router"]["w"].to(xf.dtype)).to(torch.float32)
    if not split:
        return lg
    full = torch.zeros((*lg.shape[:-1], cfg.moe.n_experts), dtype=torch.float32, device=lg.device)
    c0 = mesh.index(MODEL) * lg.shape[-1]
    full[..., c0:c0 + lg.shape[-1]] = lg
    return coll.all_reduce(full, mesh, MODEL)


def load_balance_loss(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``moe.load_balance_loss`` over the global batch: ``f`` and the mean
    probability are sums over every data rank's tokens (see the module's
    docstring for the gradient)."""
    m, dp = cfg.moe, dp_axes(mesh)
    split = _experts_split(p, cfg)
    xf = x.reshape(-1, x.shape[-1])
    xs = coll.pbroadcast(xf, mesh, MODEL) if split else xf
    probs = torch.softmax(router_logits(p, xs, cfg, mesh, split=split), dim=-1)
    t = xf.shape[0] * mesh.size(dp)
    top1 = torch.argmax(probs, dim=-1)
    f = coll.all_reduce(F.one_hot(top1, m.n_experts).to(torch.float32).sum(0), mesh, dp) / t
    psum = coll.pbroadcast(coll.all_reduce(probs.sum(0), mesh, dp), mesh, dp)
    return m.n_experts * torch.sum(f * (psum / t))


def route(p: dict, xs: torch.Tensor, cfg, mesh, *, split: bool):
    """``moe_ffn``'s routing of this rank's tokens ``xs`` (T_loc, D) within
    the global batch: ``(cap, (eid_s, pos, tok_s, gw_s, keep))`` over the
    rank's T_loc*k assignments sorted by expert id (``tok_s`` local,
    ``pos`` the global position in the expert's segment)."""
    m, dp = cfg.moe, dp_axes(mesh)
    cap = moe_lib.capacity(xs.shape[0] * mesh.size(dp), m)
    eid, eid_s, local_pos, tok_s, gw_s = moe_lib.assignments(
        router_logits(p, xs, cfg, mesh, split=split), m.top_k)
    # each expert's segment starts after the lower data ranks' assignments
    counts = torch.zeros((1, m.n_experts), dtype=torch.int64, device=xs.device)
    counts.scatter_add_(1, eid[None], torch.ones_like(eid)[None])
    below = coll.all_gather(counts, mesh, dp, dim=0)[:mesh.index(dp)].sum(0)
    pos = below[eid_s] + local_pos
    return cap, (eid_s, pos, tok_s, gw_s, pos < cap)


def _moe_global(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The reference's ``moe_ffn`` on this rank's rows ``x`` (B_loc, S, D)
    (see the module's docstring)."""
    bl, s, d = x.shape
    t_loc = bl * s
    split = _experts_split(p, cfg)
    xf = x.reshape(t_loc, d)
    xs = coll.pbroadcast(xf, mesh, MODEL) if split else xf
    cap, meta = route(p, xs, cfg, mesh, split=split)
    eid_s, pos, tok_s, _, keep = meta
    e_loc = p["w_gate"].shape[0]
    e0 = mesh.index(MODEL) * e_loc if split else 0
    mine = keep & (eid_s >= e0) & (eid_s < e0 + e_loc)
    # an assignment another rank's experts take, or a dropped one, writes
    # row ``cap`` of a (cap + 1)-row buffer, which is cut off
    e_c, pos_c = torch.where(mine, eid_s - e0, 0), torch.where(mine, pos, cap)
    buf = torch.zeros((e_loc, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[e_c, pos_c] = xs[tok_s].to(x.dtype)
    oe = moe_lib.expert_ffn(p, buf[:, :cap])
    contrib = oe[e_c, torch.clamp(pos_c, max=cap - 1)] * mine[:, None].to(x.dtype)
    if split:
        contrib = coll.all_reduce(contrib.to(torch.float32), mesh, MODEL).to(x.dtype)
    return moe_lib.weighted_combine(contrib, meta, t_loc, x.dtype).reshape(bl, s, d)


def _moe_ep(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """``moe_ffn_ep`` on this rank's rows: the rank's ``seq`` slab through
    ``moe.ep_slab``, the slabs summed into place over ``model``."""
    bl, s, d = x.shape
    sl = s // mesh.size(MODEL)
    xb = coll.pbroadcast(x, mesh, MODEL)
    router = _gathered(p["router"]["w"], cfg.moe.n_experts, mesh)
    s0 = mesh.index(MODEL) * sl
    y = moe_lib.ep_slab(p, xb[:, s0:s0 + sl].reshape(bl * sl, d), router, cfg, mesh)
    out = torch.zeros((bl, s, d), dtype=torch.float32, device=x.device)
    out[:, s0:s0 + sl] = y.reshape(bl, sl, d).to(torch.float32)
    return coll.all_reduce(out, mesh, MODEL).to(x.dtype)


def moe_ffn(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The MoE FFN on this rank's rows, by the path the reference takes:
    ``moe_ffn_ep``'s where its conditions hold, else ``moe_ffn``'s."""
    m, msize = cfg.moe, mesh.size(MODEL)
    if m.ep and msize > 1 and m.n_experts % msize == 0 and cfg.quant.mode == "none":
        if x.shape[1] % msize:
            raise NotImplementedError(
                f"moe_ffn_ep with a sequence of {x.shape[1]} that 'model' ({msize}) does not split")
        return _moe_ep(p, x, cfg, mesh)
    return _moe_global(p, x, cfg, mesh)


def _layer(p: dict, x: torch.Tensor, aux: torch.Tensor, cfg, mesh, positions):
    """One layer: the MoE aux on the block's input (quirk of the
    reference), then attention and the FFN."""
    if cfg.moe.n_experts:
        aux = aux + load_balance_loss(p["moe"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                                      mesh)
    x = x + attention(p["attn"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, mesh, positions)
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe.n_experts:
        return x + moe_ffn(p["moe"], h, cfg, mesh), aux
    return x + mlp(p["mlp"], h, cfg, mesh), aux


def loss_fn(params: dict, batch: dict, cfg, *, mesh=None, device=None):
    """Next-token cross-entropy of this rank's rows (``batch["tokens"]``:
    (B_local, S+1)) under ``mesh`` (default: the active one), ``params``
    this rank's slices on ``device``; ``batch["patches"]`` (B_local, P, D)
    for vlm, ``batch["frames"]`` (B_local, T, D) for encdec.  Returns
    ``(loss, metrics)`` as the family's unsharded ``loss_fn`` does; the
    loss is the rank's rows' NLL (plus 0.01 x the global aux for moe),
    equal on every rank of a ``model`` group.  Every LM family: the ssm,
    hybrid and encdec ones in ``sharded_rwkv6``, ``sharded_zamba2`` and
    ``sharded_whisper``.

    Over a shape-only mesh on ``meta`` tensors (``device='meta'``) this
    counts the rank's collectives (``parallel.collectives``)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise RuntimeError("sharded_lm.loss_fn needs an active mesh")
    dev = resolve_device(device)
    if cfg.family in ("ssm", "hybrid", "encdec"):
        from . import sharded_rwkv6, sharded_whisper, sharded_zamba2

        mod = {"ssm": sharded_rwkv6, "hybrid": sharded_zamba2, "encdec": sharded_whisper}
        return mod[cfg.family].loss_fn(params, batch, cfg, mesh, dev)
    tok = torch.as_tensor(batch["tokens"], dtype=torch.int64, device=dev)
    x = embed(params["embed"], tok[:, :-1], cfg, mesh)
    prefix = batch.get("patches")
    n_prefix = 0
    if prefix is not None:  # the vlm stub frontend
        n_prefix = prefix.shape[1]
        x = torch.cat([torch.as_tensor(prefix, device=dev).to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=dev)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = layers.remat_on(cfg, params["blocks"])
    for l, lcfg in enumerate(_layer_cfgs(cfg)):
        blk = layers.layer_params(params["blocks"], l)
        if remat:
            x, aux = checkpoint(_layer, blk, x, aux, lcfg, mesh, positions, use_reentrant=False)
        else:
            x, aux = _layer(blk, x, aux, lcfg, mesh, positions)
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    lg, split = logits(params, x, cfg, mesh)
    out = nll(lg[:, n_prefix:], split, tok[:, 1:], mesh)
    return out + 0.01 * aux, {"nll": out, "aux": aux}
