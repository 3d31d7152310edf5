"""The transformer families' loss and serving steps on one rank of a device
mesh (dense, moe, vlm): what GSPMD computes for the reference's rules, with
the layouts and collectives written out; and the pieces the other
families' sharded losses and serving steps share (``sharded_rwkv6``,
``sharded_zamba2``, ``sharded_whisper``): column- and row-parallel linears
(float or pre-quantized, ``wq_product``), attention (with or without RoPE
and the causal mask), attention over a sequence-split KV cache
(``cached_attention``), cross-attention, the split RMSNorm, gathered
leaves, the vocab-parallel embedding, head and NLL.  The serving section
(at the end) says how prefill and decode are laid out.

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

Sequence parallelism of the residual (``seq`` -> ``model``) changes only
where a value lives, not what it is; the residual here is replicated over
``model``.

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

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mma
from repro_torch.core import quant as quant_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import _layer_cfgs

from . import collectives as coll
from .sharding import axis_tuple, current_mesh

MODEL = "model"
F32 = torch.float32
# :func:`kv_seq_attention`'s float32 partials all-reduced at once: at most
# this many bytes, or one chunk's where that is more (a long prompt's n
# chunks would otherwise hold n times the output).
KV_PART_BYTES = 1 << 28

# the data axes a serving step's rows are split over: the mesh's data axes,
# or none where the batch does not divide them (every data rank then holds
# every row); unset (training), the mesh's data axes
_ROW_AXES: contextvars.ContextVar = contextvars.ContextVar("row_axes", default=None)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present on ``mesh``."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def row_axes(mesh) -> tuple[str, ...]:
    """The axes this step's rows are split over (see ``_ROW_AXES``)."""
    got = _ROW_AXES.get()
    return dp_axes(mesh) if got is None else got


@contextlib.contextmanager
def rows_over(axes: tuple[str, ...]):
    """Run a serving step whose rows are split over ``axes``."""
    token = _ROW_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _ROW_AXES.reset(token)


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


def w_dims(p: dict) -> tuple[int, int]:
    """(K, N) of a linear's weight on this rank, float or pre-quantized."""
    w = p["w_q"] if "w_q" in p else p["w"]
    return w.shape[-2], w.shape[-1]


def wq_product(p: dict, x: torch.Tensor, quant, mesh, *, row: bool) -> torch.Tensor:
    """``x @ w`` of a pre-quantized linear (``w_q``, ``w_scale``: the rank's
    columns, or with ``row`` its slice of K), float32, as
    ``layers.linear`` computes it on the global tensor:

    - ``w_scale`` (split by N under the rules, whatever ``w_q``'s split)
      comes whole for a row-parallel weight (an all-gather);
    - the activation amax is the global one: per batch row (``impl`` int8,
      horner, cascade) a max all-reduce over ``model`` where K is split; on
      the kernel route, one scale per tensor (quirk 1), also over the axes
      the rows are split over;
    - a column-parallel or replicated product on the kernel route is the
      scaled kernel; a row-parallel one the unscaled kernel on the K slice,
      its int32 sum all-reduced over ``model``, then ``(float32(acc) *
      x_scale) * w_scale[n]``, the scaled kernel's epilogue in its order:
      bit-equal to the unsharded call;
    - on the other routes ``mma_dot`` (``mma_product``, all-reduced with
      ``row``), then ``acc * (x_scale * w_scale)``."""
    planes = quant.planes if quant is not None else 8
    impl = quant.impl if quant is not None else "horner"
    xf = x.to(F32)
    axes = (MODEL,) if row else ()
    if impl != "kernel" and x.ndim >= 3:  # one scale per batch row
        amax = torch.amax(torch.abs(xf), dim=tuple(range(1, x.ndim)), keepdim=True)
    else:  # one scale for the global tensor
        amax = torch.amax(torch.abs(xf))
        axes = row_axes(mesh) + axes
    xq = quant_lib.quantize_amax(xf, coll.all_reduce(amax, mesh, axes, "max"))
    # the rules split every (1, N) scale by N: a row-parallel weight's
    # (whole N) gathers its own
    w_scale = _gathered(p["w_scale"].squeeze(-2), p["w_q"].shape[-1], mesh, replicated=True)
    if impl == "kernel" and not row:
        if x.device.type == "meta":  # the dry run's counting mode: the product's shape
            return torch.matmul(xq.values, p["w_q"]).to(F32)
        return ops.mma_matmul_scaled(xq.values, p["w_q"], xq.scale, w_scale, planes=planes,
                                     device=x.device)
    acc = mma_product(xq.values, p["w_q"], planes=planes, impl=impl, mesh=mesh, reduce=row)
    if impl == "kernel":
        return acc.to(F32) * xq.scale * w_scale
    return acc.to(F32) * (xq.scale * w_scale)


def _bias(out: torch.Tensor, b, n: int, mesh) -> torch.Tensor:
    """``out`` (``n`` columns of the whole) plus the bias's columns."""
    if b is None:
        return out
    if b.shape[-1] != n:
        b = _slice(b, 0, mesh)
    return out + b.to(out.dtype)


def linear(p: dict, x: torch.Tensor, quant, mesh) -> torch.Tensor:
    """A linear whose weight is whole on the rank, its input replicated:
    ``layers.linear``, but for a pre-quantized weight on the kernel route,
    whose activation scale is the global tensor's (``wq_product``)."""
    if "w_q" not in p:
        return layers.linear(p, x, quant)
    out = wq_product(p, x, quant, mesh, row=False).to(x.dtype)
    return _bias(out, p.get("b"), out.shape[-1], mesh)


def _column(p: dict, x: torch.Tensor, quant, mesh, n_full: int) -> torch.Tensor:
    """A column-parallel linear inside a tensor-parallel sublayer (``x``
    already marked for varying use): the rank's columns, or every column
    from a weight that could not be split."""
    if "w_q" in p:
        out = wq_product(p, x, quant, mesh, row=False).to(x.dtype)
        return _bias(out, p.get("b"), out.shape[-1], mesh)
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
    if w_dims(p)[0] != x.shape[-1]:
        raise ValueError(f"row-parallel weight {w_dims(p)} for input {tuple(x.shape)}")
    if "w_q" in p:
        out = wq_product(p, x, quant, mesh, row=True).to(x.dtype)
    else:
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


def _whole_attention(p: dict, x: torch.Tensor, cfg, mesh, positions, causal: bool
                     ) -> torch.Tensor:
    """``layers.attention`` (no cache) of weights whole on the rank, through
    :func:`linear`."""
    b, s, _ = x.shape
    hd, quant = cfg.hd, cfg.quant
    q = linear(p["wq"], x, quant, mesh).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x, quant, mesh).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x, quant, mesh).reshape(b, s, cfg.n_kv_heads, hd)
    if positions is not None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    out = layers.flash_attention(q, k, v, causal=causal, window=cfg.swa_window,
                                 chunk=cfg.attn_chunk)
    return linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd), quant, mesh)


def attention(p: dict, x: torch.Tensor, cfg, mesh, positions, *, causal: bool = True
              ) -> torch.Tensor:
    """Self-attention (``positions`` None: no RoPE, as Whisper's)."""
    if w_dims(p["wo"])[0] == cfg.n_heads * cfg.hd:  # wo unsplit: replicated
        return _whole_attention(p, x, cfg, mesh, positions, causal)
    xb = _varying(x, mesh)
    return _attend(p, xb, xb, cfg, mesh, positions, causal)


def cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """Whisper's cross-attention: the rank's heads of q from ``x``, of k and
    v from the encoder ``memory`` through the same column-parallel linears,
    no mask, ``wo`` row-parallel."""
    return _attend(p, _varying(x, mesh), _varying(memory, mesh), cfg, mesh, None, False)


def mlp(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The MLP: ``w_gate``/``w_up`` column-parallel, ``w_down`` row-parallel;
    weights that could not be split whole on every rank (:func:`linear`)."""
    ff, quant = cfg.d_ff, cfg.quant
    if w_dims(p["w_down"])[0] == ff:
        def up(name):
            return linear(p[name], x, quant, mesh)

        def down(h):
            return linear(p["w_down"], h, quant, mesh)
    else:
        xb = coll.pbroadcast(x, mesh, MODEL)

        def up(name):
            return _column(p[name], xb, quant, mesh, ff)

        def down(h):
            return _row(p["w_down"], h, quant, mesh)
    if "w_gate" in p:
        h = F.silu(up("w_gate").to(torch.float32)).to(x.dtype) * up("w_up")
    else:
        h = F.gelu(up("w_up").to(torch.float32), approximate="tanh").to(x.dtype)
    return down(h)


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
    if w_dims(head)[1] == cfg.vocab:
        return linear(head, x, cfg.quant, mesh), False
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


# ---------------------------------------------------------------- serving
#
# The serving steps on a mesh (``serve.serve_step.make_prefill`` /
# ``make_decode`` with ``mesh``): the reference's prefill and decode under
# GSPMD with its serving layouts (``launch.specs._build_prefill`` /
# ``_build_decode``): parameters TP (or 2-D, see :func:`gather_2d`), rows
# over the data axes, the decode cache in ``serve_step.cache_shardings``'
# layout, whose attention caches split their *sequence* over ``model``
# (the reference's ``kv_seq`` rule).  Decode attention then runs every
# head on every rank (the reference replicates q over ``model``) over the
# rank's keys, and the ranks' partial softmaxes combine with a max and a
# sum all-reduce of O(B·H·d): the cache is never gathered.


def reshard(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """This rank's slice of a tensor laid out by spec ``src`` as the slice
    spec ``dst`` gives it: each dim split differently is gathered over its
    ``src`` axes (replicated use), then cut to its ``dst`` slice.  No
    collective where the specs agree."""
    src = tuple(src) + (None,) * (t.ndim - len(src))
    dst = tuple(dst) + (None,) * (t.ndim - len(dst))
    for dim, (a, b) in enumerate(zip(src, dst)):
        if axis_tuple(a) != axis_tuple(b) and mesh.size(a) > 1:
            t = coll.all_gather(t, mesh, axis_tuple(a), dim=dim, replicated=True)
    for dim, (a, b) in enumerate(zip(src, dst)):
        n = mesh.size(b)
        if axis_tuple(a) != axis_tuple(b) and n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(axis_tuple(b)) * size, size)
    return t.contiguous()


def gather_2d(tree, specs, mesh, skip: int = 0):
    """The leaves of ``tree`` with every dim that ``specs`` (a tree of
    ``PartitionSpec``, or None) splits over the data axes gathered over
    them: the 2-D serving mode's weights (``serve_step.param_shardings``)
    in their TP layout, FSDP-style.  ``skip``: leading dims of the specs
    that ``tree`` has dropped (one layer's view of a stacked tree)."""
    if specs is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_2d(v, specs[k], mesh, skip) for k, v in tree.items()}
    dpa = set(dp_axes(mesh))
    for dim, entry in enumerate(tuple(specs)[skip:]):
        axes = tuple(a for a in axis_tuple(entry) if a in dpa)
        if axes and mesh.size(axes) > 1:
            tree = coll.all_gather(tree, mesh, axes, dim=dim, replicated=True)
    return tree


def data_split_dims(specs, skip: int) -> bool:
    """Whether any leaf of ``specs`` splits one of its first ``skip`` dims
    (a stacked tree's layer dims) over a data axis."""
    if specs is None:
        return False
    if isinstance(specs, dict):
        return any(data_split_dims(v, skip) for v in specs.values())
    return any(a in ("pod", "data") for e in tuple(specs)[:skip] for a in axis_tuple(e))


def gathered_logits(lg: torch.Tensor, split: bool, mesh) -> torch.Tensor:
    """The whole vocab of logits a step returned split over ``model``."""
    return coll.all_gather(lg, mesh, MODEL, dim=-1, replicated=True) if split else lg


def _qkv_whole(p: dict, x: torch.Tensor, cfg, mesh):
    """q, k and v of every head on every rank (the reference's decode
    constrains them replicated over ``model``): the column-parallel
    products, gathered."""
    hd, h, kv, quant = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.quant
    parts = [(_column(p[n], x, quant, mesh, f), f)
             for n, f in (("wq", h * hd), ("wk", kv * hd), ("wv", kv * hd))]
    if all(t.shape[-1] * mesh.size(MODEL) == f for t, f in parts) and mesh.size(MODEL) > 1:
        # one all-gather for the three: rank r's [q_r k_r v_r] side by side
        widths = [t.shape[-1] for t, _ in parts]
        g = coll.all_gather(torch.cat([t for t, _ in parts], -1), mesh, MODEL, dim=-1,
                            replicated=True)
        g = g.reshape(*g.shape[:-1], mesh.size(MODEL), sum(widths))
        outs, c0 = [], 0
        for w in widths:
            outs.append(g[..., c0:c0 + w].reshape(*g.shape[:-2], -1))
            c0 += w
        return outs
    return [_gathered(t, f, mesh, replicated=True) for t, f in parts]


def write_local(c: torch.Tensor, u: torch.Tensor, index, mesh) -> None:
    """Write ``u`` (B, s, ...) at global positions ``[start, start + s)`` of
    a cache split over ``model`` by sequence, of which ``c`` (B, S_l, ...)
    is this rank's slice: the rank writes only the positions it holds.
    ``start`` is ``index`` clamped to ``[0, S_max - s]``, as the unsharded
    ``layers.cache_write`` (and the reference's ``dynamic_update_slice``)
    clamps it.  In pieces of at most S_l positions, whose slots mod S_l are
    distinct: a position another rank holds writes its slot's own value
    back."""
    b, s = u.shape[:2]
    sl = c.shape[1]
    start = torch.clamp(torch.as_tensor(index, dtype=torch.int64, device=c.device), 0,
                        sl * mesh.size(MODEL) - s).expand(b)
    local = (start[:, None] + torch.arange(s, device=c.device)[None, :]
             - mesh.index(MODEL) * sl)
    rows = torch.arange(b, device=c.device)[:, None]
    tail = (1,) * (u.ndim - 2)
    for j in range(0, s, sl):
        lj = local[:, j:j + sl]
        ok = ((lj >= 0) & (lj < sl)).reshape(lj.shape + tail)
        slot = lj.remainder(sl)
        c[rows, slot] = torch.where(ok, u[:, j:j + sl].to(c.dtype), c[rows, slot])


def kv_seq_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int, chunk: int, mesh
                     ) -> torch.Tensor:
    """Softmax attention of ``q`` (B, S, H, D) over keys split over
    ``model`` by sequence: this rank's ``k``, ``v`` (B, T, KV, D) at
    absolute positions ``k_pos`` (T,), a contiguous slice of the whole
    cache.  ``layers.flash_attention``'s pass over the whole cache, chunk by
    chunk: ``n`` chunks of ``chunk`` keys (one chunk of every key for a
    short query, ``s <= 8``; a chunk may span several ranks' slices, a slice
    several chunks).

    Each rank takes its keys' max in each chunk; one max all-reduce of the
    (n, ...) maxima gives each chunk's max, and a running max over them the
    unsharded pass's ``m_new`` of each chunk.  Each rank then sums its keys'
    ``p = exp(score - m_new)`` and float32 ``p @ v`` per chunk (``p``
    rounded to q's dtype as there; a chunk whole on the rank takes the
    unsharded pass's own product); sum all-reduces of the partials, at most
    ``KV_PART_BYTES`` of them at once, give every rank each chunk's ``l``
    and ``p @ v``, rounded to q's dtype once as the unsharded product is,
    and every rank runs the unsharded pass's rescaling over the chunks in
    order.  Only the order of the float32 sums over a chunk's keys differs
    from the unsharded step's.  Returns (B, S, H, D) in q's dtype; a query
    that sees no key gives 0."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qg = q.reshape(b, s, kvh, g, d)
    whole = t * mesh.size(MODEL)
    if s <= 8 or whole <= chunk:
        chunk = whole
    lo = mesh.index(MODEL) * t  # this rank's first position
    n = -(-whole // chunk)
    # this rank's keys of chunk j: [max(j*chunk, lo), min((j+1)*chunk, lo+t)) - lo
    spans = [(max(j * chunk - lo, 0), min((j + 1) * chunk - lo, t)) for j in range(n)]
    kept = {}  # one chunk: its scores, computed once

    def scores(j):
        if j in kept:
            return kept[j]
        a, e = spans[j]
        sc = _masked_scores(qg, k[:, a:e], k_pos[a:e], q_pos, scale, causal=causal,
                            window=window)
        if n == 1:
            kept[j] = sc
        return sc

    m = torch.full((n, b, kvh, g, s), -torch.inf, dtype=F32, device=dev)
    for j, (a, e) in enumerate(spans):
        if e > a:
            m[j] = scores(j).amax(dim=-1)
    m = torch.cummax(coll.all_reduce(m, mesh, MODEL, "max"), dim=0).values
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    width = kvh * g * d
    group = max(1, KV_PART_BYTES // (b * s * (width + kvh * g) * 4))
    l_prev = acc = m_prev = None
    for j0 in range(0, n, group):
        part = torch.zeros((min(group, n - j0), b, s, width + kvh * g), dtype=F32, device=dev)
        for j in range(j0, j0 + part.shape[0]):
            a, e = spans[j]
            if e <= a:
                continue
            sc = scores(j)
            p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe[j][..., None]), 0.0)
            if e - a == chunk:  # the whole chunk on this rank: the unsharded product itself
                pv = torch.einsum("bkgsc,bckd->bskgd", p.to(q.dtype), v[:, a:e]).to(F32)
            else:
                pv = torch.einsum("bkgsc,bckd->bskgd", p.to(q.dtype).to(F32),
                                  v[:, a:e].to(F32))
            lt = p.sum(dim=-1).permute(0, 3, 1, 2).reshape(b, s, kvh * g)
            part[j - j0] = torch.cat([pv.reshape(b, s, -1), lt], -1)
        part = coll.all_reduce(part, mesh, MODEL)
        for i, j in enumerate(range(j0, j0 + part.shape[0])):
            lj = part[i, ..., width:].reshape(b, s, kvh, g)
            # p @ v rounded once to q's dtype, as the unsharded product returns it
            pv = part[i, ..., :width].to(q.dtype).to(F32).reshape(b, s, kvh, g, d)
            if m_prev is None:
                l_prev, acc = lj, pv
            else:
                corr = torch.exp(torch.where(torch.isfinite(m_prev), m_prev - m_safe[j],
                                             -torch.inf))
                corr = torch.where(torch.isfinite(corr), corr, 0.0).permute(0, 3, 1, 2)
                l_prev = l_prev * corr + lj
                acc = acc * corr[..., None] + pv
            m_prev = m[j]
    out = acc / torch.clamp(l_prev, min=1e-20)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def _masked_scores(qg, kc, kp, q_pos, scale, *, causal: bool, window: int) -> torch.Tensor:
    """The scaled float32 scores (B, KV, G, S, C) of ``qg`` (B, S, KV, G, D)
    against keys ``kc`` (B, C, KV, D) at positions ``kp`` (C,), -inf where
    masked."""
    s = qg.shape[1]
    sc = torch.einsum("bskgd,bckd->bkgsc", qg, kc).to(F32) * scale
    if causal:
        ok = kp[None, None, :] <= q_pos[..., None]
    else:
        ok = torch.ones((1, s, kp.shape[0]), dtype=torch.bool, device=qg.device)
    if window:
        ok = ok & (kp[None, None, :] > q_pos[..., None] - window)
    return torch.where(ok[:, None, None], sc, -torch.inf)


def cached_attention(p: dict, x: torch.Tensor, cfg, mesh, positions, cache, index
                     ) -> torch.Tensor:
    """``layers.attention`` with a KV cache (written in place at ``index``)
    whose sequence is split over ``model`` (this rank's slices ``cache`` =
    (k, v), (B, S_l, KV, hd), bf16 or int8 at ``layers.KV_CACHE_SCALE``):
    every head's q, k and v on every rank, each rank writes the new
    positions it holds and attends over its keys, the partial softmaxes
    combine over ``model`` (:func:`kv_seq_attention`), and ``wo`` is
    row-parallel on the rank's heads (or whole).  ``positions`` None: no
    RoPE (Whisper)."""
    b, s, _ = x.shape
    hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q, k, v = _qkv_whole(p, _varying(x, mesh), cfg, mesh)
    q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, kvh, hd), v.reshape(b, s, kvh, hd)
    if positions is not None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    ck, cv = cache
    if ck.dtype == torch.int8:
        def q8(t):
            return torch.clamp(torch.round(t.to(F32) / layers.KV_CACHE_SCALE), -127,
                               127).to(torch.int8)

        write_local(ck, q8(k), index, mesh)
        write_local(cv, q8(v), index, mesh)
        k = (ck.to(F32) * layers.KV_CACHE_SCALE).to(q.dtype)
        v = (cv.to(F32) * layers.KV_CACHE_SCALE).to(q.dtype)
    else:
        write_local(ck, k, index, mesh)
        write_local(cv, v, index, mesh)
        k, v = ck, cv
    sl = ck.shape[1]
    off = torch.as_tensor(index, dtype=torch.int64, device=x.device)
    ar = torch.arange(s, device=x.device)
    q_pos = off.reshape(-1, 1) + ar[None, :] if off.ndim else (off + ar)[None, :]
    k_pos = mesh.index(MODEL) * sl + torch.arange(sl, device=x.device)
    out = kv_seq_attention(q, k, v, q_pos, k_pos, causal=True, window=cfg.swa_window,
                           chunk=cfg.attn_chunk, mesh=mesh).reshape(b, s, h * hd)
    if w_dims(p["wo"])[0] == h * hd:
        return linear(p["wo"], out, cfg.quant, mesh)
    return _row(p["wo"], _slice(out, 2, mesh), cfg.quant, mesh)


def moe_serve(p: dict, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """The MoE FFN of a serving step on this rank's rows: ``moe_ffn_ep``'s
    body where the reference takes it (quantization off, experts that
    divide ``model``), on the ``seq`` slab where ``model`` splits the
    sequence and else on the rank's whole rows (the reference's
    ``spec_for`` drops a ``seq`` split that does not divide, so each
    ``model`` rank routes every token of its rows alone, on the capacity of
    its rows: a decode step); otherwise ``moe_ffn``'s global routing."""
    m, msize = cfg.moe, mesh.size(MODEL)
    if m.ep and msize > 1 and m.n_experts % msize == 0 and cfg.quant.mode == "none" \
            and x.shape[1] % msize:
        bl, s, d = x.shape
        router = _gathered(p["router"]["w"], m.n_experts, mesh)
        return moe_lib.ep_slab(p, x.reshape(bl * s, d), router, cfg, mesh).reshape(bl, s, d)
    return moe_ffn(p, x, cfg, mesh)


def _serve_layer(blk: dict, x: torch.Tensor, cfg, mesh, positions, cache, index):
    h = layers.rmsnorm(blk["ln1"], x, cfg.norm_eps)
    if cache is None:
        x = x + attention(blk["attn"], h, cfg, mesh, positions)
    else:
        x = x + cached_attention(blk["attn"], h, cfg, mesh, positions, cache, index)
    h = layers.rmsnorm(blk["ln2"], x, cfg.norm_eps)
    if cfg.moe.n_experts:
        return x + moe_serve(blk["moe"], h, cfg, mesh)
    return x + mlp(blk["mlp"], h, cfg, mesh)


def serve_forward(params: dict, tokens, cfg, mesh, dev, *, cache=None, index=None,
                  prefix=None, specs=None):
    """The transformer families' forward on this rank's rows: the prefill
    (no cache: the rank's heads, as the training forward) or a decode or
    writing prefill into the rank's slice of a ``kv_seq``-split cache at
    ``index`` (:func:`cached_attention`).  ``prefix`` (B_local, P, D): the
    vlm's patches.  ``specs``: the params' specs in the 2-D serving mode.
    Returns the head's logits (the rank's vocab slice where the head is
    split) and whether they are split."""
    top = {k: v for k, v in params.items() if k != "blocks"}
    blocks, bspecs = params["blocks"], None
    if specs is not None:
        top = gather_2d(top, {k: specs[k] for k in top}, mesh)
        if data_split_dims(specs["blocks"], 1):  # layers split over data: gather them all
            blocks = gather_2d(blocks, specs["blocks"], mesh)
        else:
            bspecs = specs["blocks"]
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    x = embed(top["embed"], tok, cfg, mesh)
    if prefix is not None:
        x = torch.cat([torch.as_tensor(prefix, device=dev).to(x.dtype), x], dim=1)
    s = x.shape[1]
    base = torch.as_tensor(0 if index is None else index, device=dev)
    ar = torch.arange(s, device=dev)
    positions = base.reshape(-1, 1) + ar[None, :] if base.ndim else base + ar[None, :]
    for l, lcfg in enumerate(_layer_cfgs(cfg)):
        blk = gather_2d(layers.layer_params(blocks, l), bspecs, mesh, skip=1)
        c = None if cache is None else (cache["k"][l], cache["v"][l])
        x = _serve_layer(blk, x, lcfg, mesh, positions, c, base)
    x = layers.rmsnorm(top["ln_f"], x, cfg.norm_eps)
    return logits(top, x, cfg, mesh)


def serve_prefill(params: dict, tokens, extras: dict, cfg, mesh, dev, specs=None):
    """The prefill step on this rank (``serve_step.make_prefill`` with a
    mesh): logits (B_local, P + S, vocab or its rank's slice) and whether
    they are split by vocab."""
    if cfg.family in ("ssm", "hybrid", "encdec"):
        from . import sharded_rwkv6, sharded_whisper, sharded_zamba2

        _no_2d(cfg, specs)
        mod = {"ssm": sharded_rwkv6, "hybrid": sharded_zamba2, "encdec": sharded_whisper}
        return mod[cfg.family].serve_prefill(params, tokens, extras, cfg, mesh, dev)
    return serve_forward(params, tokens, cfg, mesh, dev, prefix=extras.get("patches"),
                         specs=specs)


def serve_decode(params: dict, tokens, cache: dict, index, extras: dict, cfg, mesh, dev,
                 specs=None):
    """One decode (or writing prefill) step on this rank: tokens (B_local,
    S_new) at ``index`` into this rank's slice of the cache, in its compute
    layout (``serve_step``).  Returns (logits, split, cache)."""
    if cfg.family in ("ssm", "hybrid", "encdec"):
        from . import sharded_rwkv6, sharded_whisper, sharded_zamba2

        _no_2d(cfg, specs)
        mod = {"ssm": sharded_rwkv6, "hybrid": sharded_zamba2, "encdec": sharded_whisper}
        return mod[cfg.family].serve_decode(params, tokens, cache, index, extras, cfg, mesh, dev)
    lg, split = serve_forward(params, tokens, cfg, mesh, dev, cache=cache, index=index,
                              specs=specs)
    return lg, split, cache


def _no_2d(cfg, specs) -> None:
    if specs is not None:
        raise NotImplementedError(f"the 2-D serving mode for the {cfg.family} family")
