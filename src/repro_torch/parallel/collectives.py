"""The collectives the port's sharded modules call where GSPMD communicates
in the reference: all-reduce (sum, max), all-gather, reduce-scatter,
all-to-all and a send/recv permutation (``ppermute``), over one or more
axes of a :class:`~repro_torch.parallel.sharding.Mesh`.

Gradients follow the Megatron convention.  A value every rank of a group
holds alike is *replicated*, and its gradient on each rank is the whole
gradient; a value that differs by rank is *varying*, and its gradient on
each rank is that rank's share.  So:

- ``all_reduce`` (sum) makes a varying value replicated; its transpose is
  the identity.  ``pbroadcast`` marks a replicated value for varying use;
  its transpose is the sum all-reduce.  (A max all-reduce carries no
  gradient.)
- ``all_gather``'s output is for varying use, and its transpose is
  ``reduce_scatter``; ``reduce_scatter``'s is ``all_gather``.  With
  ``replicated=True`` the output is for replicated use (every rank's
  consumers alike, its gradient whole on each rank), and the transpose
  keeps the rank's slice: no collective.
- ``all_to_all`` and ``ppermute`` transpose to their inverses.

Every call is counted on ``mesh.stats`` by kind, under the reference's HLO
names (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``), with its operand bytes, as
``launch.hlo_analysis.collective_stats`` counts a compiled program's:
:func:`collective_stats` returns them in that layout.  Beside them,
:func:`collective_seconds` gives the host seconds spent inside the
transport's calls by kind (for gloo the exchange itself, the staging copies
excluded).  A collective over axes of total size 1 is the identity and is
not counted.

Transport: a process group on NCCL takes the tensors where they are; on
gloo, a CUDA tensor is staged through pinned host memory (copied out,
reduced on the host, copied back), since gloo has no CUDA form of most of
these collectives.  The choice is made by the group's backend alone.

Counting mode: over a shape-only mesh (no ranks; ``sharding.Mesh`` with a
``coord``), every collective takes ``meta`` tensors, is counted as above
(the backward's too) and returns a ``meta`` tensor of its output's shape;
nothing is sent.  The dry run (``launch.dryrun``) counts one rank's step
this way.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .sharding import Mesh, axis_tuple

def _live(mesh: Mesh, axes) -> tuple[str, ...]:
    return tuple(a for a in axis_tuple(axes) if mesh.shape.get(a, 1) > 1)


def _record(mesh: Mesh, kind: str, t: torch.Tensor) -> None:
    for key, inc in (("counts_by_kind", 1), ("bytes_by_kind", t.numel() * t.element_size())):
        mesh.stats[key][kind] = mesh.stats[key].get(kind, 0) + inc


def _transport(mesh: Mesh, kind: str, fn, *args, **kw) -> None:
    t0 = time.perf_counter()
    fn(*args, **kw)
    secs = mesh.stats["seconds_by_kind"]
    secs[kind] = secs.get(kind, 0.0) + time.perf_counter() - t0


def collective_seconds(mesh: Mesh) -> dict:
    """Host seconds inside the transport's calls since the last
    :func:`reset_stats`, by kind."""
    return dict(mesh.stats["seconds_by_kind"])


def collective_stats(mesh: Mesh) -> dict:
    """The counts and operand bytes issued over ``mesh`` since the last
    :func:`reset_stats`, in ``hlo_analysis.collective_stats``'s layout."""
    b, c = dict(mesh.stats["bytes_by_kind"]), dict(mesh.stats["counts_by_kind"])
    return {"bytes_by_kind": b, "counts_by_kind": c, "total_bytes": int(sum(b.values())),
            "total_count": int(sum(c.values()))}


def reset_stats(mesh: Mesh) -> None:
    mesh.stats = {"bytes_by_kind": {}, "counts_by_kind": {}, "seconds_by_kind": {}}


def _staged(mesh: Mesh, axis: str, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group(axis)) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _counted(mesh: Mesh, x: torch.Tensor, dim: int = 0, scale=None) -> torch.Tensor | None:
    """Counting mode's output (``x``'s shape, ``dim`` scaled by ``scale``
    = (numerator, denominator)), or None where the mesh has ranks."""
    if mesh.has_ranks:
        return None
    if x.device.type != "meta":
        raise ValueError(f"a shape-only mesh counts collectives on meta tensors, not {x.device}")
    shape = list(x.shape)
    if scale is not None:
        shape[dim] = shape[dim] * scale[0] // scale[1]
    return torch.empty(shape, dtype=x.dtype, device=x.device)


# ------------------------------------------------------------ raw forms


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str) -> torch.Tensor:
    if (shaped := _counted(mesh, x)) is not None:
        return shaped
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    out = x.detach().clone()
    for a in axes:
        if _staged(mesh, a, out):
            h = _host(out)
            _transport(mesh, "all-reduce", dist.all_reduce, h, op=red, group=mesh.group(a))
            out.copy_(h)
        else:
            _transport(mesh, "all-reduce", dist.all_reduce, out, op=red, group=mesh.group(a))
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    if (shaped := _counted(mesh, x, dim, (mesh.size(axes), 1))) is not None:
        return shaped
    # the last axis is the minor one: gather it first
    out = x.detach()
    for a in reversed(axes):
        n = mesh.shape[a]
        src = out.movedim(dim, 0).contiguous()
        if _staged(mesh, a, src):
            src = _host(src)
        buf = src.new_empty((n * src.shape[0], *src.shape[1:]))
        _transport(mesh, "all-gather", dist.all_gather_into_tensor, buf, src,
                   group=mesh.group(a))
        out = buf.to(x.device).movedim(0, dim)
    return out.contiguous()


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    if (shaped := _counted(mesh, x, dim, (1, mesh.size(axes)))) is not None:
        return shaped
    out = x.detach()
    for a in axes:  # the major axis first
        n = mesh.shape[a]
        src = out.movedim(dim, 0).contiguous()
        if _staged(mesh, a, src):
            src = _host(src)
        buf = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _transport(mesh, "reduce-scatter", dist.reduce_scatter_tensor, buf, src,
                   group=mesh.group(a))
        out = buf.to(x.device).movedim(0, dim)
    return out.contiguous()


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if (shaped := _counted(mesh, x)) is not None:
        return shaped
    src = x.detach().contiguous()
    if _staged(mesh, axis, src):
        src = _host(src)
    buf = torch.empty_like(src)
    _transport(mesh, "all-to-all", dist.all_to_all_single, buf, src, group=mesh.group(axis))
    return buf.to(x.device)


def _ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    if (shaped := _counted(mesh, x)) is not None:
        return shaped
    me = mesh.index(axis)
    src = x.detach().contiguous()
    if _staged(mesh, axis, src):
        src = _host(src)
    buf = torch.zeros_like(src)

    def exchange():
        reqs = []
        for s, d in perm:
            if s == me:
                reqs.append(dist.isend(src, mesh.rank_at(**{axis: d})))
            if d == me:
                reqs.append(dist.irecv(buf, mesh.rank_at(**{axis: s})))
        for r in reqs:
            r.wait()

    _transport(mesh, "collective-permute", exchange)
    return buf.to(x.device)


# ------------------------------------------------------ autograd forms


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.mesh, "all-reduce", g)
        return _all_reduce(g, ctx.mesh, ctx.axes, "sum"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.mesh, "reduce-scatter", g)
        return _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllGatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * ctx.n, ctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.mesh, "all-gather", g)
        return _all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.mesh, "all-to-all", g)
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        _record(ctx.mesh, "collective-permute", g)
        inv = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.mesh, ctx.axis, inv), None, None, None


# ----------------------------------------------------------- public API


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str = "sum") -> torch.Tensor:
    """Sum (differentiable: see the module's docstring) or max (no
    gradient) of ``x`` over ``axes``."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduction {op!r}")
    axes = _live(mesh, axes)
    if not axes:
        return x
    _record(mesh, "all-reduce", x)
    if op == "max":
        return _all_reduce(x, mesh, axes, "max")
    return _AllReduceSum.apply(x, mesh, axes)


def pbroadcast(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x`` itself, marked for varying use over ``axes``: its gradient is
    summed over them (one all-reduce in the backward)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    return _PBroadcast.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0, *,
               replicated: bool = False) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order over
    ``axes`` (the first axis the major one); for varying use, or with
    ``replicated`` for replicated use (see the module's docstring)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    _record(mesh, "all-gather", x)
    fn = _AllGatherReplicated if replicated else _AllGather
    return fn.apply(x, mesh, axes, dim % x.ndim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, each rank keeping its slice along
    ``dim``."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    _record(mesh, "reduce-scatter", x)
    return _ReduceScatter.apply(x, mesh, axes, dim % x.ndim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` of leading dim ``mesh.shape[axis]``: slab j goes to rank j of
    the axis, and slab j of the output came from rank j (the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
    if not _live(mesh, axis):
        return x
    _record(mesh, "all-to-all", x)
    return _AllToAll.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """Send/recv along ``axis``: for each ``(src, dst)`` of ``perm`` rank
    ``src``'s ``x`` arrives at ``dst``; a rank nothing is sent to gets
    zeros (the reference's ``lax.ppermute``)."""
    if not _live(mesh, axis):
        return x
    perm = tuple((int(s), int(d)) for s, d in perm)
    _record(mesh, "collective-permute", x)
    return _PPermute.apply(x, mesh, axis, perm)
