"""Logical-axis sharding rules (DP / TP / EP / SP, plus the pod axis), the
port's device mesh, and placing trees of tensors onto it.

Models name their tensors' axes *logically*; a rule list (MaxText-style)
maps the logical names to mesh axes, as in the reference:

  batch        -> ("pod", "data")   data parallelism across pods and 'data'
  seq          -> "model"           sequence parallelism of the residual
  heads/kv_heads/q_heads -> "model" tensor parallelism inside attention
  ffn / experts -> "model"          TP for MLPs, EP for MoE experts
  vocab        -> "model"           sharded embedding and logits

A dim whose size the mapped axes do not divide is left unsharded (the
longest dividing prefix of the axis tuple is kept), an axis is used once
per tensor, and an axis the mesh lacks is dropped — so one rule set stays
valid for every architecture.

The reference hands its layouts to GSPMD, which inserts the collectives.
The port has no partitioner: its sharded modules (``parallel.sharded_lm``,
``parallel.pipeline``, ``models.moe.moe_ffn_ep``,
``optim.grad_compress.compressed_psum_shardmap``) compute on each rank's
shards and call ``parallel.collectives`` where GSPMD would communicate.
A :class:`PartitionSpec` here says which rank holds which slice of a
global tensor; :func:`shard_tree` cuts a global tree into this rank's
slices and :func:`gather_tree` puts them back together.

The active mesh is carried in a contextvar (set by :func:`use_mesh`), as
in the reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Sequence

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)
_RULES: contextvars.ContextVar = contextvars.ContextVar("rules", default=None)

# Default logical -> mesh-axis rules.  Values are a mesh axis name, a tuple of
# axis names, or None (replicated).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": "model",          # sequence parallelism on the residual stream
    "act_embed": None,
    "embed": None,
    "heads": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",  # decode: KV cache sharded along sequence
    "head_dim": None,
    "kv_head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_capacity": ("pod", "data"),  # EP: capacity dim carries the DP split
    "conv_window": None,
    "ssm_state": None,
    "unsharded": None,
}

# DeepSpeed-MoE-style layout for expert models: the model axis carries only
# experts; batch parallelism spans every axis.
EP_DP_RULES: dict[str, object] = {
    **DEFAULT_RULES,
    "batch": ("pod", "data", "model"),
    "seq": None,
    "heads": None,
    "q_heads": None,
    "kv_heads": None,
    "ffn": None,
    "vocab": None,
    "experts": "model",
    "expert_capacity": ("pod", "data"),
}

RULE_SETS = {"default": DEFAULT_RULES, "ep_dp": EP_DP_RULES}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (the dim split over those axes, the first the major one)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A device mesh: named axes with sizes (``shape``, in order) and, where
    ranks exist, this process's place on it with one process group per axis
    (from a ``torch.distributed.device_mesh.DeviceMesh``).  Without a
    device mesh it is shape only, the counterpart of
    ``jax.sharding.AbstractMesh``: enough to resolve specs and, on ``meta``
    tensors, to count what one rank's step would communicate
    (``parallel.collectives``' counting mode).  A shape-only mesh stands at
    ``coord`` (axis -> index; every axis 0 unless given).

    ``device`` is where this rank's tensors live.  ``stats`` counts the
    collectives issued over this mesh (``parallel.collectives``)."""

    def __init__(self, shape: dict[str, int], *, device_mesh=None, device=None, coord=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self.device = None if device is None else torch.device(device)
        self.coord = {a: 0 for a in self.axis_names}
        for a, i in (coord or {}).items():
            if a not in self.shape or not 0 <= i < self.shape[a]:
                raise ValueError(f"coordinate {a}={i} is off the mesh {self.shape}")
            self.coord[a] = int(i)
        self.stats = {"bytes_by_kind": {}, "counts_by_kind": {}, "seconds_by_kind": {}}

    @classmethod
    def from_world(cls, shape: Sequence[int], axis_names: Sequence[str], *, device):
        """The mesh over the running process group's world, ranks laid out
        row-major over ``shape``.  The device mesh's device type follows the
        process group's backend (NCCL: CUDA; gloo: CPU, whatever ``device``
        the tensors are on)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axis_names))
        return cls(dict(zip(axis_names, shape)), device_mesh=dm, device=device)

    @property
    def has_ranks(self) -> bool:
        return self.device_mesh is not None

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name, a tuple of names or
        None); an axis the mesh lacks counts 1."""
        return _axis_size(self, axes)

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis the major one."""
        idx = 0
        for a in axis_tuple(axes):
            if a in self.shape:
                idx = idx * self.shape[a] + self._local(a)
        return idx

    def _local(self, axis: str) -> int:
        if self.device_mesh is None:
            return self.coord[axis]
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (``rank_at(model=1)``)."""
        idx = tuple(coords.get(a, self.device_mesh.get_local_rank(a)) for a in self.axis_names)
        return int(self.device_mesh.mesh[idx])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}{', ranks' if self.has_ranks else ''})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: which slice of a global tensor each rank holds."""

    mesh: Mesh
    spec: PartitionSpec


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: dict | None = None):
    t1 = _MESH.set(mesh)
    t2 = _RULES.set({**DEFAULT_RULES, **(rules or {})})
    try:
        yield
    finally:
        _MESH.reset(t1)
        _RULES.reset(t2)


def current_mesh() -> Mesh | None:
    return _MESH.get()


def active_rules() -> dict:
    return _RULES.get() or DEFAULT_RULES


def axis_tuple(axes) -> tuple[str, ...]:
    """A spec entry or rule value (None, a name, a tuple of names) as a
    tuple of axis names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh: Mesh, axes) -> int:
    size = 1
    for a in axis_tuple(axes):
        size *= mesh.shape.get(a, 1)
    return size


def spec_for(logical: Sequence[str | None], shape: Sequence[int] | None = None) -> PartitionSpec:
    """Resolve logical names to a spec under the active mesh and rules,
    dropping any mapping that fails divisibility (when ``shape`` is given)
    or whose axis is absent from the mesh."""
    mesh = current_mesh()
    rules = active_rules()
    entries = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        axes = rules.get(name) if name else None
        if axes is None or mesh is None:
            entries.append(None)
            continue
        axes = tuple(a for a in axis_tuple(axes) if a in mesh.shape and a not in used)
        # the longest prefix of the axis tuple that divides the dim (batch 32
        # on ('pod', 'data', 'model') falls back to ('pod', 'data'))
        while axes and shape is not None and shape[i] % _axis_size(mesh, axes) != 0:
            axes = axes[:-1]
        if not axes:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes if len(axes) > 1 else axes[0])
    return P(*entries)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` unchanged.  The reference constrains GSPMD's layout here; the
    port has no partitioner, and its sharded modules lay their tensors out
    explicitly (see the module's docstring)."""
    return x


def named_sharding(*logical: str | None, shape: Sequence[int] | None = None) -> NamedSharding:
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("named_sharding requires an active mesh (use_mesh)")
    return NamedSharding(mesh, spec_for(logical, shape))


def tree_specs(logical_tree, shape_tree):
    """Map a tree of logical-name tuples and a tree of tensors (meta or
    real) of the same structure to NamedShardings under the active mesh."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("tree_specs requires an active mesh (use_mesh)")
    if isinstance(logical_tree, dict):
        return {k: tree_specs(logical_tree[k], shape_tree[k]) for k in logical_tree}
    return NamedSharding(mesh, spec_for(logical_tree, tuple(shape_tree.shape)))


# ----------------------------------------------------------- placing trees


def shard(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of the global tensor ``t`` (a contiguous copy where
    any dim is split, so that it does not keep ``t``'s storage alive; ``t``
    itself where none is)."""
    mesh, out = sharding.mesh, t
    for dim, entry in enumerate(sharding.spec):
        n = mesh.size(entry)
        if n > 1:
            size = out.shape[dim] // n
            out = out.narrow(dim, mesh.index(entry) * size, size)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The global tensor from every rank's slice ``t`` (a collective: every
    rank of the mesh calls it)."""
    from . import collectives

    for dim, entry in enumerate(sharding.spec):
        if sharding.mesh.size(entry) > 1:
            t = collectives.all_gather(t.detach(), sharding.mesh, entry, dim=dim)
    return t


def _map_pairs(fn, tree, shardings):
    from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten

    leaves, specs = tree_leaves(tree), tree_leaves(shardings)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} shardings")
    return tree_unflatten(tree, [fn(t, s) for t, s in zip(leaves, specs)])


def shard_tree(tree, shardings):
    """Every leaf of a global tree cut to this rank's slice by the
    NamedShardings of ``shardings`` (a tree of the same structure)."""
    return _map_pairs(shard, tree, shardings)


def gather_tree(tree, shardings):
    """The global tree from every rank's slices (every rank calls it)."""
    return _map_pairs(gather, tree, shardings)
