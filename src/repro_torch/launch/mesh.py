"""Meshes: the production layouts (shape only) and a mesh over the running
process group's ranks.

Single pod: 16x16 = 256 chips, axes (data, model).
Multi-pod:  2x16x16 = 512 chips, axes (pod, data, model); the 'pod' axis
carries pure data parallelism across pods (the slice the gradient
compression targets).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production mesh, shape only (it names no ranks; it stands at rank
    0's coordinates).  ``device='meta'``: the dry run's counting mode."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)), device=device)


def make_host_mesh(model: int = 2, *, device=None) -> Mesh:
    """A (data, model) mesh over every rank of the running process group
    (``torch.distributed`` initialised by the caller), ``model`` ranks
    along 'model'.  ``device``: where this rank's tensors live (the CUDA
    card unless ``device='cpu'``)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"a world of {n} ranks has no (data, {model}) mesh")
    return Mesh.from_world((n // model, model), ("data", "model"), device=resolve_device(device))
