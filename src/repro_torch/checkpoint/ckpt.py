"""Checkpoints of parameter trees: atomic, async, with retention; plus
crash-safe JSON documents next to the weights they describe.

Layout (one directory per step), the reference's own, so a step written by
either package restores in the other:

    <dir>/step_000000123/
        manifest.json     step, tree structure, per-leaf shape/dtype strings
        leaf_00000.npy    one file per leaf (np.save), in jax.tree.leaves order
    <dir>/LATEST          text file naming the last *committed* step dir

- **atomic commit**: a step is written to ``step_X.tmp`` and renamed into
  place; ``LATEST`` is replaced last, so a crash mid-save never moves the
  restore point.
- **async**: ``save_async`` copies every leaf to the host before it returns
  (so later in-place updates of the state do not reach the file) and writes
  the files on a worker thread; ``wait`` joins it and raises what it raised.
- **retention**: the last ``keep`` step directories are kept.
- dtypes numpy has no type for (bf16, fp8) are stored as raw unsigned views
  of the same width with the logical dtype's name in the manifest
  (``"bfloat16"``), and restored through a signed view into that torch
  dtype — numpy never needs to know it.

Trees are nested dicts, lists and tuples of torch tensors or numpy arrays;
dict keys are walked sorted, as ``jax.tree.leaves`` walks them.  A step
holds global arrays: a sharded state is gathered before it is saved
(``parallel.sharding.gather_tree``), and ``restore(shardings=)`` cuts each
restored leaf to this rank's slice on any mesh — the one it was saved
under or another (elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

_RAW_VIEW = {1: (np.uint8, torch.int8), 2: (np.uint16, torch.int16),
             4: (np.uint32, torch.int32), 8: (np.uint64, torch.int64)}
_NO_NUMPY_TYPE = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def save_json_atomic(path: str | os.PathLike, obj) -> Path:
    """Write a JSON document: serialize to ``<path>.tmp``, then rename it
    over ``path``, so a reader never sees a torn file.  Used for small
    sidecar artifacts (``repro_torch.autotune.TunedPlan``) that must be
    restorable next to the weights they describe."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj, indent=2, sort_keys=True) + "\n")
    os.rename(tmp, path)
    return path


def load_json(path: str | os.PathLike):
    """Read a document written by :func:`save_json_atomic`."""
    return json.loads(Path(path).read_text())


# ------------------------------------------------------------------ trees


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree.leaves`` order: dict values by
    sorted key, list and tuple items in order, ``None`` empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            if isinstance(node, list):
                return items
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _structure(tree) -> str:
    """The tree's structure with ``*`` for each leaf (the manifest's
    ``treedef``; restore does not read it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


# ------------------------------------------------------------------ leaves


def _to_host(a):
    """A host copy of one leaf: a CPU tensor (bf16 stays bf16) or a numpy
    array.  Always a copy, so the snapshot is the state at this call."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    return np.array(a, copy=True)


def _to_storable(a) -> tuple[np.ndarray, str]:
    """(array np.save can write, logical dtype name)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in _NO_NUMPY_TYPE:
            np_view, t_view = _RAW_VIEW[a.element_size()]
            return a.view(t_view).numpy().view(np_view), str(a.dtype).removeprefix("torch.")
        a = a.numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def _from_storable(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    if str(a.dtype) == dtype_str:
        return torch.from_numpy(a)
    dt = getattr(torch, dtype_str, None)
    if not isinstance(dt, torch.dtype) or dt.itemsize != a.dtype.itemsize:
        raise ValueError(f"cannot restore a leaf of dtype {dtype_str!r} stored as {a.dtype}")
    _, t_view = _RAW_VIEW[a.dtype.itemsize]
    return torch.from_numpy(a.view(np.dtype(str(t_view).removeprefix("torch.")))).view(dt)


def _like(t: torch.Tensor, ll, sharding=None):
    """The restored leaf ``t`` as ``ll`` is: its dtype and device (a tensor;
    with ``sharding``, this rank's slice on the sharding mesh's device) or
    its dtype (a numpy array)."""
    if sharding is not None:
        from repro_torch.parallel.sharding import shard

        return shard(t, sharding).to(device=sharding.mesh.device, dtype=ll.dtype)
    if isinstance(ll, torch.Tensor):
        return t.to(device=ll.device, dtype=ll.dtype)
    want = np.asarray(ll).dtype
    if t.dtype in _NO_NUMPY_TYPE:
        t = t.to(torch.float32)
    return t.numpy().astype(want)


def _manifest(tree, stored, step: int) -> dict:
    return {
        "step": step,
        "treedef": _structure(tree),
        "leaves": [{"shape": list(a.shape), "dtype": dt} for a, dt in stored],
    }


# ------------------------------------------------------------ checkpointer


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> Path:
        self.wait()
        return self._write(step, _host_tree(state))

    def save_async(self, step: int, state) -> None:
        """Snapshot to host now (the device-to-host copies); write on a
        worker thread."""
        self.wait()
        host = _host_tree(state)

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # handed to wait(), which raises it
                self._error = e

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending async write, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_state) -> Path:
        stored = [_to_storable(leaf) for leaf in tree_leaves(host_state)]
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, (arr, _) in enumerate(stored):
            np.save(tmp / f"leaf_{i:05d}.npy", arr)
        (tmp / "manifest.json").write_text(json.dumps(_manifest(host_state, stored, step)))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        (self.dir / "LATEST.tmp").write_text(final.name)
        os.rename(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._gc()
        return final

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        name = f.read_text().strip()
        if not (self.dir / name / "manifest.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, like, step: int | None = None, shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors or numpy
        arrays of the global shapes; meta tensors will do): each leaf takes
        its ``like`` leaf's dtype, and a tensor its device (a CUDA tensor
        comes back on the card).  ``shardings``: a tree of NamedShardings of
        the same structure; each leaf comes back as this rank's slice, on
        its mesh's device.  Returns ``(tree, step)``."""
        shard_leaves = [None] * len(tree_leaves(like)) if shardings is None \
            else tree_leaves(shardings)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        if not (d / "manifest.json").exists():
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.dir}")
        manifest = json.loads((d / "manifest.json").read_text())
        like_leaves = tree_leaves(like)
        if len(like_leaves) != len(manifest["leaves"]):
            raise ValueError(f"step {step} holds {len(manifest['leaves'])} leaves, "
                             f"the tree {len(like_leaves)}")
        leaves = []
        if len(shard_leaves) != len(like_leaves):
            raise ValueError(f"{len(shard_leaves)} shardings for {len(like_leaves)} leaves")
        for i, (ll, meta, sh) in enumerate(zip(like_leaves, manifest["leaves"], shard_leaves)):
            t = _from_storable(np.load(d / f"leaf_{i:05d}.npy"), meta["dtype"])
            if tuple(t.shape) != tuple(np.shape(ll)):
                raise ValueError(f"leaf {i}: stored shape {tuple(t.shape)}, the tree's "
                                 f"{tuple(np.shape(ll))}")
            leaves.append(_like(t, ll, sh))
        return tree_unflatten(like, leaves), step


def _host_tree(state):
    return tree_unflatten(state, [_to_host(a) for a in tree_leaves(state)])
