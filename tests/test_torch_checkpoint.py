"""The port's ``Checkpointer`` against the reference's.

``tests/test_checkpoint.py``'s roundtrip, async, LATEST and retention cases
on torch trees, plus interchange: a step directory written by the
reference's ``Checkpointer`` restores in the port bit for bit, and one
written by the port restores in the reference, on a tree with bf16, int8,
float32 and int32 leaves, nested dicts and lists.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.ckpt import tree_leaves, tree_unflatten


def _state(step=0):
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) + step,
                   "b": torch.ones((4,), dtype=torch.bfloat16) * step},
        "step": torch.tensor(step, dtype=torch.int32),
    }


def _mixed(seed=0):
    """bf16, int8, float32 and int32 leaves; nested dicts and a list."""
    rng = np.random.default_rng(seed)
    return {
        "blocks": {"attn": {"w_q": rng.integers(-128, 128, (2, 8, 6)).astype(np.int8),
                            "w_scale": rng.random((2, 1, 6)).astype(np.float32)},
                   "moe": {"w_up": rng.standard_normal((2, 4, 8, 3)).astype(np.float32)}},
        "opt": [rng.standard_normal((5,)).astype(np.float32),
                {"count": np.asarray(7, np.int32), "mu": rng.standard_normal((3, 2))
                 .astype(np.float32)}],
        "embed": rng.standard_normal((16, 8)).astype(np.float32),
    }


BF16 = ("moe", "embed")  # leaves held as bfloat16 in both packages


def _as_jax(tree):
    def conv(path, a):
        keys = [getattr(p, "key", None) for p in path]
        return jnp.asarray(a, jnp.bfloat16 if any(k in BF16 for k in keys) else a.dtype)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _as_torch(tree, device="cpu"):
    def walk(node, bf16=False):
        if isinstance(node, dict):
            return {k: walk(v, bf16 or k in BF16) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, bf16) for v in node]
        t = torch.from_numpy(np.array(node))
        return (t.to(torch.bfloat16) if bf16 else t).to(device)
    return walk(tree)


def _bits(a):
    """Raw bits of a leaf of either package, with its dtype name."""
    if isinstance(a, torch.Tensor):
        name = str(a.dtype).removeprefix("torch.")
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return name, a.cpu().numpy().tobytes(), tuple(a.shape)
    a = np.asarray(a)
    return str(a.dtype), a.tobytes(), a.shape


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    st = _state(7)
    ck.save(7, st)
    restored, step = ck.restore(_state(0))
    assert step == 7
    assert torch.equal(restored["params"]["w"], st["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], st["params"]["b"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7


def test_async_save_overlaps_and_completes(tmp_path):
    ck = Checkpointer(tmp_path)
    for s in (1, 2, 3):
        ck.save_async(s, _state(s))
    ck.wait()
    assert ck.latest_step() == 3
    assert ck._thread is None


def test_async_save_snapshots_at_the_call(tmp_path):
    """The state is copied before ``save_async`` returns: an in-place
    update right after it does not reach the file."""
    ck = Checkpointer(tmp_path)
    st = _state(4)
    ck.save_async(4, st)
    st["params"]["w"].add_(100.0)
    st["params"]["b"].fill_(9)
    ck.wait()
    restored, _ = ck.restore(_state(0))
    assert torch.equal(restored["params"]["w"], _state(4)["params"]["w"])
    assert torch.equal(restored["params"]["b"], _state(4)["params"]["b"])


def test_async_write_error_raises_at_wait(tmp_path, monkeypatch):
    ck = Checkpointer(tmp_path)
    monkeypatch.setattr(np, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    ck.save_async(1, _state(1))
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # raised once
    assert ck.latest_step() is None


def test_latest_points_to_committed_only(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _state(5))
    # a crash mid-save: a stale .tmp dir must not be visible
    tmp_dir = tmp_path / "step_000000009.tmp"
    tmp_dir.mkdir()
    (tmp_dir / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    _, step = ck.restore(_state(0))
    assert step == 5


def test_retention_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in range(6):
        ck.save(s, _state(s))
    dirs = sorted(p.name for p in tmp_path.glob("step_*") if p.is_dir())
    assert dirs == ["step_000000004", "step_000000005"]
    assert ck.latest_step() == 5
    restored, _ = ck.restore(_state(0), step=4)
    assert int(restored["step"]) == 4


def test_missing_checkpoint_and_mismatches_raise(tmp_path):
    ck = Checkpointer(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.restore(_state(0))
    ck.save(1, _state(1))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(0), step=2)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"params": _state(0)["params"]})
    bad = _state(0)
    bad["params"]["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)


def test_shardings_raise(tmp_path):
    """``restore(shardings=)`` takes one NamedSharding per leaf and raises on
    any other count; on a mesh of one rank every leaf comes back whole, on
    the mesh's device, from meta ``like`` leaves.  (Meshes of several ranks:
    ``test_torch_distributed.py``.)"""
    from repro_torch.parallel.sharding import Mesh, NamedSharding, P

    ck = Checkpointer(tmp_path)
    ck.save(1, _state(1))
    with pytest.raises(ValueError, match="shardings"):
        ck.restore(_state(0), shardings={"params": None})
    one = NamedSharding(Mesh({"data": 1, "model": 1}, device="cpu"), P("data", "model"))
    like = tree_unflatten(_state(0), [torch.empty(t.shape, dtype=t.dtype, device="meta")
                                      for t in tree_leaves(_state(0))])
    got, step = ck.restore(like, shardings=tree_unflatten(like, [one] * 3))
    assert step == 1
    for a, b in zip(tree_leaves(got), tree_leaves(_state(1))):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)


def test_manifest_matches_the_reference(tmp_path):
    """Leaf order, shapes and dtype strings of the manifest, and each leaf
    file's stored dtype, equal the reference's for the same tree."""
    Checkpointer(tmp_path / "port").save(3, _as_torch(_mixed()))
    JCheckpointer(tmp_path / "ref").save(3, _as_jax(_mixed()))
    got = json.loads((tmp_path / "port/step_000000003/manifest.json").read_text())
    want = json.loads((tmp_path / "ref/step_000000003/manifest.json").read_text())
    assert got["step"] == want["step"] == 3
    assert got["leaves"] == want["leaves"]
    assert {leaf["dtype"] for leaf in got["leaves"]} == {"bfloat16", "int8", "float32", "int32"}
    for i in range(len(got["leaves"])):
        a = np.load(tmp_path / f"port/step_000000003/leaf_{i:05d}.npy")
        b = np.load(tmp_path / f"ref/step_000000003/leaf_{i:05d}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
    assert (tmp_path / "port/LATEST").read_text() == (tmp_path / "ref/LATEST").read_text()


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    JCheckpointer(tmp_path).save(12, _as_jax(_mixed(1)))
    like = _as_torch(_mixed(0))
    restored, step = Checkpointer(tmp_path).restore(like)
    assert step == 12
    want = _as_torch(_mixed(1))
    assert [_bits(a) for a in tree_leaves(restored)] == [_bits(a) for a in tree_leaves(want)]
    assert isinstance(restored["opt"], list) and restored["embed"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(8, _as_torch(_mixed(2)))
    ck.wait()
    restored, step = JCheckpointer(tmp_path).restore(jax.eval_shape(lambda: _as_jax(_mixed(0))))
    assert step == 8
    want = _as_jax(_mixed(2))
    assert [_bits(a) for a in jax.tree.leaves(restored)] == \
        [_bits(a) for a in jax.tree.leaves(want)]


def test_restore_into_numpy_leaves(tmp_path):
    """numpy ``like`` leaves come back as numpy of their dtype (bf16 values
    widened exactly to the like leaf's float32)."""
    Checkpointer(tmp_path).save(2, _as_torch(_mixed(3)))
    restored, _ = Checkpointer(tmp_path).restore(_mixed(0))
    want = _mixed(3)
    for a, b, path in zip(tree_leaves(restored), tree_leaves(want),
                          range(len(tree_leaves(want)))):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
    np.testing.assert_array_equal(restored["blocks"]["attn"]["w_q"],
                                  want["blocks"]["attn"]["w_q"])
    bf = torch.from_numpy(want["embed"]).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(restored["embed"], bf)


def test_tree_walk_is_jax_order():
    tree = {"b": [np.zeros(1), (np.ones(2), None)], "a": {"z": np.zeros(3), "y": np.ones(4)}}
    leaves = tree_leaves(tree)
    assert [a.shape for a in leaves] == [a.shape for a in jax.tree.leaves(tree)]
    rebuilt = tree_unflatten(tree, leaves)
    assert list(rebuilt) == ["b", "a"] and isinstance(rebuilt["b"][1], tuple)
    assert rebuilt["b"][1][1] is None
    with pytest.raises(ValueError):
        tree_unflatten(tree, leaves + [np.zeros(1)])
