"""The port's parallel layer, pure functions, against the reference on the
CPU in this process: the sharding rules and ``spec_for`` (the reference on a
``jax.sharding.AbstractMesh``, which needs no devices), every config's
parameter specs at full size (the port's meta-device state against
``jax.eval_shape``), the train state's and batch's shardings, the production
meshes, ``bubble_fraction``, the collectives' identity on axes of size 1,
the serving launcher on the CPU, and the parallel modules' freedom from jax.

The ranks themselves are in ``test_torch_distributed.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.parallel import param_specs as jpspecs
from repro.parallel import pipeline as jpipeline
from repro.parallel import sharding as jshd
from repro.train import train_step as jts
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import param_specs as pspecs
from repro_torch.parallel import pipeline
from repro_torch.parallel import sharding as shd
from repro_torch.train import train_step as ts

from _hypothesis_compat import given, settings, st

SRC = Path(__file__).resolve().parent.parent / "src"
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


def _both(shape: dict):
    return shd.Mesh(shape), AbstractMesh(tuple(shape.values()), tuple(shape))


def _spec_pair(shape, logical, dims, rules=None):
    tm, jm = _both(shape)
    with shd.use_mesh(tm, rules):
        got = shd.spec_for(logical, dims)
    with jshd.use_mesh(jm, rules):
        want = jshd.spec_for(logical, dims)
    return tuple(got), tuple(want)


@pytest.mark.parametrize("logical,dims,expect", [
    (("batch", None, "heads"), (8, 3, 4), ("data", None, "model")),
    (("batch", None, "kv_heads"), (8, 3, 3), ("data", None, None)),  # 3 % 2: dropped
    (("heads", "ffn"), (4, 4), ("model", None)),  # an axis used once
])
def test_spec_for_equals_the_reference_on_its_cases(logical, dims, expect):
    got, want = _spec_pair(MESHES["4x2"], logical, dims)
    assert got == want == expect


NAMES = [None, *sorted(shd.DEFAULT_RULES)]


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_spec_for_equals_the_reference_swept(data):
    axes = data.draw(st.sampled_from([("data", "model"), ("pod", "data", "model"), ("data",),
                                      ("model",), ("pod", "model")]))
    shape = {a: data.draw(st.sampled_from([1, 2, 3, 4, 8, 16])) for a in axes}
    n = data.draw(st.integers(0, 4))
    logical = tuple(data.draw(st.sampled_from(NAMES)) for _ in range(n))
    dims = tuple(data.draw(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64])) for _ in range(n))
    rules = data.draw(st.sampled_from([None, shd.EP_DP_RULES]))
    got, want = _spec_pair(shape, logical, dims, rules)
    assert got == want
    # and with no shape: no divisibility check
    got, want = _spec_pair(shape, logical, None, rules)
    assert got == want


def test_rule_sets_equal_the_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.EP_DP_RULES == jshd.EP_DP_RULES
    assert shd.RULE_SETS.keys() == jshd.RULE_SETS.keys()
    assert pspecs.ROW_PARALLEL_NAMES == jpspecs.ROW_PARALLEL_NAMES


def _jleaves(tree):
    return {jpspecs._path_str(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _tleaves(tree, path=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _tleaves(v, (*path, k)).items()}
    return {pspecs._path_str(path): tree}


@pytest.fixture(scope="module")
def abstract_params():
    """Every config's full-size parameter tree: the port's on the meta
    device and the reference's ``eval_shape``."""
    out = {}
    for arch in ARCH_IDS:
        tp = ts.abstract_state(get_config(arch))["params"]
        jp = jts.abstract_state(jget_config(arch))["params"]
        out[arch] = (get_config(arch), _tleaves(tp), _jleaves(jp))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_is_meta_and_shaped_as_the_reference(abstract_params, arch):
    _, tp, jp = abstract_params[arch]
    assert sorted(tp) == sorted(jp)
    for k, leaf in tp.items():
        assert leaf.device.type == "meta", k
        assert tuple(leaf.shape) == tuple(jp[k].shape), k
        assert str(leaf.dtype).removeprefix("torch.") == str(jp[k].dtype), k


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(abstract_params, arch, mesh_name):
    cfg, tp, jp = abstract_params[arch]
    jcfg = jget_config(arch)
    tm, jm = _both(MESHES[mesh_name])
    got = _tleaves(pspecs.named_shardings(ts.abstract_state(cfg)["params"], cfg, tm))
    logical = _tleaves(pspecs.param_logical(ts.abstract_state(cfg)["params"], cfg))
    unresolved = _tleaves(pspecs.param_specs(ts.abstract_state(cfg)["params"], cfg))
    rules = jshd.RULE_SETS.get(jcfg.shard_rules, jshd.DEFAULT_RULES)
    for k, leaf in jp.items():
        want_logical = jpspecs.logical_for_leaf(k, leaf.shape, jcfg)
        assert logical[k] == want_logical, k
        assert tuple(unresolved[k]) == want_logical, k
        with jshd.use_mesh(jm, rules):
            want = jshd.spec_for(want_logical, leaf.shape)
        assert got[k].mesh is tm and tuple(got[k].spec) == tuple(want), (k, got[k].spec, want)


def test_yi_specs_on_the_reference_tests_mesh():
    """``test_distributed.py``'s param-spec cases on the smoke model."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("yi_6b")
    sh = pspecs.named_shardings(ts.abstract_state(cfg)["params"], cfg, shd.Mesh(MESHES["4x2"]))
    assert tuple(sh["blocks"]["attn"]["wq"]["w"].spec) == (None, None, "model")
    assert tuple(sh["blocks"]["attn"]["wo"]["w"].spec) == (None, "model", None)
    assert tuple(sh["embed"]["table"].spec) == ("model", None)


@pytest.mark.parametrize("mb_leading", [False, True])
def test_batch_and_state_shardings_equal_the_reference(mb_leading):
    from repro.configs import get_smoke_config as jget_smoke
    from repro_torch.configs import get_smoke_config

    tm, jm = _both(MESHES["2x16x16"])
    shape = (4, 32, 65) if mb_leading else (32, 65)
    with shd.use_mesh(tm):
        got = ts.batch_shardings({"tokens": torch.empty(shape, device="meta")}, tm, mb_leading)
    with jshd.use_mesh(jm):
        want = jts.batch_shardings({"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}, jm,
                                   mb_leading)
    assert tuple(got["tokens"].spec) == tuple(want["tokens"].spec)
    cfg, jcfg = get_smoke_config("yi_6b"), jget_smoke("yi_6b")
    st = ts.state_shardings(ts.abstract_state(cfg), cfg, tm)
    jst = jts.state_shardings(jts.abstract_state(jcfg), jcfg, jm)
    assert tuple(st["opt"].step.spec) == tuple(jst["opt"].step.spec) == ()
    for part in ("master", "m", "v"):
        got_p = [tuple(s.spec) for s in tree_leaves(getattr(st["opt"], part))]
        assert got_p == [tuple(s.spec) for s in tree_leaves(st["params"])]
        assert got_p == [tuple(s.spec) for s in jax.tree.leaves(
            getattr(jst["opt"], part), is_leaf=lambda x: hasattr(x, "spec"))]


def test_production_meshes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    m = tmesh.make_production_mesh(multi_pod=True)
    assert list(m.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert not m.has_ranks and m.size(("pod", "data")) == 32 and m.size(None) == 1


def test_named_sharding_needs_a_mesh_and_constrain_is_the_identity():
    with pytest.raises(RuntimeError):
        shd.named_sharding("batch", shape=(8,))
    x = torch.randn(4, 8)
    with shd.use_mesh(shd.Mesh(MESHES["4x2"])):
        assert shd.constrain(x, "batch", "embed") is x
        assert shd.current_mesh().shape == MESHES["4x2"]
        sh = shd.named_sharding("batch", None, shape=(8, 3))
        assert tuple(sh.spec) == ("data", None)
        specs = shd.tree_specs({"a": ("batch", "vocab")}, {"a": torch.empty(8, 6, device="meta")})
        assert tuple(specs["a"].spec) == ("data", "model")
    assert shd.current_mesh() is None and shd.active_rules() == shd.DEFAULT_RULES


def test_collectives_over_size_one_axes_are_the_identity():
    m = shd.Mesh({"data": 1, "model": 1})
    x = torch.randn(3, 4)
    assert coll.all_reduce(x, m, "model") is x
    assert coll.all_reduce(x, m, ("data", "model"), "max") is x
    assert coll.all_gather(x, m, "data", dim=1) is x
    assert coll.reduce_scatter(x, m, "model") is x
    assert coll.all_to_all(x, m, "model") is x
    assert coll.ppermute(x, m, "model", [(0, 0)]) is x
    assert coll.pbroadcast(x, m, "model") is x
    assert coll.collective_stats(m) == {"bytes_by_kind": {}, "counts_by_kind": {},
                                        "total_bytes": 0, "total_count": 0}
    with pytest.raises(ValueError):
        coll.all_reduce(x, m, "model", "min")


@pytest.mark.parametrize("s,t,chunk", [(4, 96, 32), (40, 64, 64), (40, 128, 32),
                                         (12, 96, 16)])
def test_kv_seq_attention_on_one_rank_equals_flash_attention(s, t, chunk, monkeypatch):
    """``sharded_lm.kv_seq_attention`` on a one-rank mesh (every chunk whole
    on the rank, no collective) against ``layers.flash_attention``, bit for
    bit: the short-query pass, one chunk, and several chunks, these also with
    the partials reduced one chunk at a time (``KV_PART_BYTES``)."""
    from repro_torch.models import layers
    from repro_torch.parallel import sharded_lm

    g = torch.Generator().manual_seed(s * t + chunk)
    q, k, v = (torch.randn((2, n, 4, 16), generator=g).to(torch.bfloat16)
               for n in (s, t, t))
    off = t - s
    mesh = shd.Mesh({"data": 1, "model": 1})

    def run():
        return sharded_lm.kv_seq_attention(q, k, v, off + torch.arange(s)[None],
                                           torch.arange(t), causal=True, window=0,
                                           chunk=chunk, mesh=mesh)

    want = layers.flash_attention(q, k, v, causal=True, chunk=chunk, q_offset=off)
    got = run()
    assert torch.equal(got, want)
    monkeypatch.setattr(sharded_lm, "KV_PART_BYTES", 1)
    assert torch.equal(run(), got)


@pytest.mark.parametrize("s,m", [(2, 2), (2, 4), (4, 8), (16, 1), (1, 3)])
def test_bubble_fraction_equals_the_reference(s, m):
    assert pipeline.bubble_fraction(s, m) == jpipeline.bubble_fraction(s, m)


@pytest.mark.parametrize("argv", [[], ["--quant", "mma_int8", "--planes", "6"]])
def test_serve_launcher_on_the_cpu(argv, capsys):
    torch.set_num_threads(2)
    done = launch_serve.main(["--device", "cpu", "--requests", "5", "--batch", "2",
                              "--max-seq", "32", "--max-new", "3", *argv])
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert r.done and len(r.out) == 3 and all(0 <= t < 512 for t in r.out)
    assert capsys.readouterr().out.count("req ") == 5


def test_parallel_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.parallel.sharding, repro_torch.parallel.param_specs\n"
            "import repro_torch.parallel.collectives, repro_torch.parallel.sharded_lm\n"
            "import repro_torch.parallel.pipeline\n"
            "import repro_torch.launch.mesh, repro_torch.launch.serve\n"
            "import repro_torch.train.train_step, repro_torch.optim.grad_compress\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('NO_JAX')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert "NO_JAX" in r.stdout, r.stdout + r.stderr


def test_rank_lock_is_held_by_one_process_at_a_time(tmp_path):
    """``_torch_ranks.rank_lock``, which the two 8-rank modules take: a
    second process blocks while this one holds it and gets it only after
    the release; the lock file stays, unlocked."""
    import time

    import _torch_ranks

    code = ("import sys, time\n"
            f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
            "import _torch_ranks\n"
            "print('waiting', flush=True)\n"
            f"with _torch_ranks.rank_lock({str(tmp_path)!r}):\n"
            "    print(time.monotonic(), flush=True)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with _torch_ranks.rank_lock(tmp_path):
        child = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
        try:
            assert child.stdout.readline().strip() == "waiting", child.stderr.read()
            time.sleep(1.0)
            assert child.poll() is None  # still blocked on the lock
            released = time.monotonic()
        except BaseException:
            child.kill()
            raise
    out, err = child.communicate(timeout=60)
    assert child.returncode == 0, err
    assert float(out.strip()) >= released
    assert (tmp_path / _torch_ranks.LOCK_NAME).exists()
