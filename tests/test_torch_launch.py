"""The port's dry-run tooling (``launch/{hlo_analysis,specs,dryrun,dryrun_pp}``
and ``serve_step.cache_shardings``) against the reference.

The reference's side is one subprocess (``_ref_specs.py``: 512 forced host
devices, ``JAX_PLATFORMS=cpu``) that builds every cell's bookkeeping with
``repro.launch.specs.build_cell`` and compiles one small 8-device program
for its HLO text; it lowers no cell.  Every comparison is exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.launch import hlo_analysis as ref_ha
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig, cells
from repro_torch.launch import dryrun, dryrun_pp, hlo_analysis, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.serve import serve_step as ss

from test_launch import SAMPLE_HLO

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
# the reference's roofline peaks (TPU v5e), passed in to hold the formula
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
MESHES = (("16_16", False), ("2_16_16", True))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(path.parent)), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, str(TESTS / "_ref_specs.py"), str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "REF_OK" in run.stdout, run.stderr[-4000:]
    return json.loads(path.read_text())


def test_collective_parser_equals_the_reference_on_the_sample():
    got = hlo_analysis.collective_stats(SAMPLE_HLO)
    assert got == ref_ha.collective_stats(SAMPLE_HLO)
    assert got["total_count"] == 5


def test_collective_parser_equals_the_reference_on_a_compiled_program(ref):
    text = ref["__hlo__"]
    got = hlo_analysis.collective_stats(text)
    assert got == ref_ha.collective_stats(text)
    assert got["counts_by_kind"] == {"all-reduce": 1, "all-gather": 1, "collective-permute": 1}
    assert hlo_analysis.remat_census(text) == ref_ha.remat_census(text)


@pytest.mark.parametrize("flops,nbytes,coll", [(197e12, 819e9, 0.0), (1e12, 1e9, 500e9),
                                               (3e15, 2e12, 1e9)])
def test_roofline_equals_the_reference_with_its_peaks(flops, nbytes, coll):
    assert hlo_analysis.roofline(flops, nbytes, coll, **V5E) == ref_ha.roofline(flops, nbytes, coll)
    h100 = hlo_analysis.roofline(flops, nbytes, coll)
    assert h100["compute_s"] == flops / 989e12 and h100["memory_s"] == nbytes / 3.35e12
    assert h100["collective_s"] == coll / 900e9


@pytest.mark.parametrize("kind,kw", [
    ("train", dict(w_bytes=1e9, opt_bytes=6e9, resid_bytes=1e8, n_layers=32, logits_bytes=1e9,
                   microbatches=4)),
    ("prefill", dict(w_bytes=4e8, resid_bytes=3e7, n_layers=24, cache_bytes=2e9,
                     logits_bytes=5e8)),
    ("decode", dict(w_bytes=4e8, cache_bytes=1e9, logits_bytes=1e6, n_layers=24)),
])
def test_analytic_hbm_bytes_equal_the_reference(kind, kw):
    assert hlo_analysis.analytic_hbm_bytes(kind, **kw) == ref_ha.analytic_hbm_bytes(kind, **kw)


def test_no_tpu_figure_in_the_port():
    text = (SRC / "repro_torch" / "launch" / "hlo_analysis.py").read_text()
    for figure in ("197e12", "819e9", "50e9", "v5e"):
        assert figure not in text


def _cells():
    """The reference's cells: its architectures (the port's training-only
    Moonlight-16B-A3B has no counterpart there) at each shape and mesh."""
    return [(a, s, tag, mp) for tag, mp in MESHES for a in REF_ARCH_IDS for s in cells(a)]


def test_every_cells_bookkeeping_equals_the_reference(ref):
    """params, active params, tokens, serving mode and every analytic-memory
    input of all 66 cells, exactly."""
    assert len(_cells()) == 66
    for arch, shape, tag, mp in _cells():
        cell = specs.build_cell(get_config(arch), shape, make_production_mesh(multi_pod=mp))
        want = ref[f"{arch}__{shape}__{tag}"]
        got = cell["meta"]
        assert cell["kind"] == want["kind"]
        for k in ("params", "active_params", "tokens", "mem_in"):
            assert got[k] == want[k], (arch, shape, tag, k)
        assert got.get("serve_mode") == want.get("serve_mode"), (arch, shape, tag)
    assert ref["dbrx_132b__decode_32k__16_16"]["serve_mode"] == "2d"
    assert ref["yi_6b__train_4k__16_16"]["mem_in"]["w_bytes"] == 758_128_640


def test_cache_shardings_equal_the_reference(ref):
    n = 0
    for arch, shape, tag, mp in _cells():
        sh = SHAPES[shape]
        if sh.kind != "decode":
            continue
        mesh = make_production_mesh(multi_pod=mp)
        cfg = get_config(arch)
        _, ab = ss.make_decode(cfg, sh.global_batch, sh.seq_len, device="meta")
        c_sh = ss.cache_shardings(ab, cfg, mesh, sh.global_batch, max_seq=sh.seq_len)
        got = [[list(t.shape), [list(e) if isinstance(e, tuple) else e for e in s.spec]]
               for t, s in zip(tree_leaves(ab), tree_leaves(c_sh))]
        assert got == ref[f"{arch}__{shape}__{tag}"]["cache"], (arch, shape, tag)
        n += 1
    assert n == 26


def test_build_cell_args_are_meta_and_fn_is_the_ports_step():
    mesh = make_production_mesh(device="meta")
    cell = specs.build_cell(get_config("olmoe_1b_7b"), "decode_32k", mesh)
    assert cell["kind"] == "decode" and cell["meta"]["serve_mode"] == "tp"
    assert all(t.device.type == "meta" for t in tree_leaves(cell["args"]))
    train = specs.build_cell(get_config("internvl2_76b"), "train_4k", mesh)
    assert sorted(train["args"][1]) == ["patches", "tokens"]
    assert train["args"][1]["patches"].shape == (8, 32, 256, 8192)
    assert "serve_mode" not in train["meta"]


@pytest.mark.parametrize("arch", ["yi_6b", "olmoe_1b_7b", "internvl2_76b"])
def test_depth_probes_equal_the_whole_count(arch):
    """The dry run's extrapolation from depths 1 and 2 gives the full-depth
    run's counts exactly (every layer issues the same products and
    collectives)."""
    cfg = get_smoke_config(arch).replace(n_layers=3, microbatches=2)
    mesh = shd.Mesh({"data": 4, "model": 2}, device="meta")
    batch = specs._train_batch_specs(cfg, ShapeConfig("t", 32, 16, "train"))
    whole = dryrun.count_train_step(cfg, mesh, batch)
    runs = [dryrun.count_train_step(cfg.replace(n_layers=n), mesh, batch) for n in (1, 2)]
    for key in ("census", "collectives"):
        f1, f2, fw = (dryrun._flat(r[key]) for r in (*runs, whole))
        assert {k: f1.get(k, 0) + (f2.get(k, 0) - f1.get(k, 0)) * 2 for k in f1.keys() | f2.keys()} \
            == fw
    assert whole["census"]["int8_products"] == 0 and whole["collectives"]["total_count"] > 0


def test_dryrun_writes_the_cells_json(tmp_path):
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--single-pod",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "olmoe_1b_7b", "--shape", "decode_32k", "--single-pod",
                        "--out", str(out)]) == 0
    r = json.loads((out / "yi_6b__train_4k__16_16.json").read_text())
    assert r["cost"]["flops"] > 0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["collectives_counted"] and r["cost"]["coll_bytes"] == r["collectives"]["total_bytes"] > 0
    assert r["params"] == 6_061_035_520 and r["chips"] == 256
    assert r["memory"]["argument_size_in_bytes"] > 0 and r["census"]["products"] > 0
    d = json.loads((out / "olmoe_1b_7b__decode_32k__16_16.json").read_text())
    # a serving cell is one rank's sharded decode step, counted as a train cell is
    assert d["cost"]["flops"] > 0 and d["collectives_counted"]
    assert d["cost"]["coll_bytes"] == d["collectives"]["total_bytes"] > 0
    assert d["flops_basis"] == "per-rank step"
    assert sorted(p.name for p in out.iterdir()) == ["olmoe_1b_7b__decode_32k__16_16.json",
                                                     "yi_6b__train_4k__16_16.json"]


@pytest.mark.parametrize("arch", ["whisper_large_v3", "zamba2_7b", "rwkv6_3b"])
def test_every_family_train_cell_counts_its_collectives(arch):
    """The ssm, hybrid and encdec train cells on 16x16 are counted as one
    rank's sharded step, as the other families' are: their collectives
    include the layers' all-reduces over 'model' (the gradient sync over
    the data axes issues one per parameter leaf, the loss and the norm a
    few, whatever the depth).  RWKV6's per-token loop on meta tensors makes
    its cell the slow one (about 4 minutes on one core)."""
    r = dryrun.run_cell(arch, "train_4k", multi_pod=False)
    assert r["collectives_counted"] and r["flops_basis"] == "per-rank step"
    n_leaves = len(tree_leaves(specs._abstract_params(get_config(arch))))
    assert r["collectives"]["counts_by_kind"]["all-reduce"] > n_leaves + 4
    assert r["cost"]["coll_bytes"] == r["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("arch,shape", [("yi_6b", "prefill_32k"), ("h2o_danube_3_4b", "long_500k"),
                                        ("zamba2_7b", "long_500k"), ("rwkv6_3b", "long_500k"),
                                        ("whisper_large_v3", "decode_32k"),
                                        ("dbrx_132b", "decode_32k")])
def test_serving_cells_count_their_collectives(arch, shape):
    """Prefill, decode and long cells on 16x16 are one rank's sharded
    serving step (``serve_step.make_prefill`` / ``make_decode`` with the
    mesh), counted on meta tensors: every layer's row-parallel all-reduces
    (and a decode's partial-softmax combine) over 'model'; dbrx's cells
    serve 2-D, whose weights are all-gathered over 'data' layer by layer.
    The per-rank FLOPs are under the whole step's over the model axis."""
    cfg = get_config(arch)
    r = dryrun.run_cell(arch, shape, multi_pod=False)
    assert r["collectives_counted"] and r["flops_basis"] == "per-rank step"
    assert r["cost"]["coll_bytes"] == r["collectives"]["total_bytes"] > 0
    counts = r["collectives"]["counts_by_kind"]
    assert counts["all-reduce"] >= 2 * cfg.n_layers
    if arch == "dbrx_132b":
        assert r["serve_mode"] == "2d" and counts["all-gather"] >= cfg.n_layers
    assert 0 < r["cost"]["flops"] and r["useful_flops_fraction"] > 0


def test_dryrun_pp_writes_its_json(tmp_path):
    assert dryrun_pp.main(["--n-micro", "4", "--out", str(tmp_path)]) == 0
    r = json.loads((tmp_path / "yi_6b__train_4k__16_16__pp.json").read_text())
    assert r["pp"] == 16 and r["dp"] == 16 and r["n_micro"] == 4 and r["global_batch"] == 64
    assert abs(r["bubble"] - 15 / 19) < 1e-12
    # 4 + 15 ticks of forward ring permutes, the backward's of all but the last
    assert r["collective_counts"]["collective-permute"] == 19 + 18
    assert r["flops_raw"] > 0 and r["compile_s"] is None


def test_launch_modules_import_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.launch.dryrun_pp, "
            "repro_torch.launch.specs; assert 'jax' not in sys.modules and "
            "'repro' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)[:5]")
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


def test_meta_product_is_an_int32_shape():
    from repro_torch.core import mma

    x = torch.empty((2, 5, 64), dtype=torch.int8, device="meta")
    w = torch.empty((64, 24), dtype=torch.int8, device="meta")
    for impl in ("kernel", "horner", "int8"):
        out = mma.mma_dot(x, w, impl=impl)
        assert out.device.type == "meta" and out.dtype == torch.int32 and out.shape == (2, 5, 24)
