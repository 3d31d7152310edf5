"""The manifest, the generators and the operation counts, on the CPU."""
import json
import re

import numpy as np
import pytest

from perfbench import traffic
from perfbench.harness import ROOT, applies
from perfbench.reference import unet_seg as ref
from perfbench.roofline import HBM_BYTES_PER_S, INT8_OPS_PER_S
from perfbench.roofline import mma_tc_horner_kernel as mma

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|experts_per|"
                   r"d_model|d_ff|base|width")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(MAN) == KEYS["top"]
    assert len(json.dumps(MAN)) <= 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == KEYS["cell"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for group in (names, [c["name"] for c in MAN["configs"]], [w["name"] for w in MAN["workloads"]]):
        assert len(group) == len(set(group))


def test_paths_command_and_files():
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 runs a cell
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "perfbench" / "runners" / f"{conf['runner']}.py").is_file()
    for w in MAN["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MAN["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_enough_and_moves_name_a_reported_metric():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for w in cells:
        reported = [m["name"] for m in MAN["end_to_end"] if applies(m, w)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(applies(m, w) for m in MAN["per_layer"])
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", cells):
            assert applies(e2e[m["moves"]], w), (m["name"], w)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_four_chip_share():
    four = sum(1 for w in MAN["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("mix", ["brats_c8", "brats_crop_c8"])
def test_images_repeat_for_a_seed(mix):
    spec = traffic.load(mix)
    a, b = traffic.ImageStream(spec, 2**31 + 99), traffic.ImageStream(spec, 2**31 + 99)
    other = traffic.ImageStream(spec, 2**31 + 100)
    for i in (0, 5):
        x = a[i]
        assert x.dtype == np.float32 and x.shape[2] == 4
        assert np.array_equal(x, b[i])
        assert not np.array_equal(x, other[i]) or x.shape != other[i].shape
        brain = x[..., 0] != 0
        assert 0.2 < brain.mean() < 1.0
        assert abs(float(x[brain].mean())) < 0.2 and 0.8 < float(x[brain].std()) < 1.2
    assert a[spec["pool_images"] + 3] is a[3]  # the window cycles through one drawn pool
    sizes = {a[i].shape[:2] for i in range(12)}
    if spec["image"]["crop_to_brain"]:
        assert len(sizes) > 6 and all(136 <= h <= 200 and 136 <= w <= 200 for h, w in sizes)
    else:
        assert sizes == {(240, 240)}


def test_tokens_repeat_for_a_seed():
    mix = traffic.load("qat_b8s512")
    a = traffic.token_batch(mix, 2**31 + 5, 3, 64000)
    assert a.shape == (4, 2, 513) and a.dtype == np.int64 and 0 <= a.min() and a.max() < 64000
    assert np.array_equal(a, traffic.token_batch(mix, 2**31 + 5, 3, 64000))
    assert not np.array_equal(a, traffic.token_batch(mix, 2**31 + 5, 4, 64000))


@pytest.mark.parametrize("m, k, n, ops, nbytes", [
    # the U-Net's first conv over a micro-batch of 32 full 80x80 windows
    (32 * 80 * 80, 9 * 4, 48, 2 * 204800 * 36 * 48, 204800 * 36 + 36 * 48 + 4 * 204800 * 48),
    # Yi-6B's w_up at a training microbatch of 1,024 tokens
    (1024, 4096, 11008, 2 * 1024 * 4096 * 11008, 1024 * 4096 + 4096 * 11008 + 4 * 1024 * 11008),
])
def test_roofline_counts_by_hand(m, k, n, ops, nbytes):
    assert mma.ops(m, k, n) == ops and mma.nbytes(m, k, n) == nbytes
    want = max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
    assert mma.least_seconds_of(m, k, n) == want
    assert mma.is_launch("void (anonymous namespace)::mma_tc_horner_kernel<5, true, 64>(signed "
                         "char const*, signed char const*, int*, int, int, int, int, int)")
    assert not mma.is_launch("void (anonymous namespace)::mma_tc_scaled_kernel<5, true, 1>(x)")


def test_unet_counts_by_hand():
    # the calibrated geometry at 80 x 80: 7 convs (3 down, the bottleneck, 3 up)
    layers = ref.conv_layers(80, 80, 4, 48, 3, 1)
    assert layers == [(80, 80, 4, 48), (40, 40, 48, 96), (20, 20, 96, 192), (10, 10, 192, 384),
                      (20, 20, 576, 192), (40, 40, 288, 96), (80, 80, 144, 48)]
    assert ref.halo(3, 1) == 24
    ph, pw, tiles = ref.tiles_of(240, 240, 3, 32, 24)
    assert (ph, pw, len(tiles)) == (240, 240, 64)
    assert sum(1 for (y0, x0, y1, x1), _ in tiles if (y1 - y0, x1 - x0) == (80, 80)) == 25
    # 2 x 9 x (H x W) x Cin x Cout per conv at 240 x 240
    by_hand = (2 * 9 * (57600 * 4 * 48 + 14400 * 48 * 96 + 3600 * 96 * 192 + 900 * 192 * 384
                        + 3600 * 576 * 192 + 14400 * 288 * 96 + 57600 * 144 * 48))
    assert ref.useful_ops(240, 240, 4, 48, 3, 1) == by_hand == 25_281_331_200
