"""Whole runs of both configurations at CPU sizes, in a copy of the benchmark
to which the small cells were added as new files and entries only: the
program against the plain reference, the lower-precision control and the
faults the comparison has to catch."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import calibrate, harness, testing


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small cells' many tiny operations slow down
    by far more than their share when other test processes oversubscribe
    the cores with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.smoke_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    # long enough that the small U-Net finishes slices on a loaded CPU
    return harness.run_cell(cell, 2**31 + 21, kw.pop("seconds", 8.0), kw.pop("trace", False),
                            root=root, device="cpu", **kw)


def test_added_cells_are_found_without_editing_a_file(root):
    for rel in ("perfbench/harness.py", "perfbench/traffic.py", "perfbench/runners/unet_seg.py",
                "perfbench/configs/unet_calibrated.json", "perfbench/traffic/brats_c8.json"):
        assert (root / rel).read_bytes() == (harness.ROOT / rel).read_bytes()
    cell = harness.resolve(testing.UNET_CELL, root)
    assert cell.config["model"]["base"] == 8 and cell.mix["name"] == "slices_smoke"
    assert {m["name"] for m in cell.end_to_end} == {
        "seg_images_per_s", "seg_latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell, metrics", [
    (testing.UNET_CELL, {"seg_images_per_s", "seg_latency_p95_ms", "setup_s"}),
    (testing.LM_CELL, {"train_tokens_per_s", "setup_s"}),
])
def test_cell_runs_and_is_correct(root, cell, metrics):
    out = run(root, cell)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == metrics
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and out["checks"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell, some", [
    (testing.UNET_CELL, {"seg_batch_fill", "seg_loop_ms", "seg_mfu"}),
    (testing.LM_CELL, {"train_mfu"}),
])
def test_traced_run_reads_the_layers(root, cell, some):
    out = run(root, cell, trace=True)
    assert out["correct"] is True
    assert some <= set(out["metrics"]), out["metrics"]
    for name in ("seg_mma_roofline", "train_mma_roofline", "train_ste_gemm_ms"):
        assert name not in out["metrics"]  # no device, nothing to read
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def limits(root, cell):
    return harness.resolve(cell, root).config["check"]


def test_unet_control_fails_the_limit(root):
    r = calibrate.readings(testing.UNET_CELL, 2**31 + 23, 3.0, device="cpu", root=root)
    lim = limits(root, testing.UNET_CELL)["logit_gap"]
    assert r["images"] >= 1 and r["program"] <= lim < r["control_int4"], r


def test_lm_control_and_half_batch_fail_a_limit(root):
    r = calibrate.readings(testing.LM_CELL, 2**31 + 23, 1.0, device="cpu", root=root)
    lim = limits(root, testing.LM_CELL)
    assert all(r[f"program.{k}"] <= v for k, v in lim.items()), r
    for fault in ("control_int4", "fault_half_batch"):
        assert any(r[f"{fault}.{k}"] > v for k, v in lim.items()), (fault, r)


def test_an_answer_altered_where_it_is_made_is_not_correct(root, monkeypatch):
    from repro_torch.models import unet

    inner = unet.forward

    def altered(*a, **kw):
        out = inner(*a, **kw).clone()
        out[0, out.shape[1] // 2, out.shape[2] // 2, 0] += 1.0
        return out

    monkeypatch.setattr(unet, "forward", altered)
    out = run(root, testing.UNET_CELL)
    assert out["correct"] is False and out["checks"]["logit_gap"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(root, monkeypatch):
    from repro_torch.optim import adamw

    inner = adamw.update

    def unchanged(params, grads, state, **kw):
        _, new_state, metrics = inner(params, grads, state, **kw)
        for mast, p in zip(adamw.tree_leaves(new_state.master), adamw.tree_leaves(params)):
            mast.copy_(p.to(torch.float32))
        return params, new_state, metrics

    monkeypatch.setattr(adamw, "update", unchanged)
    out = run(root, testing.LM_CELL)
    assert out["correct"] is False
    assert out["checks"]["change_norm_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    from repro_torch.train import train_step as ts

    inner = ts.make_loss_fn

    def half(cfg, **kw):
        fn = inner(cfg, **kw)
        return lambda params, batch: fn(params, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(ts, "make_loss_fn", half)
    out = run(root, testing.LM_CELL)
    assert out["correct"] is False, out["checks"]


def test_result_line_is_json(root):
    out = run(root, testing.UNET_CELL)
    assert json.loads(json.dumps(out)) == out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_control_fails_on_the_card(card, root):
    """The int4 control at CPU-test size on the card (the full-size readings
    come from ``calibrate.py`` on the card)."""
    r = calibrate.readings(testing.UNET_CELL, 2**31 + 29, 2.0, root=Path(root))
    assert r["program"] <= limits(root, testing.UNET_CELL)["logit_gap"] < r["control_int4"]
