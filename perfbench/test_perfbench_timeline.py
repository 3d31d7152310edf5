"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.obs.timeline``), in traced runs of the small cells on the
CPU: each is a number, and the serving loop's spans lie inside the
harness's step span and outside its forward span."""
import pytest
import torch

from perfbench import harness, recorder, testing

NEW = {
    testing.UNET_CELL: ("seg_admit_ms", "seg_pack_ms", "seg_fetch_ms", "seg_stitch_ms",
                        "seg_forward_host_ms", "seg_request_batches"),
    testing.LM_CELL: ("train_tokens_wait_ms", "train_backward_host_ms"),
}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of each small cell, with one intra-op thread (as the
    other whole-run tests take it)."""
    root = testing.smoke_root(tmp_path_factory.mktemp("bench"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {cell: harness.run_cell(cell, 2**31 + 29, 8.0, True, root=root, device="cpu")
                for cell in NEW}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(NEW))
def test_traced_run_reads_every_program_metric(traced, cell):
    out = traced[cell]
    assert out["correct"] is True, out["checks"]
    for name in NEW[cell]:
        v = out["metrics"][name]["value"]
        assert isinstance(v, float) and v > 0, (name, v)


def test_the_loop_spans_lie_inside_the_harness_loop(traced):
    m = {k: v["value"] for k, v in traced[testing.UNET_CELL]["metrics"].items()}
    assert m["seg_pack_ms"] + m["seg_fetch_ms"] + m["seg_stitch_ms"] <= m["seg_loop_ms"], m
    # at least one micro-batch per finished slice
    assert m["seg_request_batches"] >= 1


def test_a_span_the_recording_lacks_reads_none(traced):
    """The last recording is the LM run's: a reader of a span or counter it
    does not hold reads None, never 0."""
    assert recorder.mean_ms("segserve.pack") is None
    assert recorder.ratio("segserve.request_batches", "segserve.requests") is None
    assert recorder.ms_per_step("lm.tokens", "train_step") > 0
