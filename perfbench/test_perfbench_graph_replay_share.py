"""``seg_graph_replay_share`` reads the program's graph counters
(``unet.graph_replays`` over ``unet.graph_forwards``) from its recorder, and
reads None where a recording holds no such counter, as a program without
the graph cache records."""
from perfbench import harness

READER = harness.load_module(harness.ROOT / "perfbench" / "metrics" / "seg_graph_replay_share.py",
                             "metric_seg_graph_replay_share")


def test_a_recording_with_the_counters_reads_their_share():
    from repro_torch.obs import timeline

    with timeline.recording():
        timeline.count("unet.graph_forwards", 40)
        timeline.count("unet.graph_replays", 37)
        timeline.count("unet.graph_captures", 5)
    assert READER.read(None) == 100.0 * 37 / 40


def test_forwards_none_of_them_replayed_read_zero():
    from repro_torch.obs import timeline

    with timeline.recording():
        timeline.count("unet.graph_forwards", 3)
    assert READER.read(None) == 0.0


def test_a_recording_without_the_counters_reads_none():
    from repro_torch.obs import timeline

    with timeline.recording():
        timeline.count("segserve.requests")
    assert READER.read(None) is None
