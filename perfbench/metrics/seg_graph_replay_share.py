"""The share of the U-Net forwards given a graph cache that a CUDA graph's
replay served, in % (the program's counters ``unet.graph_replays`` over
``unet.graph_forwards``; a capturing forward is served by its replay)."""
from perfbench import recorder


def read(trace):
    share = recorder.ratio("unet.graph_replays", "unet.graph_forwards")
    return None if share is None else 100.0 * share
