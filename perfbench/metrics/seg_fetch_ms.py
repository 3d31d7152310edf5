"""Host ms per micro-batch copying its logits to the host (the program's
``segserve.fetch`` span, which waits for the forward's device work)."""
from perfbench import recorder


def read(trace):
    return recorder.mean_ms("segserve.fetch")
