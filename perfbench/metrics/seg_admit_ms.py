"""Host ms per admitted image in ``SegEngine``'s admission (the program's
``segserve.admit`` span: tile plan, canvas padding, tile classification)."""
from perfbench import recorder


def read(trace):
    return recorder.mean_ms("segserve.admit")
