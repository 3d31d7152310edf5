"""Host ms per micro-batch packing its tiles (the program's
``segserve.pack`` span: the zero batch and the tile gather)."""
from perfbench import recorder


def read(trace):
    return recorder.mean_ms("segserve.pack")
