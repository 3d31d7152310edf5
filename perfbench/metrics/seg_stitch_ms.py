"""Host ms per micro-batch stitching its cores into the canvases (the
program's ``segserve.stitch`` span: the cores, finishing requests, the
cycle and pJ accounting, the tile events)."""
from perfbench import recorder


def read(trace):
    return recorder.mean_ms("segserve.stitch")
