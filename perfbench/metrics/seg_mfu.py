"""The whole service's share of the card's int8 peak, in %: useful
operations of the images finished in the window (every 3x3 conv over each
image's padded canvas, once; halo overlap and padded rows are not useful)
over the window times 1,979 TOP/s."""
from perfbench.roofline import INT8_OPS_PER_S


def read(trace):
    c = trace.counters
    if not c.get("useful_ops"):
        return None
    return 100.0 * c["useful_ops"] / (c["window_s"] * INT8_OPS_PER_S)
