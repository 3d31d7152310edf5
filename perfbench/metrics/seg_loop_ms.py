"""Host ms per micro-batch spent in ``SegEngine.step`` outside
``models.unet.forward`` (packing, stitching, bookkeeping, the copy of the
logits to the host), from the harness's spans around both."""


def read(trace):
    steps, fwd = trace.spans.get("seg.step", []), trace.spans.get("seg.forward", [])
    if not steps:
        return None
    return (sum(steps) - sum(fwd)) / len(steps) * 1e3
