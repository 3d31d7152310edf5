"""Device ms per micro-batch of every device operation of the window except
the MMA kernel: im2col, quantization, pooling, upsampling, concats, the
head, and the copies in and out, from the profiler."""
from perfbench.roofline import mma_tc_horner_kernel as mma


def read(trace):
    n = trace.counters.get("steps")
    if not n:
        return None
    return trace.device_seconds(lambda name: not mma.is_launch(name)) / n * 1e3
