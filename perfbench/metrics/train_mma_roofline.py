"""The unscaled MMA kernel's share of its roofline over the training
window, in %: each launch's least time at its shape (``roofline/
mma_tc_horner_kernel.py``; M = the microbatch's tokens) summed, over the
kernel's device time.  Nothing is read when the profiler's launches and the
counted ones differ (the shapes the harness counts, the program's
own ``kernels.mma_matmul.launches``)."""
from perfbench.roofline import mma_tc_horner_kernel as mma


def read(trace):
    c = trace.counters
    launches = c.get("mma_launches")
    if not launches or not trace.count(mma.is_launch) == len(launches) == c["mma_launch_count"]:
        return None
    return 100.0 * c["mma_least_s"] / trace.device_seconds(mma.is_launch)
