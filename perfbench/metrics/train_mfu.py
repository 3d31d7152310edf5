"""The whole training step's share of the card's peak, in %: the step's
least time (forward linear products at the int8 peak, the
straight-through estimator's backward products at the float32 peak, causal
attention at the bf16 peak; nothing for remat) over the measured time per
step of the traced window."""


def read(trace):
    c = trace.counters
    if not c.get("steps"):
        return None
    return 100.0 * c["step_least_s"] / (c["window_s"] / c["steps"])
