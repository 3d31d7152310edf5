"""The device's idle share of the traced window, in %: 1 - the union of its
operations' intervals over the window."""


def read(trace):
    if trace.window_s <= 0 or not trace.counters.get("steps"):
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
