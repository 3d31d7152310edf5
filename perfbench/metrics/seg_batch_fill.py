"""Real tiles over the rows the micro-batches ran (the rest are zero
padding), from the engine's ``seg-batch`` counters, in %."""


def read(trace):
    c = trace.counters
    if not c.get("seg_batches"):
        return None
    return 100.0 * c["tiles"] / (c["seg_batches"] * c["batch"])
