"""Device ms per training step of the optimizer: the device operations
inside the harness's span around ``optim.adamw.update``, which is
synchronised on both ends."""


def read(trace):
    steps = trace.counters.get("steps")
    if not steps or "train.optimizer" not in trace.ranges:
        return None
    return trace.device_seconds_inside("train.optimizer") / steps * 1e3
