"""Host ms per training step issuing the held experts' products (the
program's ``moe.experts`` span: three MMA launches and their STE products
per expert with rows, forward and remat recompute)."""
from perfbench import recorder


def read(trace):
    return recorder.ms_per_step("moe.experts", "train_step")
