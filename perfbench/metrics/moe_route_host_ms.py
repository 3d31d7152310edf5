"""Host ms per training step routing the held-expert layers (the program's
``moe.route`` span: the router's product, the top-k and the one read of the
expert counts that waits for the card; a remat recompute routes again)."""
from perfbench import recorder


def read(trace):
    return recorder.ms_per_step("moe.route", "train_step")
