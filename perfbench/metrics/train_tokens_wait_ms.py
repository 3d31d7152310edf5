"""Host ms per training step moving the tokens to the card (the program's
``lm.tokens`` span, once per microbatch: a copy from host memory, which
waits for the card's queued work)."""
from perfbench import recorder


def read(trace):
    return recorder.ms_per_step("lm.tokens", "train_step")
