"""Host ms per training step inside the backward's call
(``torch.autograd.grad``; the program's ``train_step.backward`` span, once
per microbatch)."""
from perfbench import recorder


def read(trace):
    return recorder.ms_per_step("train_step.backward", "train_step")
