"""Micro-batches per finished image: those that carried at least one of the
image's tiles, over the images finished (the program's counters
``segserve.request_batches`` and ``segserve.requests``)."""
from perfbench import recorder


def read(trace):
    return recorder.ratio("segserve.request_batches", "segserve.requests")
