"""The mean row count M of a held expert's product: the program's counters
``moe.expert_rows`` over ``moe.expert_calls`` (an expert with no routed
row is not called)."""
from perfbench import recorder


def read(trace):
    return recorder.ratio("moe.expert_rows", "moe.expert_calls")
