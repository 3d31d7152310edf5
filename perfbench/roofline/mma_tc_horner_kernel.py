"""The unscaled MMA kernel, ``mma_tc_horner_kernel`` (int8 x int8 -> int32
on the int8 tensor cores, one Horner pass per activation plane).

Its useful work is the one int8 product it stands for, 2 M K N operations,
whatever number of planes it walks; its bytes are x (M x K int8) and w
(K x N int8) read once and the int32 out written once (the ops and bytes
bound of the program's ``chip_smoke.py`` ``train_times``, copied).  Padded
rows count: the kernel was given them.
"""
from perfbench.roofline import INT8_OPS_PER_S, least_seconds

NAME = "mma_tc_horner_kernel"


def ops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def nbytes(m: int, k: int, n: int) -> int:
    return m * k + k * n + 4 * m * n


def least_seconds_of(m: int, k: int, n: int) -> float:
    return least_seconds(ops(m, k, n), nbytes(m, k, n), INT8_OPS_PER_S)


def is_launch(op_name: str) -> bool:
    """A device operation of this kernel, by the profiler's name
    (``void (anonymous namespace)::mma_tc_horner_kernel<5, true, 64>(...)``)."""
    return f"::{NAME}<" in op_name or op_name.startswith(f"{NAME}<")
