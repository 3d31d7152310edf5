"""Published peaks of one NVIDIA H100 SXM and the least time of a launch.

NVIDIA's data sheet, dense rates without sparsity, at the card's full
700 W power limit (the harness prints the limit the card was set to beside
every window): 1,979 TOP/s int8, 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67
TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.

The operations and bytes of each hand-written kernel sit in a file of their
own beside this one, ``roofline/<kernel>.py``, with ``least_seconds(...)``
for one launch.
"""

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time the card can take: the larger of the operations at
    the peak rate and the bytes at the memory's."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
