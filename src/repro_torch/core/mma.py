"""Merged multiply-add (MMA) — the public API of the paper's technique.

``mma_dot`` computes an exact (or plane-truncated) int8 x int8 -> int32
matmul through one of four datapaths:

  impl='kernel'   the hand-written CUDA kernel (kernels/mma_matmul.py): the
                  bit-plane Horner recurrence with the residual held in
                  registers — the merged unit.            [paper's proposal]
  impl='horner'   the same recurrence on whole tensors, plain PyTorch.
  impl='cascade'  per-plane partials materialized then tree-reduced — the
                  un-merged baseline.                            [baseline]
  impl='int8'     one full-width integer product — the bit-parallel
                  baseline.                            [baseline, Zhang'15]

``mma_linear`` wraps it as a float-in/float-out quantized linear layer.
"""
from __future__ import annotations

from typing import Literal

import torch

from . import bitplane, quant

Impl = Literal["kernel", "horner", "cascade", "int8"]


def mma_dot(
    x_int8: torch.Tensor,
    w_int8: torch.Tensor,
    *,
    planes: int | torch.Tensor = bitplane.N_BITS,
    impl: Impl = "horner",
    signed: bool = True,
) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, via the MMA datapath.

    ``planes`` is the per-call precision budget: an int specializes the
    serial datapaths to that many MSB planes; a tensor budget applies the
    same truncation on the data side (``bitplane.normalize_planes``).

    On ``meta`` inputs (the dry run's counting mode) the result is an empty
    int32 ``meta`` tensor of the product's shape, whatever ``impl``.
    """
    if x_int8.device.type == "meta":
        return torch.matmul(x_int8, w_int8).to(torch.int32)
    x_int8, planes = bitplane.normalize_planes(x_int8, planes, signed=signed)
    if impl == "int8":
        if planes != bitplane.N_BITS:
            x_int8 = bitplane.truncate_to_planes(x_int8, planes, signed=signed)
        return bitplane.exact_matmul(x_int8, w_int8).to(torch.int32)
    if impl == "horner":
        return bitplane.bitplane_matmul(x_int8, w_int8, planes=planes, signed=signed)
    if impl == "cascade":
        return bitplane.bitplane_matmul_cascade(x_int8, w_int8, planes=planes, signed=signed)
    if impl == "kernel":
        from repro_torch.kernels import ops  # lazy: ops imports this package

        return ops.mma_matmul(x_int8, w_int8, planes=planes, signed=signed, device=x_int8.device)
    raise ValueError(f"unknown impl {impl!r}")


def mma_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    planes: int | torch.Tensor = bitplane.N_BITS,
    impl: Impl = "horner",
    w_q: quant.QTensor | None = None,
    batch_axis: int | None = None,
) -> torch.Tensor:
    """Quantized linear: float x (..., K) @ float w (K, N) -> float (..., N).

    The forward runs int8 through the MMA datapath; gradients flow through
    the float product (straight-through estimator).  The value is the
    quantized product exactly (``out + (full - full.detach())``): the
    reference's ``full + stop_gradient(out - full)`` rounds the subtraction
    where ``out`` and ``full`` part by more than a factor of 2, and so
    depends on the float product's summation order, which a sharded step
    changes.
    """
    xq = quant.quantize_acts(x, batch_axis=batch_axis)
    wq = w_q if w_q is not None else quant.quantize_weights(w, channel_axis=-1)
    out_i32 = mma_dot(xq.values, wq.values, planes=planes, impl=impl)
    out = out_i32.to(torch.float32) * quant.quantized_matmul_scale(xq.scale, wq.scale)
    return straight_through(out, x @ w)


def straight_through(out: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``out``'s value with ``full``'s gradient (see :func:`mma_linear`)."""
    return out.detach() + (full - full.detach())
