"""Bit-plane decomposition — the digit-serial activation stream as tensors.

An int8 tensor is the Horner combination of 8 binary planes, and an inner
product becomes 8 binary (0/1) x int8 products combined MSB-first:

    acc <- 2*acc + plane_b @ w        (b = MSB .. LSB)

which is the paper's residual recurrence (Sec. 3.2).  Signed input uses the
offset form ``u = x + 128`` (planes of ``u`` are plain 0/1) and the exact
correction ``-128 * colsum(w)`` once at the end.

Integer products go through :func:`exact_matmul`: PyTorch has no integer
matmul on CUDA, so each product runs in float64 and converts back.  Every
partial sum here is an integer far below 2**53, so that is exact.
"""
from __future__ import annotations

from typing import Literal

import torch

N_BITS = 8
SIGNED_OFFSET = 128  # u = x + 128 for int8 x


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) integer @ (K, N) integer -> (..., N) int64, exactly.

    Exact while every partial sum stays below 2**53 in magnitude — true for
    every int8/uint8 product in this package (|sum| <= 255*128*K).
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def decompose(x: torch.Tensor, *, n_bits: int = N_BITS, signed: bool = True) -> torch.Tensor:
    """Decompose an int tensor into MSB-first binary planes.

    Returns an int8 tensor of shape ``(n_bits, *x.shape)``, planes[0] = MSB.
    With ``signed=False`` an int8 tensor's bits are read as its uint8 byte.
    """
    u = x.to(torch.int32)
    if signed:
        u = u + SIGNED_OFFSET
    shifts = torch.arange(n_bits - 1, -1, -1, dtype=torch.int32, device=x.device)
    planes = (u[None, ...] >> shifts.reshape((n_bits,) + (1,) * x.ndim)) & 1
    return planes.to(torch.int8)


def recombine(planes: torch.Tensor, *, signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`decompose` (Horner, MSB first)."""
    acc = torch.zeros(planes.shape[1:], dtype=torch.int32, device=planes.device)
    for plane in planes:
        acc = acc * 2 + plane.to(torch.int32)
    if signed:
        acc = acc - SIGNED_OFFSET
    return acc


def truncate_to_planes(
    x: torch.Tensor, planes: int | torch.Tensor, *, signed: bool = True
) -> torch.Tensor:
    """Data-side plane truncation: ``x'`` such that a plain full-precision
    matmul ``x' @ w`` equals ``bitplane_matmul(x, w, planes)``.

    Consuming only the ``b`` MSB planes of ``u = x + 128`` and rescaling
    equals masking off the low ``8-b`` bits of ``u``.  ``planes`` may be a
    tensor (one entry of a per-layer budget array).
    """
    u = x.to(torch.int32)
    if signed:
        u = u + SIGNED_OFFSET
    dropped = N_BITS - torch.as_tensor(planes, dtype=torch.int32, device=x.device)
    one = torch.ones((), dtype=torch.int32, device=x.device)
    mask = ~(torch.bitwise_left_shift(one, dropped) - 1)
    u = u & mask
    if signed:
        return (u - SIGNED_OFFSET).to(torch.int8)
    return u.to(x.dtype)


def normalize_planes(
    x: torch.Tensor, planes: int | torch.Tensor, *, signed: bool = True
) -> tuple[torch.Tensor, int]:
    """Resolve a per-call plane budget to (operand, static planes).

    Python ints are validated (1..N_BITS) and passed through — the kernel
    specializes on them and skips plane iterations.  Any other budget (a
    tensor entry of a budget array) folds into the data via
    :func:`truncate_to_planes`, after which the full-precision path runs on
    the pre-truncated operand: identical numerics.
    """
    if isinstance(planes, int):
        if not (1 <= planes <= N_BITS):
            raise ValueError(f"planes {planes} outside 1..{N_BITS}")
        return x, planes
    return truncate_to_planes(x, planes, signed=signed), N_BITS


def bitplane_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    planes: int = N_BITS,
    signed: bool = True,
    correction: Literal["none", "midpoint"] = "none",
) -> torch.Tensor:
    """Exact (planes=8) or truncated (planes<8) int matmul, MSB-first Horner.

    x: (..., K) int8 activations; w: (K, N) int8 weights -> (..., N) int32.
    Only the ``planes`` most significant planes are consumed; the partial
    Horner sum is rescaled by ``2**(8-planes)``, and
    ``correction='midpoint'`` adds the expected value of the dropped planes.
    """
    pl = decompose(x, n_bits=N_BITS, signed=signed)
    acc = torch.zeros(x.shape[:-1] + (w.shape[-1],), dtype=torch.int64, device=x.device)
    for i in range(planes):
        acc = acc * 2 + exact_matmul(pl[i], w)
    dropped = N_BITS - planes
    acc = acc * (2**dropped)
    colsum = w.to(torch.int64).sum(dim=0)
    if correction == "midpoint" and dropped:
        acc = acc + ((2**dropped - 1) * colsum) // 2
    if signed:
        acc = acc - SIGNED_OFFSET * colsum
    return acc.to(torch.int32)


def bitplane_matmul_cascade(
    x: torch.Tensor, w: torch.Tensor, *, planes: int = N_BITS, signed: bool = True
) -> torch.Tensor:
    """The un-merged baseline: one materialized partial product per plane,
    then a pairwise adder-tree reduction.  Numerically identical to
    :func:`bitplane_matmul`."""
    pl = decompose(x, n_bits=N_BITS, signed=signed)[:planes]
    parts = [exact_matmul(p, w) for p in pl]
    weights = [2 ** (planes - 1 - b) for b in range(planes)]
    parts = [p * w_ for p, w_ in zip(parts, weights)]
    while len(parts) > 1:
        nxt = [a + b for a, b in zip(parts[::2], parts[1::2])]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    acc = parts[0] * (2 ** (N_BITS - planes))
    if signed:
        acc = acc - SIGNED_OFFSET * w.to(torch.int64).sum(dim=0)
    return acc.to(torch.int32)
