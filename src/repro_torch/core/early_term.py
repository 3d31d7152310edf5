"""Early termination / progressive precision — the MSDF property.

Truncating to the ``b`` most significant activation planes has the exact
worst-case bound (planes are 0/1):

    |S_full - S_b| <= (2**(8-b) - 1) * sum_k |w[k, n]|        per output n

and with the midpoint correction the bound halves.  :func:`choose_planes`
picks the fewest planes meeting a target relative error per layer.
"""
from __future__ import annotations

import torch

from .bitplane import N_BITS


def truncation_bound(w_int8: torch.Tensor, planes: int, *, midpoint: bool = True) -> torch.Tensor:
    """Worst-case |error| per output column of an int8 matmul truncated to
    ``planes`` MSB activation planes.  w_int8: (K, N)."""
    dropped = N_BITS - planes
    l1 = torch.abs(w_int8.to(torch.int32)).sum(dim=0, dtype=torch.int32)
    bound = (2**dropped - 1) * l1
    if midpoint:
        bound = (bound + 1) // 2
    return bound


def output_scale_bound(w_int8: torch.Tensor) -> torch.Tensor:
    """Scale of the full-precision output: 255 * colsum(|w|)."""
    return 255 * torch.abs(w_int8.to(torch.int32)).sum(dim=0, dtype=torch.int32)


def choose_planes(w_int8: torch.Tensor, target_rel_err: float, *, midpoint: bool = True) -> int:
    """Fewest planes such that worst-case relative error <= target.

    ``midpoint=False`` bounds uncorrected truncation — what the deployed
    datapaths apply; the midpoint bound is only valid with the correction.
    """
    denom = torch.clamp(output_scale_bound(w_int8).to(torch.float32), min=1.0)
    for b in range(1, N_BITS + 1):
        bound = truncation_bound(w_int8, b, midpoint=midpoint)
        rel = torch.max(bound.to(torch.float32) / denom)
        if float(rel) <= target_rel_err:
            return b
    return N_BITS


def empirical_rel_err(exact: torch.Tensor, approx: torch.Tensor) -> torch.Tensor:
    """Measured relative error, for validating the bound."""
    denom = torch.clamp(torch.max(torch.abs(exact.to(torch.float32))), min=1.0)
    return torch.max(torch.abs(exact - approx).to(torch.float32)) / denom
