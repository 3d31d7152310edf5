"""Per-layer dynamic-precision schedules — the MSDF knob as a policy object.

A :class:`PlaneSchedule` assigns each conv layer its own plane budget
``b_l`` (1..8 MSB activation planes), built one of three ways:

  * ``PlaneSchedule.uniform(b, n_layers)``      — one global budget
  * ``PlaneSchedule.from_list([...])``          — explicit per-layer budgets
  * ``PlaneSchedule.from_weights(ws, target)``  — fewest planes per layer
    such that the analytic worst-case relative error (``early_term``)
    meets a target.

Each distinct ``b_l`` selects one specialization of the CUDA kernel
(``kernels.mma_matmul.plane_variant``), which runs only ``b_l`` Horner
steps; ``cycle_model.schedule_cycles`` prices the schedule analytically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Sequence

import torch

from . import early_term
from .bitplane import N_BITS


def layer_rel_bound(w_int8: torch.Tensor, planes: int) -> float:
    """Worst-case relative error of one layer truncated to ``planes`` MSB
    planes: max over output channels of truncation_bound / output_scale.

    Uses the uncorrected bound (midpoint=False): the datapaths a schedule
    drives apply plain truncation with no midpoint correction.
    """
    denom = torch.clamp(early_term.output_scale_bound(w_int8).to(torch.float32), min=1.0)
    num = early_term.truncation_bound(w_int8, planes, midpoint=False).to(torch.float32)
    return float(torch.max(num / denom))


@dataclass(frozen=True)
class PlaneSchedule:
    """Immutable per-layer plane budgets with the bound that justified them.

    ``planes[l]`` is the number of MSB activation planes layer ``l``
    consumes; ``layer_bounds[l]`` (when built from weights) is that layer's
    analytic worst-case relative error at its budget.
    """

    planes: tuple[int, ...]
    target_rel_err: float | None = None
    layer_bounds: tuple[float, ...] | None = None

    def __post_init__(self):
        if not self.planes:
            raise ValueError("empty schedule")
        for b in self.planes:
            if not (1 <= int(b) <= N_BITS):
                raise ValueError(f"plane count {b} outside 1..{N_BITS}")

    # ------------------------------------------------------------ builders

    @classmethod
    def uniform(cls, planes: int, n_layers: int) -> "PlaneSchedule":
        return cls(planes=(int(planes),) * n_layers)

    @classmethod
    def from_list(cls, planes: Sequence[int]) -> "PlaneSchedule":
        return cls(planes=tuple(int(b) for b in planes))

    @classmethod
    def from_weights(
        cls, weights_int8: Sequence[torch.Tensor], target_rel_err: float
    ) -> "PlaneSchedule":
        """Fewest planes per layer meeting ``target_rel_err`` (worst case).

        ``weights_int8[l]`` is layer ``l``'s int8 weight; it is reshaped to
        (K, N) — for a conv, (kh*kw*cin, cout), as the KPB contracts it.
        """
        budgets, bounds = [], []
        for w in weights_int8:
            w2 = w.reshape(-1, w.shape[-1])
            b = early_term.choose_planes(w2, target_rel_err, midpoint=False)
            budgets.append(b)
            bounds.append(layer_rel_bound(w2, b))
        return cls(
            planes=tuple(budgets),
            target_rel_err=float(target_rel_err),
            layer_bounds=tuple(bounds),
        )

    # ----------------------------------------------------------- accessors

    def __len__(self) -> int:
        return len(self.planes)

    def __iter__(self) -> Iterator[int]:
        return iter(self.planes)

    def __getitem__(self, i: int) -> int:
        return self.planes[i]

    def planes_for(self, layer_idx: int) -> int:
        """Budget for layer ``layer_idx``; clamps to the last entry."""
        return self.planes[min(layer_idx, len(self.planes) - 1)]

    def as_array(self) -> torch.Tensor:
        """(L,) int32 — the budget-array form ``unet.forward`` takes."""
        return torch.tensor(self.planes, dtype=torch.int32)

    # ----------------------------------------------------- tile refinement

    def refine(self, amp_ratio: float | Sequence[float]) -> "PlaneSchedule":
        """Content-adaptive tile-level refinement of this schedule.

        ``amp_ratio`` (0 <= r <= 1, scalar or one per layer) is a region's
        activation amplitude relative to the level this schedule was
        certified at.  Layer ``l`` keeps the largest drop ``d'`` with

            (2^d' - 1) * r_l  <=  2^d_l - 1,      d_l = 8 - planes[l]

        so the refined tile error never exceeds ``layer_bounds[l]``.
        Full-precision layers are never refined and at least 1 plane is
        always kept.  NaN and infinite ratios are rejected.
        """
        ratios = self._validated_ratios(amp_ratio)
        refined = []
        for b, r in zip(self.planes, ratios):
            d = N_BITS - b
            if d == 0:
                refined.append(b)
                continue
            budget = float(2**d - 1)
            d2 = d
            while d2 < N_BITS - 1 and (2 ** (d2 + 1) - 1) * r <= budget:
                d2 += 1
            refined.append(N_BITS - d2)
        return PlaneSchedule(
            planes=tuple(refined),
            target_rel_err=self.target_rel_err,
            layer_bounds=self.layer_bounds,
        )

    def _validated_ratios(self, amp_ratio) -> tuple[float, ...]:
        try:
            ratios = (float(amp_ratio),) * len(self.planes)
        except TypeError:
            ratios = tuple(float(r) for r in amp_ratio)
            if len(ratios) != len(self.planes):
                raise ValueError(
                    f"{len(ratios)} amplitude ratios for "
                    f"{len(self.planes)} layers — refine needs one ratio "
                    f"per layer (or a scalar)"
                )
        for r in ratios:
            if math.isnan(r) or math.isinf(r):
                raise ValueError(
                    f"amp_ratio {r} is not finite — amplitude calibration "
                    f"produced garbage; refusing to pick a precision from it"
                )
            if not (0.0 <= r <= 1.0):
                raise ValueError(f"amp_ratio {r} outside [0, 1]")
        return ratios

    # ------------------------------------------------------------- metrics

    def arithmetic_fraction(self) -> float:
        """Fraction of full-precision digit-serial work the schedule keeps."""
        return sum(self.planes) / (N_BITS * len(self.planes))

    def rel_err_bound(self) -> float:
        """Advertised end-to-end relative-error bound: first-order sum of
        the per-layer worst-case bounds."""
        if self.layer_bounds is not None:
            return float(sum(self.layer_bounds))
        if self.target_rel_err is not None:
            return self.target_rel_err * len(self.planes)
        return float(sum((2.0 ** (N_BITS - b) - 1.0) / 255.0 for b in self.planes))

    def describe(self) -> str:
        frac = self.arithmetic_fraction()
        tgt = (
            f", target={self.target_rel_err:g}"
            if self.target_rel_err is not None
            else ""
        )
        return (
            f"PlaneSchedule({list(self.planes)}, kept={frac:.2f} of digit "
            f"work{tgt})"
        )
