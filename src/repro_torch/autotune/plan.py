"""TunedPlan — the serialized, certified artifact the autotuner produces.

A plan is everything a serving engine needs to run a workload at a tuned
operating point, plus the evidence that made the point trustworthy:

  * the per-layer plane schedule (``planes``) and, for tiled segmentation,
    the tile/halo geometry and the calibrated budget-class table
    (``class_thresholds`` + ``class_planes`` — thresholds come from the
    calibration histogram, per-class refinements from *measured* per-layer
    amplitude ratios, not the fixed-octave heuristic);
  * a two-tier certificate: ``certificate['cert']`` is the bound the CI
    gate enforces — the maximum end-to-end error *measured on the
    calibration set through the exact serving path*, inflated by
    ``certificate['margin']`` and kept ``<= target_rel_err`` by the search;
    ``certificate['sound_bound']`` is the worst-case interval-propagated
    bound (``unet.forward_with_error_bound`` extended per tile) — sound
    unconditionally but loose, recorded for transparency;
  * a ``fingerprint`` binding the plan to the exact weights, calibration
    inputs and knobs it was derived from, so a stale plan is detectable —
    plus a ``params_fingerprint`` over the weights alone, the half a
    serving gateway can re-derive at admission time (it holds the served
    params but not the calibration set) to reject or quarantine a plan
    tuned against different weights (``repro_torch.serve.gateway``).

Plans round-trip losslessly through JSON (``to_json`` / ``from_json``) and
persist with the checkpoint module's crash-safety discipline
(``save`` / ``load`` use :func:`repro_torch.checkpoint.save_json_atomic`).
The JSON schema is the reference package's: a plan written by either
package loads in the other.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from repro_torch.core.bitplane import N_BITS
from repro_torch.core.plane_schedule import PlaneSchedule

# v2: + params_fingerprint (weights-only binding, verified at gateway
# admission).  v1 plans load with it as None — unverifiable, so the gateway
# treats them as stale.
# v3: + spec_planes/spec_k (the tune_spec operating point for
# precision-speculative decode).  v1/v2 plans load with both as None —
# speculation simply stays off.
PLAN_VERSION = 3


def _opt_tuple(v, conv=float):
    return None if v is None else tuple(conv(x) for x in v)


@dataclass(frozen=True)
class TunedPlan:
    """Immutable tuned operating point for one workload.

    ``workload`` is ``'unet'`` (tiled segmentation: tile/halo/class fields
    populated) or ``'lm'`` (layer schedule + certificate only).
    ``geometry`` carries the workload-specific shape record the plan was
    tuned against (and is part of the fingerprint's meaning); ``modeled``
    carries advisory relation-(2) accounting for the bench tracker.
    """

    workload: str
    geometry: dict
    planes: tuple[int, ...]
    target_rel_err: float
    certificate: dict
    fingerprint: str
    params_fingerprint: str | None = None
    layer_bounds: tuple[float, ...] | None = None
    tile: int | None = None
    halo: int | None = None
    class_thresholds: tuple[float, ...] | None = None
    class_planes: tuple[tuple[int, ...], ...] | None = None
    layer_gain: tuple[float, ...] | None = None
    modeled: dict = field(default_factory=dict)
    spec_planes: tuple[int, ...] | None = None
    spec_k: int | None = None
    version: int = PLAN_VERSION

    def __post_init__(self):
        if self.workload not in ("unet", "lm"):
            raise ValueError(f"unknown workload {self.workload!r}")
        if not self.planes:
            raise ValueError("empty plane schedule")
        for b in self.planes:
            if not (1 <= int(b) <= N_BITS):
                raise ValueError(f"plane count {b} outside 1..{N_BITS}")
        if not (0.0 < float(self.target_rel_err)):
            raise ValueError(f"target_rel_err {self.target_rel_err} <= 0")
        if (self.class_thresholds is None) != (self.class_planes is None):
            raise ValueError(
                "class_thresholds and class_planes must be set together"
            )
        if self.class_thresholds is not None:
            t = self.class_thresholds
            if not t or t[0] != 1.0:
                raise ValueError(
                    f"class_thresholds must start at 1.0, got {t}"
                )
            if any(a <= b for a, b in zip(t, t[1:])):
                raise ValueError(
                    f"class_thresholds must strictly descend, got {t}"
                )
            if len(self.class_planes) != len(t):
                raise ValueError(
                    f"{len(self.class_planes)} class schedules for "
                    f"{len(t)} thresholds"
                )
            for cp in self.class_planes:
                if len(cp) != len(self.planes):
                    raise ValueError(
                        "every class schedule must cover every layer"
                    )
        if (self.spec_planes is None) != (self.spec_k is None):
            raise ValueError("spec_planes and spec_k must be set together")
        if self.spec_planes is not None:
            if self.workload != "lm":
                raise ValueError("speculative fields are lm-only")
            if len(self.spec_planes) != len(self.planes):
                raise ValueError(
                    f"spec schedule covers {len(self.spec_planes)} layers, "
                    f"plan has {len(self.planes)}"
                )
            for b in self.spec_planes:
                if not (1 <= int(b) <= N_BITS):
                    raise ValueError(
                        f"spec plane count {b} outside 1..{N_BITS}"
                    )
            if int(self.spec_k) < 1:
                raise ValueError(f"spec_k {self.spec_k} < 1")
        if self.workload == "unet":
            if self.tile is None or self.halo is None:
                raise ValueError("a unet plan needs tile and halo")
            # the satellite guard: the halo walk must not prove the tile
            # degenerate for the tuned geometry
            self._unet_config_cls()(
                depth=int(self.geometry["depth"]),
                convs_per_stage=int(self.geometry["convs_per_stage"]),
            ).validate_tile(int(self.tile), halo=int(self.halo))

    @staticmethod
    def _unet_config_cls():
        from repro_torch.models.unet import UNetConfig  # lazy: models import torch

        return UNetConfig

    # ----------------------------------------------------------- accessors

    def schedule(self) -> PlaneSchedule:
        """The certified layer-level policy as a core schedule object."""
        return PlaneSchedule(
            planes=self.planes,
            target_rel_err=self.target_rel_err,
            layer_bounds=self.layer_bounds,
        )

    @property
    def n_classes(self) -> int:
        """Number of calibrated budget classes (1 when non-adaptive)."""
        return 1 if self.class_thresholds is None else len(self.class_thresholds)

    def classify(self, ratio: float) -> int:
        """Budget class of a tile at ``ratio`` of the image amplitude,
        under the *calibrated* thresholds (largest class whose threshold
        still bounds the ratio — conservative for ratios calibration never
        saw)."""
        from repro_torch.segserve.adaptive import budget_class_from_thresholds

        if self.class_thresholds is None:
            return 0
        return budget_class_from_thresholds(ratio, self.class_thresholds)

    def class_schedule(self, k: int) -> tuple[int, ...]:
        """Per-layer planes micro-batches of class-``k`` tiles run."""
        if self.class_planes is None:
            if k != 0:
                raise ValueError(f"non-adaptive plan has no class {k}")
            return self.planes
        return self.class_planes[k]

    # --------------------------------------------------------- persistence

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TunedPlan":
        d = dict(d)
        version = int(d.pop("version", PLAN_VERSION))
        if version > PLAN_VERSION:
            raise ValueError(
                f"plan version {version} is newer than this code "
                f"({PLAN_VERSION}) — refusing to misread a certificate"
            )
        return cls(
            workload=str(d["workload"]),
            geometry=dict(d["geometry"]),
            planes=tuple(int(b) for b in d["planes"]),
            target_rel_err=float(d["target_rel_err"]),
            certificate=dict(d["certificate"]),
            fingerprint=str(d["fingerprint"]),
            params_fingerprint=(
                None if d.get("params_fingerprint") is None
                else str(d["params_fingerprint"])
            ),
            layer_bounds=_opt_tuple(d.get("layer_bounds")),
            tile=None if d.get("tile") is None else int(d["tile"]),
            halo=None if d.get("halo") is None else int(d["halo"]),
            class_thresholds=_opt_tuple(d.get("class_thresholds")),
            class_planes=(
                None
                if d.get("class_planes") is None
                else tuple(
                    tuple(int(b) for b in cp) for cp in d["class_planes"]
                )
            ),
            layer_gain=_opt_tuple(d.get("layer_gain")),
            modeled=dict(d.get("modeled") or {}),
            spec_planes=_opt_tuple(d.get("spec_planes"), int),
            spec_k=None if d.get("spec_k") is None else int(d["spec_k"]),
            version=version,
        )

    def save(self, path) -> None:
        """Atomic JSON write (crash-safe, same discipline as checkpoints)."""
        from repro_torch.checkpoint import save_json_atomic

        save_json_atomic(path, self.to_json())

    @classmethod
    def load(cls, path) -> "TunedPlan":
        from repro_torch.checkpoint import load_json

        return cls.from_json(load_json(path))

    # ------------------------------------------------------------ describe

    def describe(self) -> str:
        cert = self.certificate.get("cert")
        parts = [
            f"TunedPlan[{self.workload}] planes={list(self.planes)}",
            f"target={self.target_rel_err:g}",
            f"cert={cert:.4g}" if cert is not None else "cert=?",
        ]
        if self.tile is not None:
            parts.append(f"tile={self.tile}(halo {self.halo})")
        if self.class_thresholds is not None:
            parts.append(f"classes={len(self.class_thresholds)}")
        if self.spec_planes is not None:
            parts.append(
                f"spec=k{self.spec_k}@{list(self.spec_planes)}"
            )
        return " ".join(parts)
