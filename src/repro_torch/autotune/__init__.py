"""Calibrated, certified precision/tile planning (the autotune subsystem).

Turns (model, validation batch, error budget, geometry) into a serialized
:class:`TunedPlan` that ``SegEngine(plan=...)`` serves:

``calibrate`` — instrumented forwards: per-layer activation amplitudes and
               octave histograms, measured per-tile ratio gains, the
               single-layer truncation sensitivity table, and the per-tile
               extension of the sound interval certificate;
``search``    — greedy cycles-per-error descent over per-layer plane
               budgets + tile-size search, both minimizing relation-(2)
               cycles subject to the measured error budget;
``plan``      — the :class:`TunedPlan` artifact (schedule, tile/halo,
               calibrated class thresholds, two-tier certificate,
               calibration fingerprint) with atomic JSON round-trip, in
               the reference package's schema;
``api``       — :func:`tune_unet` and the wiring into ``UNetConfig`` and
               ``SegEngine``; :func:`apply_plan_lm` installs an LM plan.
               The LM tuners are not ported yet.
"""
from . import api, calibrate, plan, search  # noqa: F401
from .api import (  # noqa: F401
    apply_plan,
    apply_plan_lm,
    engine_from_plan,
    reference_plan,
    tune_unet,
)
from .calibrate import (  # noqa: F401
    Calibration,
    calibrate_unet,
    params_fingerprint,
    rel_err,
    tiled_sound_bound,
)
from .plan import TunedPlan  # noqa: F401
