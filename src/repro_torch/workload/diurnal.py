"""Streaming diurnal/burst arrival generation on the modeled clock.

:mod:`repro_torch.workload.arrivals` materializes arrival lists — right for
committed canonical traces, wrong for capacity planning, where a day of
fleet traffic is millions of requests.  This module provides the same
process families as lazy **generators**, plus a day-curve modulation
combinator, so arbitrarily long workloads stream through
:func:`repro_torch.workload.replay.replay_stream` without ever materializing
a trace in memory.

Determinism contract (same as :mod:`.arrivals`): every draw is a pure
function of ``(seed, counter)`` via the counter PRNG, and the counters
advance only with the *candidate index* — so each stream is
**prefix-stable**: truncating or extending it never reshuffles earlier
arrivals, and re-iterating from the same seed reproduces the identical
prefix (property-tested).

Composition model — day-shaped rate curves are built from the existing
families, not a new process:

* :func:`iter_poisson` / :func:`iter_on_off` — infinite generator twins
  of :func:`.arrivals.poisson` / :func:`.arrivals.on_off`, sharing their
  exact domain tags, so ``list(islice(iter_poisson(...), n)) ==
  poisson(n, ...)`` to the integer.
* :func:`day_curve` — a raised-cosine relative-rate curve in
  ``[floor, 1]`` over one ``period`` (trough at phase 0).
* :func:`modulate` — Lewis–Shedler thinning of any sorted arrival
  stream by the day curve: candidate ``i`` survives iff
  ``U(seed, i) < day_curve(t_i)``.  Thinning a Poisson stream at peak
  rate yields an exact non-homogeneous Poisson with the day-shaped
  intensity; thinning an on-off stream yields diurnal bursts.
* :func:`diurnal` — the common case: ``modulate(iter_poisson(...))``.
* :func:`merge` / :func:`take` / :func:`take_until` — lazy stream
  plumbing.
* :func:`stream_requests` — compose per-class streams into the sorted
  lazy ``(cycle, kind, payload, kw)`` feed ``replay_stream`` drives.
"""
from __future__ import annotations

import heapq
import itertools
import math

from .arrivals import _exp_gap, counter_uniform

# domain tags shared with arrivals.py (prefix-identity with the list
# builders) + this module's own thinning domain
_POISSON_TAG = 0x9015504E
_ON_ARRIVAL_TAG = 0x0A44117A
_ON_DWELL_TAG = 0x00FFDEAD
_OFF_DWELL_TAG = 0x0FF0FF00
_THIN_TAG = 0xD1024EA7


def day_curve(cycle: int, *, period: int, floor: float = 0.15,
              phase: float = 0.0) -> float:
    """Relative rate in ``[floor, 1]`` at ``cycle``: a raised cosine
    over one ``period`` (modeled cycles), trough at ``phase=0`` — the
    canonical day shape (overnight trough, midday peak).  ``phase`` is
    in fractions of a period."""
    if period <= 0:
        raise ValueError(f"period {period} <= 0")
    if not 0.0 <= floor <= 1.0:
        raise ValueError(f"floor {floor} not in [0, 1]")
    rel = 0.5 - 0.5 * math.cos(2.0 * math.pi * (cycle / period + phase))
    return floor + (1.0 - floor) * rel


def iter_poisson(*, seed: int, mean_interval: float, start: int = 0):
    """Infinite Poisson arrival generator — prefix-identical to
    :func:`.arrivals.poisson` (same seed, same tags, same rounding)."""
    if mean_interval <= 0:
        raise ValueError(f"mean_interval {mean_interval} <= 0")
    t = float(start)
    for i in itertools.count():
        t += _exp_gap(seed, mean_interval, _POISSON_TAG, i)
        yield int(round(t))


def iter_on_off(*, seed: int, burst_interval: float, on_mean: float,
                off_mean: float, start: int = 0):
    """Infinite Markov-modulated on-off generator — prefix-identical to
    :func:`.arrivals.on_off` (same dwell/arrival counters, straddling
    gap residual included)."""
    for name, v in (("burst_interval", burst_interval),
                    ("on_mean", on_mean), ("off_mean", off_mean)):
        if v <= 0:
            raise ValueError(f"{name} {v} <= 0")
    t = float(start)
    dwell = 0
    i = 0
    next_gap = _exp_gap(seed, burst_interval, _ON_ARRIVAL_TAG, i)
    while True:
        on_end = t + _exp_gap(seed, on_mean, _ON_DWELL_TAG, dwell)
        while t + next_gap <= on_end:
            t += next_gap
            yield int(round(t))
            i += 1
            next_gap = _exp_gap(seed, burst_interval, _ON_ARRIVAL_TAG, i)
        next_gap -= on_end - t
        t = on_end + _exp_gap(seed, off_mean, _OFF_DWELL_TAG, dwell + 1)
        dwell += 2


def modulate(stream, *, seed: int, period: int, floor: float = 0.15,
             phase: float = 0.0):
    """Thin a sorted arrival stream by the day curve (Lewis–Shedler):
    candidate ``i`` at cycle ``t_i`` survives iff ``U(seed, i) <
    day_curve(t_i)``.  The acceptance draw is keyed by the *candidate*
    index, so the thinned stream inherits the base stream's prefix
    stability.  Thinning a peak-rate Poisson stream gives an exact
    non-homogeneous Poisson at the day-shaped intensity."""
    for i, t in enumerate(stream):
        if counter_uniform(seed, _THIN_TAG, i) < day_curve(
            t, period=period, floor=floor, phase=phase
        ):
            yield t


def diurnal(*, seed: int, peak_interval: float, period: int,
            floor: float = 0.15, phase: float = 0.0, start: int = 0):
    """Day-shaped Poisson arrivals: mean interval ``peak_interval`` at
    the midday peak, ``peak_interval / floor`` at the overnight trough
    — ``modulate(iter_poisson(...))`` with shared seed (distinct
    domain tags decorrelate the candidate and acceptance draws)."""
    return modulate(
        iter_poisson(seed=seed, mean_interval=peak_interval, start=start),
        seed=seed, period=period, floor=floor, phase=phase,
    )


def merge(*streams):
    """Lazy heap-merge of sorted arrival streams into one sorted stream
    of ``(cycle, stream_index)`` pairs (ties break by stream order)."""
    def _tag(k, s):
        # bound through default-free closure args, NOT the genexp loop
        # variable — late binding would tag every arrival with the last
        # stream index
        return ((t, k) for t in s)

    return heapq.merge(*(_tag(k, s) for k, s in enumerate(streams)))


def take(stream, n: int) -> list[int]:
    """Materialize the first ``n`` arrivals (trace-building helper)."""
    return list(itertools.islice(stream, int(n)))


def take_until(stream, end_cycle: int):
    """Yield arrivals strictly before ``end_cycle`` — how an infinite
    stream becomes a bounded run without picking a count."""
    for t in stream:
        if t >= end_cycle:
            return
        yield t


def stream_requests(streams, *, until: int | None = None,
                    limit: int | None = None):
    """Compose per-class arrival generators into the sorted lazy
    ``(cycle, kind, payload, kw)`` feed that
    :func:`repro_torch.workload.replay.replay_stream` drives — the streaming
    analogue of :func:`repro_torch.workload.trace.from_streams` + ``replay``,
    with nothing materialized.

    Each stream dict: ``kind`` (adapter kind), ``arrivals`` (a sorted,
    possibly infinite iterable of cycles), ``payload`` (a spec dict, or
    a callable ``index -> spec`` for per-request variation), optional
    ``qos`` (default: the kind) and ``deadline_cycles`` (relative, like
    trace schema v1).  ``until`` stops at a cycle bound, ``limit`` at a
    request count — give at least one when any stream is infinite.
    """
    streams = list(streams)
    for s in streams:
        if "kind" not in s or "arrivals" not in s or "payload" not in s:
            raise ValueError(
                f"stream needs kind/arrivals/payload keys, got "
                f"{sorted(s)}"
            )
    per_stream_idx = [0] * len(streams)
    emitted = 0
    for t, k in merge(*(s["arrivals"] for s in streams)):
        if until is not None and t >= until:
            return
        s = streams[k]
        i = per_stream_idx[k]
        per_stream_idx[k] += 1
        payload = s["payload"](i) if callable(s["payload"]) \
            else dict(s["payload"])
        kw = dict(qos=s.get("qos", s["kind"]))
        if s.get("deadline_cycles") is not None:
            kw["deadline_cycles"] = int(s["deadline_cycles"])
        yield int(t), s["kind"], payload, kw
        emitted += 1
        if limit is not None and emitted >= limit:
            return
