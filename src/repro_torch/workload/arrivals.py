"""Seeded open-loop arrival processes on the modeled cycle clock.

A load generator for the serving gateway must be *open-loop* (arrivals do
not wait for completions — the classic closed-loop bench bug that hides
queueing collapse) and *reproducible* (a trace regenerated from its seed
is bit-identical, so benches and CI replay the same traffic forever).

Every process here is a pure function of ``(seed, index)`` via a
counter-based PRNG (SplitMix64 mixing of the seed and a draw counter —
the same construction counter-mode Philox/Threefry engines use): no
stateful generator object, no global RNG, and — per the repo's modeled-
clock discipline — no wall-clock anywhere.  All timestamps are integer
**modeled cycles** (the relation-(2) clock of ``core.cycle_model``, 100
cycles per microsecond at the paper's 100 MHz).

Three process families cover the serving-paper traffic shapes:

``deterministic``
    Evenly spaced arrivals — the isolation baseline.
``poisson``
    Memoryless arrivals at a mean interval: exponential gaps by inverse-
    CDF over counter-PRNG uniforms.
``on_off``
    A two-state Markov-modulated Poisson process: exponentially
    distributed ON dwells emitting Poisson arrivals, silent OFF dwells —
    the bursty shape that separates fair-share from FIFO and preemptive
    from atomic execution in the gateway bench.
"""
from __future__ import annotations

import math

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One SplitMix64 output for counter ``x`` — the standard 64-bit
    finalizer (Steele et al.), bijective and well-mixed."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64


def counter_uniform(seed: int, *counters: int) -> float:
    """Uniform in [0, 1) as a pure function of ``(seed, *counters)``.

    Folds the seed and each counter through SplitMix64 (chained, so
    distinct counter tuples decorrelate) and keeps 53 mantissa bits."""
    h = _splitmix64(int(seed) & _M64)
    for c in counters:
        h = _splitmix64(h ^ (int(c) & _M64))
    return (h >> 11) / float(1 << 53)


def _exp_gap(seed: int, mean: float, *counters: int) -> float:
    """Exponential inter-arrival gap by inverse CDF (never returns inf:
    the uniform is drawn in (0, 1])."""
    u = 1.0 - counter_uniform(seed, *counters)
    return -mean * math.log(u)


def deterministic(n: int, *, interval: int, start: int = 0) -> list[int]:
    """``n`` evenly spaced arrivals: ``start, start+interval, ...``."""
    if n < 0:
        raise ValueError(f"n {n} < 0")
    if interval < 1:
        raise ValueError(f"interval {interval} < 1 cycle")
    return [start + i * int(interval) for i in range(n)]


def poisson(n: int, *, mean_interval: float, seed: int,
            start: int = 0) -> list[int]:
    """``n`` Poisson arrivals at ``mean_interval`` modeled cycles between
    arrivals (rate = 1/mean_interval), stamped from ``start``.

    Arrival ``i`` is the rounded cumulative sum of ``i+1`` exponential
    gaps, each a pure function of ``(seed, i)`` — same seed, same trace.
    """
    if n < 0:
        raise ValueError(f"n {n} < 0")
    if mean_interval <= 0:
        raise ValueError(f"mean_interval {mean_interval} <= 0")
    out: list[int] = []
    t = float(start)
    for i in range(n):
        t += _exp_gap(seed, mean_interval, 0x9015504E, i)
        out.append(int(round(t)))
    return out


def on_off(
    n: int,
    *,
    seed: int,
    burst_interval: float,
    on_mean: float,
    off_mean: float,
    start: int = 0,
) -> list[int]:
    """``n`` arrivals from a two-state Markov-modulated Poisson process.

    The source alternates exponentially distributed ON dwells (mean
    ``on_mean`` cycles) emitting Poisson arrivals at ``burst_interval``
    mean spacing, and silent OFF dwells (mean ``off_mean``).  The process
    starts ON at ``start``.  Dwell ``d`` and arrival ``i`` are pure
    functions of ``(seed, d)`` / ``(seed, i)``, so truncating or extending
    ``n`` never reshuffles earlier arrivals.
    """
    if n < 0:
        raise ValueError(f"n {n} < 0")
    for name, v in (("burst_interval", burst_interval),
                    ("on_mean", on_mean), ("off_mean", off_mean)):
        if v <= 0:
            raise ValueError(f"{name} {v} <= 0")
    out: list[int] = []
    t = float(start)  # current clock
    dwell = 0  # dwell counter (even = ON, odd = OFF)
    i = 0  # arrival counter
    next_gap = _exp_gap(seed, burst_interval, 0x0A44117A, i)
    while len(out) < n:
        on_len = _exp_gap(seed, on_mean, 0x00FFDEAD, dwell)
        on_end = t + on_len
        # emit arrivals that land inside this ON dwell
        while len(out) < n and t + next_gap <= on_end:
            t += next_gap
            out.append(int(round(t)))
            i += 1
            next_gap = _exp_gap(seed, burst_interval, 0x0A44117A, i)
        if len(out) >= n:
            break
        # the pending gap straddles the OFF dwell: the residual carries
        next_gap -= on_end - t
        t = on_end + _exp_gap(seed, off_mean, 0x0FF0FF00, dwell + 1)
        dwell += 2
    return out


PROCESSES = ("deterministic", "poisson", "on_off")


def generate(process: str, n: int, **kw) -> list[int]:
    """Dispatch by name (the trace builder's serialization-friendly
    surface): ``generate('poisson', 100, mean_interval=5e5, seed=7)``."""
    if process == "deterministic":
        return deterministic(n, **kw)
    if process == "poisson":
        return poisson(n, **kw)
    if process == "on_off":
        return on_off(n, **kw)
    raise ValueError(f"unknown arrival process {process!r}; one of {PROCESSES}")
