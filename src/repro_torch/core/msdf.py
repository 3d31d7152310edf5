"""Cycle-level, bit-exact reference model of the paper's MSDF datapath.

This module reproduces the FPGA arithmetic *functionally*, cycle by cycle:

* signed-digit (SD) radix-2 digits in {-1, 0, 1} (the paper's redundant
  number system; we model digit *values*, the 2-bit IEN encoding is a
  gate-level detail with no arithmetic content),
* the merged multiply-add (MMA) unit of Sec. 3.2: per cycle it consumes one
  activation bit-plane across T_N channels (the AND-gate array), adds the
  partial products together with the left-shifted residual of the previous
  cycle, and — after an initial delay of delta = 2 cycles — emits one output
  digit per cycle through the output generation function (OGF),
* the MSDF online adder (delta = 2) and the KPB adder tree that combines the
  k*k = 9 MMA outputs (Eq. 1).

It is NOT part of the CUDA compute path (SD redundancy solves an FPGA
carry-chain problem that the GPU's integer tensor cores do not have); it
exists to

* prove the bit-plane datapath computes the same function the hardware
  does (tests assert bit-exact equality against integer dot products), and
* let the cycle model (``cycle_model.py``) cross-check relation (2)'s
  latency against a measured cycle count from this simulator.

Digit-selection rule: the classic online "round the residual" selection.
When emitting the digit of weight ``t`` the unit holds residual ``R`` (the
part of the final value not yet emitted, based on inputs seen so far) and
chooses ``d = +1 if R >= t/2, -1 if R <= -t/2, else 0``.  The redundancy of
the SD digit set absorbs the still-unseen input tail; the invariant
``|R| <= t`` before each selection (checked by tests) guarantees the final
residual is exactly zero, i.e. the digit stream reconstructs the value
exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

DELTA_MMA = 2  # initial delay of the merged unit (paper: delta_x+ = 2)
DELTA_ADD = 2  # initial delay of the MSDF online adder (paper: delta_+)
DELTA_MUL = 3  # initial delay of a standalone online multiplier (baseline)


def sd_to_int(digits: list[int], msb_weight: int) -> int:
    """Value of an SD digit stream whose first digit has weight 2**msb_weight."""
    return sum(d * (2 ** (msb_weight - j)) for j, d in enumerate(digits))


@dataclass
class OnlineSerializer:
    """Generic MSDF emitter: consumes additive integer contributions with
    geometrically decreasing magnitude, emits SD digits MSB-first after an
    initial delay.  Both the MMA's OGF and the online adder instantiate it.

    Attributes:
      msb_weight: weight (power of two) of the first emitted digit.
      n_digits: total digits to emit (p_out).
      delay: initial delay in cycles before the first digit.
    """

    msb_weight: int
    n_digits: int
    delay: int
    residual: int = 0
    cycle: int = 0
    digits: list[int] = field(default_factory=list)
    max_abs_residual: int = 0  # instrumentation for the boundedness invariant

    def step(self, contribution: int = 0) -> int | None:
        """One clock cycle: absorb ``contribution`` and maybe emit a digit."""
        self.residual += int(contribution)
        out = None
        if self.cycle >= self.delay and len(self.digits) < self.n_digits:
            k = len(self.digits)
            t = 2 ** (self.msb_weight - k)
            r = self.residual
            half = (t + 1) // 2
            if r >= half:
                d = 1
            elif r <= -half:
                d = -1
            else:
                d = 0
            self.residual -= d * t
            self.digits.append(d)
            out = d
        self.max_abs_residual = max(self.max_abs_residual, abs(self.residual))
        self.cycle += 1
        return out

    @property
    def done(self) -> bool:
        return len(self.digits) == self.n_digits

    def value(self) -> int:
        return sd_to_int(self.digits, self.msb_weight)


@dataclass
class MMAUnit:
    """The merged multiply-add unit (Fig. 2) for ``t_n`` channels, n=8 bits.

    Per cycle: AND-gate array selects weights by the current activation bit
    (MSB first), the adder tree sums the 32 partial products *plus* the
    left-shifted residual of the previous cycle, and the OGF emits one SD
    digit (after the single merged initial delay of 2 cycles) — versus the
    cascaded design where the multiplier and every adder-tree level each pay
    their own delay.
    """

    weights: np.ndarray  # (t_n,) int8
    n_bits: int = 8
    t_n: int = 32

    def __post_init__(self):
        assert self.weights.shape == (self.t_n,)
        # p_out = 2n + ceil(log2(T_N)) digits cover the full product range.
        self.p_out = 2 * self.n_bits + math.ceil(math.log2(self.t_n))
        self.ogf = OnlineSerializer(
            msb_weight=self.p_out - 1, n_digits=self.p_out, delay=DELTA_MMA
        )
        self._bit = 0

    def step(self, act_bits: np.ndarray | None) -> int | None:
        """One cycle.  ``act_bits``: (t_n,) 0/1 vector — the b-th bit plane of
        all channels (MSB first) — or None once all 8 planes are consumed."""
        contribution = 0
        if act_bits is not None:
            # AND-gate array + adder tree: sum of selected weights, at the
            # weight of the current bit plane.
            p = int(np.dot(act_bits.astype(np.int64), self.weights.astype(np.int64)))
            contribution = p * (2 ** (self.n_bits - 1 - self._bit))
            self._bit += 1
        return self.ogf.step(contribution)

    def run(self, activations: np.ndarray) -> tuple[int, int]:
        """Feed 8-bit unsigned activations bit-serially; returns (value, cycles)."""
        assert activations.shape == (self.t_n,)
        cycles = 0
        for b in range(self.n_bits - 1, -1, -1):  # MSB first
            bits = (activations.astype(np.int64) >> b) & 1
            self.step(bits)
            cycles += 1
        while not self.ogf.done:
            self.step(None)
            cycles += 1
        return self.ogf.value(), cycles


@dataclass
class OnlineAdder:
    """MSDF online adder: consumes one SD digit from each operand per cycle,
    emits the sum's SD digits with initial delay DELTA_ADD after the first
    input digit arrives (``start`` = absolute cycle of the first input).

    Digit growth: a true SD carry-free adder grows the range by one digit;
    our generic round-the-residual selection needs |R| <= 1.5*t at every
    selection, which requires TWO leading digits of headroom (GROWTH = 2).
    Arithmetic values are identical; only the stream is one digit longer —
    noted as a conservative modeling choice in DESIGN.md.
    """

    GROWTH = 2

    msb_weight: int  # of the *inputs*
    n_digits: int  # of the *inputs*
    start: int = 0  # absolute cycle at which input digits begin

    def __post_init__(self):
        self.out = OnlineSerializer(
            msb_weight=self.msb_weight + self.GROWTH,
            n_digits=self.n_digits + self.GROWTH,
            delay=self.start + DELTA_ADD,
        )
        self._j = 0

    def step(self, dx: int | None, dy: int | None) -> int | None:
        c = 0
        if dx is not None or dy is not None:
            w = 2 ** (self.msb_weight - self._j)
            c = ((dx or 0) + (dy or 0)) * w
            self._j += 1
        return self.out.step(c)


def kpb_inner_product(
    activations: np.ndarray, weights: np.ndarray, t_n: int = 32
) -> tuple[int, int]:
    """Cycle-accurate Kernel Processing Block: k*k MMA units + the MSDF adder
    tree (Eq. 1).  ``activations``/``weights``: (k*k, t_n) uint8 / int8.

    Returns (inner product value, total cycles from first input bit to last
    output digit) — the measured counterpart of relation (2)'s per-output
    latency term.
    """
    taps, tn = activations.shape
    assert weights.shape == (taps, tn)
    n_bits = 8

    # Stage 1 — run each MMA, recording its digit timeline (index = cycle;
    # None = no digit that cycle, i.e. the unit is still in its initial
    # delay).  Digit-level pipelining: a digit emitted at cycle c is consumed
    # by the next tree level at cycle c.
    timelines: list[list[int | None]] = []
    mmas = [MMAUnit(weights[j], t_n=tn) for j in range(taps)]
    for j, m in enumerate(mmas):
        tl: list[int | None] = []
        for b in range(n_bits - 1, -1, -1):
            bits = (activations[j].astype(np.int64) >> b) & 1
            tl.append(m.step(bits))
        while not m.ogf.done:
            tl.append(m.step(None))
        timelines.append(tl)

    # Stage 2 — the MSDF adder tree.  All streams entering a level are
    # cycle-synchronized (same first-digit cycle f); each level adds
    # DELTA_ADD cycles of delay and one integer bit of range.  An odd
    # passthrough stream is re-aligned to the level's output timing/weight by
    # delaying it DELTA_ADD cycles and prepending a zero digit.
    level_streams = timelines
    level_msb, level_nd = mmas[0].p_out - 1, mmas[0].p_out
    g = OnlineAdder.GROWTH
    while len(level_streams) > 1:
        f = next(i for i, d in enumerate(level_streams[0]) if d is not None)
        adders = [
            (OnlineAdder(level_msb, level_nd, start=f), i)
            for i in range(0, len(level_streams) - 1, 2)
        ]
        out_streams: list[list[int | None]] = [[] for _ in adders]
        max_t = max(len(s) for s in level_streams) + level_nd + DELTA_ADD + g + 2
        for t in range(max_t):
            for k, (ad, i) in enumerate(adders):
                sx, sy = level_streams[i], level_streams[i + 1]
                dx = sx[t] if t < len(sx) else None
                dy = sy[t] if t < len(sy) else None
                out_streams[k].append(ad.step(dx, dy))
        nxt: list[list[int | None]] = out_streams
        if len(level_streams) % 2:
            # Odd stream passes through: delay by DELTA_ADD to stay aligned
            # with the adder outputs and prepend GROWTH zero digits so its
            # digit weights match the level's new msb weight.
            digits = [d for d in level_streams[-1] if d is not None]
            nxt.append([None] * (f + DELTA_ADD) + [0] * g + digits)  # type: ignore[list-item]
        level_streams = nxt
        level_msb += g
        level_nd += g

    final = [d for d in level_streams[0] if d is not None]
    last_idx = max(i for i, d in enumerate(level_streams[0]) if d is not None)
    return sd_to_int(final, level_msb), last_idx + 1
