"""Cycle-accurate analytical model of the FPGA accelerator (relations 2, 3).

This reproduces the paper's performance model exactly as printed:

  relation (2):  cycles = (delta_x+ + p_out + ceil(log2 T_N))
                          * ceil(n_conv / KPBs) * ceil(N / T_N)
  relation (3):  n_conv = (floor((R + 2P - k)/S) + 1)
                          * (floor((C + 2P - k)/S) + 1) * ceil(M / T_M)

with delta_x+ = 2, p_out = 2n + ceil(log2 T_N) = 21 (n=8, T_N=32), KPBs=16,
T_M=1 — applied layer-by-layer to U-Net, plus the analytical latency of the
*cascaded* MSDF design the paper improves on
(delta_x + delta_+ * ceil(log2 T_N) + p_out per tile, Sec. 3.2).

The U-Net workload is under-specified in the paper (no layer table).  We
therefore *calibrate*: search standard U-Net configurations for the one whose
relation-(2) time and GOPS jointly match Table 1's proposed-design row
(53.25 ms, 52.95 GOPS), and report the calibrated config + residuals in
EXPERIMENTS.md.  Baseline rows of Table 1 (bit-parallel, bit-serial, MSDF,
CPU, GPU) are cited measurements from [12],[13],[11]; we reproduce their
*derived* columns (GOPS, GOPS/W, energy = P*t) and check internal
consistency.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

# ---- paper constants -------------------------------------------------------
N_BITS = 8
T_N = 32
T_M = 1
KPBS = 16
K = 3
DELTA_MMA = 2  # merged multiply-add initial delay (delta_x+)
DELTA_ADD = 2  # online adder initial delay (delta_+)
DELTA_MUL = 3  # standalone online multiplier initial delay (delta_x)
FREQ_HZ = 100e6


def p_out(n_bits: int = N_BITS, t_n: int = T_N) -> int:
    return 2 * n_bits + math.ceil(math.log2(t_n))


def mma_tile_cycles(n_bits: int = N_BITS, t_n: int = T_N) -> int:
    """Inner term of relation (2): cycles per output tile, merged design."""
    return DELTA_MMA + p_out(n_bits, t_n) + math.ceil(math.log2(t_n))


def cascaded_tile_cycles(n_bits: int = N_BITS, t_n: int = T_N) -> int:
    """Per-tile cycles of the un-merged design (Sec. 3.2): the multiplier and
    every adder-tree level each pay their own initial delay."""
    return DELTA_MUL + DELTA_ADD * math.ceil(math.log2(t_n)) + p_out(n_bits, t_n)


def pipelined_tile_cycles(n_bits: int = N_BITS) -> int:
    """Steady-state pipelined initiation interval: a new output every 2n
    digit slots (the output stream is 2n+log2(T_N) digits, of which log2(T_N)
    overlap the next tile's initial delay + tree fill).

    Calibration finding (see EXPERIMENTS.md §Table1): relation (2) as printed
    (28 cycles/tile) reproduces Table 1's *time* but not its *GOPS*; the two
    columns are jointly consistent only under a ~16-cycle effective interval
    — i.e. Table 1 assumes pipelined steady-state throughput while relation
    (2) states per-output latency.  We model both.
    """
    return 2 * n_bits


@dataclass(frozen=True)
class ConvLayerSpec:
    """One conv layer: input H x W x Cin -> Cout, k x k, stride S, pad P."""

    h: int
    w: int
    cin: int
    cout: int
    k: int = K
    stride: int = 1
    pad: int = 1

    @property
    def out_h(self) -> int:
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.w + 2 * self.pad - self.k) // self.stride + 1

    def n_conv(self, t_m: int = T_M) -> int:
        """Relation (3)."""
        return self.out_h * self.out_w * math.ceil(self.cout / t_m)

    def macs(self) -> int:
        return self.out_h * self.out_w * self.cout * self.cin * self.k * self.k

    def ops(self) -> int:
        return 2 * self.macs()

    def cycles(self, *, tile_cycles: int | None = None, kpbs: int = KPBS) -> int:
        """Relation (2) for this layer."""
        tc = mma_tile_cycles() if tile_cycles is None else tile_cycles
        return (
            tc * math.ceil(self.n_conv() / kpbs) * math.ceil(self.cin / T_N)
        )


def unet_conv_layers(
    hw: int | tuple[int, int] = 128,
    in_ch: int = 4,
    base: int = 32,
    depth: int = 4,
    convs_per_stage: int = 2,
) -> list[ConvLayerSpec]:
    """Standard U-Net 3x3 conv stack (encoder/bottleneck/decoder with skip
    concatenation).  2x2 up/down-sampling and the final 1x1 conv are not k=3
    convolutions and run off the accelerator (paper Sec. 3.1: larger/other
    kernels are decomposed or handled by reconfiguration).

    ``hw`` is a square size or an ``(h, w)`` pair — rectangular geometries
    cost halo tiles of the segmentation server (``repro.segserve``)."""
    layers: list[ConvLayerSpec] = []
    ch = in_ch
    size_h, size_w = (hw, hw) if isinstance(hw, int) else hw
    enc_ch = []
    for d in range(depth):
        c = base * (2**d)
        layers.append(ConvLayerSpec(size_h, size_w, ch, c))
        for _ in range(convs_per_stage - 1):
            layers.append(ConvLayerSpec(size_h, size_w, c, c))
        enc_ch.append(c)
        ch = c
        size_h //= 2
        size_w //= 2
    # bottleneck
    c = base * (2**depth)
    layers.append(ConvLayerSpec(size_h, size_w, ch, c))
    for _ in range(convs_per_stage - 1):
        layers.append(ConvLayerSpec(size_h, size_w, c, c))
    ch = c
    # decoder (skip concat doubles input channels of the first conv)
    for d in reversed(range(depth)):
        size_h *= 2
        size_w *= 2
        c = enc_ch[d]
        layers.append(ConvLayerSpec(size_h, size_w, c + ch, c))
        for _ in range(convs_per_stage - 1):
            layers.append(ConvLayerSpec(size_h, size_w, c, c))
        ch = c
    return layers


def model_cycles(layers: list[ConvLayerSpec], **kw) -> int:
    return sum(l.cycles(**kw) for l in layers)


def model_ops(layers: list[ConvLayerSpec]) -> int:
    return sum(l.ops() for l in layers)


# ---- dynamic precision (per-layer plane schedules) -------------------------
#
# Digit-serial cycles scale with digits consumed: a layer truncated to b MSB
# planes streams b activation digits instead of n=8, so its output stream is
# p_out(b) = 2b + ceil(log2 T_N) digits and relation (2) shrinks layer-by-
# layer under a schedule.  Accelerator power is held at the paper's implied
# constant (GOPS / (GOPS/W)); the energy win comes from finishing earlier —
# a conservative model, since an idle AND-array also burns less dynamic
# power per cycle.


def schedule_tile_cycles(planes: int, *, mode: str = "pipelined") -> int:
    """Per-output-tile cycles of one layer running at ``planes`` digits.

    mode='as_printed': relation (2) verbatim with n := planes.
    mode='pipelined': the 2n steady-state initiation interval (see
    ``pipelined_tile_cycles``), again with n := planes.
    """
    if mode == "as_printed":
        return mma_tile_cycles(n_bits=planes)
    if mode == "pipelined":
        return pipelined_tile_cycles(n_bits=planes)
    raise ValueError(f"unknown mode {mode!r}")


def _planes_for(schedule, i: int) -> int:
    # duck-typed over PlaneSchedule / list / tuple; clamps like
    # PlaneSchedule.planes_for so short schedules degrade gracefully
    return int(schedule[min(i, len(schedule) - 1)])


def schedule_layer_cycles(
    layers: list[ConvLayerSpec], schedule, *, mode: str = "pipelined"
) -> list[int]:
    """Relation (2) per layer under a per-layer plane schedule."""
    return [
        l.cycles(tile_cycles=schedule_tile_cycles(_planes_for(schedule, i), mode=mode))
        for i, l in enumerate(layers)
    ]


def schedule_cycles(
    layers: list[ConvLayerSpec], schedule, *, mode: str = "pipelined"
) -> int:
    return sum(schedule_layer_cycles(layers, schedule, mode=mode))


@functools.lru_cache(maxsize=65536)
def _unet_window_cycles_cached(
    hw: tuple[int, int], in_ch: int, base: int, depth: int,
    convs_per_stage: int, planes: tuple[int, ...], mode: str,
) -> int:
    layers = unet_conv_layers(hw, in_ch, base, depth, convs_per_stage)
    return schedule_cycles(layers, planes, mode=mode)


def unet_window_cycles(
    hw: int | tuple[int, int], in_ch: int, base: int, depth: int,
    convs_per_stage: int, schedule, *, mode: str = "pipelined",
) -> int:
    """Relation-(2) cycles of one U-Net forward over an ``hw`` window under a
    plane schedule, memoized on the (geometry, schedule) signature.  Tiled
    serving and the tile-size autotuner both price thousands of windows drawn
    from a handful of (shape, class-schedule) signatures — the cache turns
    the per-window rebuild of the layer stack into a dict hit."""
    key_hw = (hw, hw) if isinstance(hw, int) else (int(hw[0]), int(hw[1]))
    planes = tuple(int(b) for b in schedule)
    return _unet_window_cycles_cached(
        key_hw, in_ch, base, depth, convs_per_stage, planes, mode
    )


# ---- LM decode pricing (admission-control estimates) -----------------------
#
# The serving gateway co-schedules LM decode and segmentation against one
# modeled cycle budget, so it needs LM work in the same relation-(2)
# currency.  A decode step's block matmuls are priced as 1x1 "convolutions"
# (h = w = 1, k = 1 — relation (3) then counts exactly ceil(cout/T_M) output
# tiles of a plain matvec): the 4 attention projections (q, k, v, o — at
# their true head widths when ``n_heads``/``head_dim``/``n_kv_heads`` are
# given, GQA included), the attention score (q·K^T) and value (p·V)
# products against a ``context``-token cache, optional MoE routing (the
# router matmul plus ``top_k`` expert FFN passes instead of one dense
# pair), and the FFN matmuls.  With the attention/MoE kwargs omitted the
# itemization degrades to the original projections-plus-FFN estimate, so
# existing callers and goldens are unchanged.  Family quirks that are not
# matmuls (ssm scans, softmax, RoPE) remain un-itemized — they are not
# accelerator AND-array work in the paper's model.


def lm_block_layers(
    d_model: int,
    d_ff: int,
    *,
    n_heads: int | None = None,
    head_dim: int | None = None,
    n_kv_heads: int | None = None,
    context: int = 0,
    n_experts: int = 0,
    top_k: int = 1,
) -> list[ConvLayerSpec]:
    """One transformer block's decode-step matmuls as 1x1-conv specs.

    ``context`` > 0 (with ``n_heads``) itemizes the attention score/value
    products against a cache of that many tokens; ``n_experts`` > 0
    itemizes MoE routing (router matmul + ``top_k`` expert FFN passes).
    """
    if n_heads is None:
        q_width = kv_width = d_model
    else:
        hd = head_dim or d_model // n_heads
        q_width = n_heads * hd
        kv_width = (n_kv_heads or n_heads) * hd
    layers = [
        ConvLayerSpec(1, 1, d_model, q_width, k=1, pad=0),  # wq
        ConvLayerSpec(1, 1, d_model, kv_width, k=1, pad=0),  # wk
        ConvLayerSpec(1, 1, d_model, kv_width, k=1, pad=0),  # wv
        ConvLayerSpec(1, 1, q_width, d_model, k=1, pad=0),  # wo
    ]
    if context > 0 and n_heads:
        hd = head_dim or d_model // n_heads
        # q·K^T: per head a (1, hd)·(hd, T) matvec — T outputs contracting
        # over hd; p·V: (1, T)·(T, hd) — hd outputs contracting over T.
        layers.append(
            ConvLayerSpec(1, 1, hd, n_heads * context, k=1, pad=0)
        )
        layers.append(
            ConvLayerSpec(1, 1, context, n_heads * hd, k=1, pad=0)
        )
    ffn_passes = 1
    if n_experts > 0:
        layers.append(ConvLayerSpec(1, 1, d_model, n_experts, k=1, pad=0))
        ffn_passes = max(1, int(top_k))
    for _ in range(ffn_passes):
        layers.append(ConvLayerSpec(1, 1, d_model, d_ff, k=1, pad=0))
        layers.append(ConvLayerSpec(1, 1, d_ff, d_model, k=1, pad=0))
    return layers


@functools.lru_cache(maxsize=4096)
def _lm_step_cycles_cached(
    d_model: int, d_ff: int, n_layers: int, planes: tuple[int, ...],
    mode: str, attn_kw: tuple,
) -> int:
    total = 0
    specs = lm_block_layers(d_model, d_ff, **dict(attn_kw))
    for l in range(n_layers):
        tc = schedule_tile_cycles(_planes_for(planes, l), mode=mode)
        total += sum(spec.cycles(tile_cycles=tc) for spec in specs)
    return total


def lm_step_cycles(
    d_model: int, d_ff: int, n_layers: int, schedule=None, *,
    mode: str = "pipelined", **attn_kw,
) -> int:
    """Relation-(2) cycles of one decode step (one token, one sequence)
    through an ``n_layers`` block stack under a per-layer plane schedule
    (``None`` = full ``N_BITS`` digits everywhere), memoized on the
    signature like :func:`unet_window_cycles`.  Extra keyword args
    (``n_heads``/``head_dim``/``n_kv_heads``/``context``/``n_experts``/
    ``top_k``) pass through to :func:`lm_block_layers` for the sharper
    attention/MoE itemization."""
    planes = (
        (N_BITS,) * n_layers if schedule is None
        else tuple(int(b) for b in schedule)
    )
    return _lm_step_cycles_cached(
        d_model, d_ff, n_layers, planes, mode, tuple(sorted(attn_kw.items()))
    )


def lm_step_ops(d_model: int, d_ff: int, n_layers: int, **attn_kw) -> int:
    """Useful MAC ops of one decode step (same itemization as the cycles)."""
    return n_layers * sum(
        l.ops() for l in lm_block_layers(d_model, d_ff, **attn_kw)
    )


def lm_layer_cycles(
    d_model: int, d_ff: int, n_layers: int, schedule=None, *,
    mode: str = "pipelined", **attn_kw,
) -> list[int]:
    """Per-layer relation-(2) cycles of one decode step under a plane
    schedule — the itemization :func:`lm_step_cycles` sums.  The maximum
    entry is the layer-pipeline initiation interval of a multi-token pass
    whose inputs are known in advance (:func:`lm_spec_step_cycles`)."""
    planes = (
        (N_BITS,) * n_layers if schedule is None
        else tuple(int(b) for b in schedule)
    )
    specs = lm_block_layers(d_model, d_ff, **attn_kw)
    return [
        sum(
            spec.cycles(
                tile_cycles=schedule_tile_cycles(
                    _planes_for(planes, l), mode=mode
                )
            )
            for spec in specs
        )
        for l in range(n_layers)
    ]


# ---- speculative decode pricing --------------------------------------------
#
# The precision-speculative engine (repro.serve.specdecode) runs each decode
# round in two passes: a k-token *draft* chain under a truncated-plane
# schedule (greedy feedback — token t+1 needs token t's logits, so the k
# steps serialize at the draft schedule's step price), then one *verify*
# pass of the k+1 now-known tokens through the full-digit schedule.  The
# verify tokens have no feedback dependency, so consecutive positions
# pipeline through the layer stack: position t+1 enters layer l as soon as
# position t leaves it, and the pass costs one full step plus k initiation
# intervals (the widest layer's cycles) instead of k+1 full steps.  Only
# the emitted (accepted + one corrected) tokens earn op credit; every cycle
# of both passes counts toward time — rejected speculation is honest waste,
# so GOPS/W degrades with the miss rate instead of hiding it.


def lm_spec_step_cycles(
    d_model: int, d_ff: int, n_layers: int, *, k: int, draft_schedule,
    schedule=None, accepted: int | None = None, mode: str = "pipelined",
    **attn_kw,
) -> dict:
    """Relation-(2) account of one speculative decode round (one slot).

    ``k`` draft tokens priced at the ``draft_schedule`` step cost, one
    layer-pipelined verify pass of ``k+1`` known tokens at the full
    ``schedule`` (``None`` = uniform ``N_BITS``).  With ``accepted`` given
    (0..k drafts survived verification) the account splits integer-exactly
    into useful and wasted cycles: each rejected draft position wastes its
    draft step plus its verify pipeline interval, and
    ``useful + wasted == total`` always.
    """
    if int(k) < 0:
        raise ValueError(f"k {k} < 0")
    k = int(k)
    draft_step = lm_step_cycles(
        d_model, d_ff, n_layers, tuple(int(b) for b in draft_schedule),
        mode=mode, **attn_kw,
    )
    full_step = lm_step_cycles(
        d_model, d_ff, n_layers, schedule, mode=mode, **attn_kw
    )
    interval = max(
        lm_layer_cycles(d_model, d_ff, n_layers, schedule, mode=mode,
                        **attn_kw)
    )
    draft_cycles = k * draft_step
    verify_cycles = full_step + k * interval
    out = dict(
        k=k,
        draft_step_cycles=draft_step,
        full_step_cycles=full_step,
        interval_cycles=interval,
        draft_cycles=draft_cycles,
        verify_cycles=verify_cycles,
        total_cycles=draft_cycles + verify_cycles,
    )
    if accepted is not None:
        a = int(accepted)
        if not (0 <= a <= k):
            raise ValueError(f"accepted {a} outside 0..{k}")
        wasted = (k - a) * (draft_step + interval)
        out.update(
            accepted=a,
            tokens=a + 1,
            wasted_cycles=wasted,
            useful_cycles=out["total_cycles"] - wasted,
            baseline_cycles=(a + 1) * full_step,
        )
    return out


@dataclass
class PlatformRow:
    """One column of Table 1.  Derived metrics follow the paper's
    definitions: GOPS = ops/time, GOPS/W = GOPS/power, energy = power*time."""

    name: str
    time_ms: float
    power_w: float
    ops: int
    freq_mhz: float | None = None
    slices: int | None = None

    @property
    def gops(self) -> float:
        return self.ops / (self.time_ms * 1e-3) / 1e9

    @property
    def gops_per_w(self) -> float:
        return self.gops / self.power_w

    @property
    def energy_mj(self) -> float:
        return self.power_w * self.time_ms

    @property
    def gops_per_slice_e4(self) -> float | None:
        if self.slices is None:
            return None
        return self.gops / self.slices * 1e4


# Table 1 as printed (for validation targets). Power back-derived from
# GOPS / (GOPS/W); slices back-derived from GOPS / (GOPS/slice).
PAPER_TABLE1 = {
    "bit_parallel": dict(time_ms=57.20, gops=49.30, gops_w=2.65, e_mj=1064.43, aeff=10.59),
    "bit_serial": dict(time_ms=232.26, gops=12.14, gops_w=0.88, e_mj=3210.81, aeff=3.98),
    "msdf": dict(time_ms=133.94, gops=21.05, gops_w=3.01, e_mj=1644.77, aeff=2.61),
    "gpu": dict(time_ms=7.31, gops=385.99, gops_w=5.51, e_mj=511.35, aeff=None),
    "cpu": dict(time_ms=58.42, gops=48.27, gops_w=1.93, e_mj=1460.48, aeff=None),
    "proposed": dict(time_ms=53.25, gops=52.95, gops_w=15.14, e_mj=186.20, aeff=17.43),
}


def proposed_row(layers: list[ConvLayerSpec]) -> PlatformRow:
    """The proposed design, from relations (2)+(3) at 100 MHz.  Power is the
    paper's implied accelerator power (GOPS / (GOPS/W) = 3.497 W)."""
    cyc = model_cycles(layers)
    t_ms = cyc / FREQ_HZ * 1e3
    power = PAPER_TABLE1["proposed"]["gops"] / PAPER_TABLE1["proposed"]["gops_w"]
    slices = PAPER_TABLE1["proposed"]["gops"] / (PAPER_TABLE1["proposed"]["aeff"] * 1e-4)
    return PlatformRow(
        "proposed(model)", t_ms, power, model_ops(layers), freq_mhz=100, slices=int(slices)
    )


def schedule_row(
    layers: list[ConvLayerSpec],
    schedule,
    *,
    mode: str = "pipelined",
    name: str | None = None,
) -> PlatformRow:
    """Table-1-style row for the proposed design under a plane schedule:
    time from per-layer relation (2), ops counted at full precision (the
    schedule delivers the same outputs, just with fewer digits), power the
    paper's implied constant — so GOPS and GOPS/W scale with the speedup."""
    cyc = schedule_cycles(layers, schedule, mode=mode)
    t_ms = cyc / FREQ_HZ * 1e3
    power = PAPER_TABLE1["proposed"]["gops"] / PAPER_TABLE1["proposed"]["gops_w"]
    if name is None:
        name = f"proposed(sched-{'-'.join(str(_planes_for(schedule, i)) for i in range(len(layers)))})"
    return PlatformRow(name, t_ms, power, model_ops(layers), freq_mhz=100)


def cascaded_row(layers: list[ConvLayerSpec]) -> PlatformRow:
    """Same datapath but un-merged (multiplier + adder tree each with own
    initial delay) — the paper's own analytical comparison, Sec. 3.2."""
    tc = cascaded_tile_cycles()
    cyc = model_cycles(layers, tile_cycles=tc)
    t_ms = cyc / FREQ_HZ * 1e3
    power = PAPER_TABLE1["msdf"]["gops"] / PAPER_TABLE1["msdf"]["gops_w"]
    return PlatformRow("cascaded-msdf(model)", t_ms, power, model_ops(layers), freq_mhz=100)


def calibrate_unet(
    target_time_ms: float = 53.25,
    target_gops: float = 52.95,
    mode: str = "pipelined",
) -> tuple[dict, list[ConvLayerSpec], float, float]:
    """Search standard U-Net configs for the joint best match of Table 1's
    (time, GOPS); returns (config, layers, time_err%, gops_err%).

    mode='as_printed' uses relation (2) verbatim (28 cycles/tile; matches
    Table 1 time only), mode='pipelined' uses the 2n-cycle steady-state
    interval (jointly matches time and GOPS — see ``pipelined_tile_cycles``).
    """
    tile = mma_tile_cycles() if mode == "as_printed" else pipelined_tile_cycles()
    best = None
    for hw in (64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256):
        for in_ch in (1, 3, 4):
            for base in (8, 16, 24, 32, 48, 64):
                for depth in (3, 4, 5):
                    for cps in (1, 2):
                        if hw % (2**depth):
                            continue
                        layers = unet_conv_layers(hw, in_ch, base, depth, cps)
                        cyc = model_cycles(layers, tile_cycles=tile)
                        t_ms = cyc / FREQ_HZ * 1e3
                        gops = model_ops(layers) / (t_ms * 1e-3) / 1e9
                        e_t = abs(t_ms - target_time_ms) / target_time_ms
                        e_g = abs(gops - target_gops) / target_gops
                        err = e_t + (e_g if mode == "pipelined" else 0.0)
                        cfg = dict(hw=hw, in_ch=in_ch, base=base, depth=depth, convs_per_stage=cps)
                        if best is None or err < best[0]:
                            best = (err, cfg, layers, e_t * 100, e_g * 100)
    assert best is not None
    return best[1], best[2], best[3], best[4]


# The calibrated U-Net used throughout (mode='pipelined'):
#   input 80x80x4, base 48, depth 3, one 3x3 conv per stage
#   -> 53.76 ms (+1.0%) and 52.25 GOPS (-1.3%) vs Table 1.
CALIBRATED_UNET = dict(hw=80, in_ch=4, base=48, depth=3, convs_per_stage=1)
