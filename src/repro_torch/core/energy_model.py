"""Integer fixed-point (pJ-scale) energy costing for the modeled datapath.

:mod:`repro.core.cycle_model` prices *time* — relation-(2) cycles on the
100 MHz modeled clock — and until now energy appeared only as
``PlatformRow.energy_mj = power x time`` with power held at the paper's
implied constant (Table 1 proposed: GOPS / (GOPS/W) = 52.95 / 15.14
= 3.497 W).  That constant hides the two effects the paper (and MINT's
dynamic-precision MSDF inference) actually exploit:

* **Plane-proportional dynamic energy.**  A layer truncated to ``b``
  MSB planes streams ``b`` activation digits, so its AND-array/digit
  path both runs for fewer cycles (``schedule_tile_cycles``: the 2b
  steady-state initiation interval) *and* switches a ``b``-plane-deep
  digit pipeline each of those cycles.  Dynamic energy therefore scales
  ~quadratically with the plane budget (cycles x per-cycle switching),
  which is exactly the "energy win beyond finishing earlier" the
  cycle-model comment conservatively declined to claim.
* **Static energy charged per clock cycle.**  Leakage + clock tree burn
  every cycle, worked or idle — an idle shard is cheap but not free, so
  fleet sizing trades static floor against dynamic work.

Everything here is **integer picojoules** so the observability layer
(:mod:`repro.obs.energy`) can gate ledger reconciliation exactly the
way cycle accounting already is (``spans`` <-> ``RoundClock`` <->
``FleetLedger``): joule totals are sums of ``int`` pJ, never floats.

Calibration anchor (golden-locked in ``tests/test_energy.py``): one
active cycle at the full n=8 plane budget costs

    ``PJ_STATIC_CYCLE + 8 * PJ_PLANE_CYCLE = 34_973 pJ``

i.e. 3.4973 W sustained at 100 MHz — the paper's implied chip power to
<0.01% — so the modeled full-8 calibrated U-Net reproduces Table 1's
proposed-row GOPS/W (15.14) and energy (186.20 mJ) within the same
~1% family of residuals the cycle calibration already carries.  The
static share (~25% of full-width active power) follows the usual
FPGA split for an AND-array-dominated datapath.
"""
from __future__ import annotations

from . import cycle_model as cm
from .cycle_model import FREQ_HZ, N_BITS, PAPER_TABLE1

#: Dynamic switching energy of one digit plane for one active cycle
#: (AND-array column + online-adder slice + plane mux), integer pJ.
PJ_PLANE_CYCLE = 3_280

#: Static energy (leakage + clock distribution) of one clock cycle,
#: charged whether or not the datapath worked, integer pJ.
PJ_STATIC_CYCLE = 8_733

#: Energy of one active cycle at the full n=8 digit budget — the
#: calibration anchor (== paper-implied 3.497 W at 100 MHz).
PJ_FULL_CYCLE = PJ_STATIC_CYCLE + N_BITS * PJ_PLANE_CYCLE


def active_rate_pj(planes: int = N_BITS) -> int:
    """pJ per *worked* cycle on a datapath switching ``planes`` digit
    planes (static share included — a worked cycle is also a clock
    cycle)."""
    if not 1 <= planes <= N_BITS:
        raise ValueError(f"planes {planes} outside 1..{N_BITS}")
    return PJ_STATIC_CYCLE + planes * PJ_PLANE_CYCLE


def active_pj(cycles: int, planes: int = N_BITS) -> int:
    """Energy of ``cycles`` worked cycles at a ``planes`` digit budget."""
    return int(cycles) * active_rate_pj(planes)


def idle_pj(cycles: int) -> int:
    """Static burn of ``cycles`` un-worked clock cycles."""
    return int(cycles) * PJ_STATIC_CYCLE


def pj_to_j(pj: int) -> float:
    return pj * 1e-12


def pj_to_mj(pj: int) -> float:
    return pj * 1e-9


def modeled_power_w(planes: int = N_BITS) -> float:
    """Sustained power of a fully-active datapath at ``planes`` digits."""
    return active_rate_pj(planes) * FREQ_HZ * 1e-12


def implied_chip_power_w() -> float:
    """The paper's implied constant (Table 1 proposed GOPS / (GOPS/W))
    — what :func:`cm.proposed_row` charges every cycle regardless of
    activity.  The meter's static/dynamic split refines this."""
    row = PAPER_TABLE1["proposed"]
    return row["gops"] / row["gops_w"]


def metered_gops_per_w(ops: int, pj: int) -> float | None:
    """GOPS/W from an ops count and a metered energy: time cancels —
    (ops/t/1e9) / (E/t) = ops / (E_J * 1e9) = 1000 * ops / pJ."""
    if pj <= 0:
        return None
    return 1000.0 * ops / pj


# ---- per-layer / per-schedule costing --------------------------------------


def schedule_layer_pj(layers, schedule=None, *, mode: str = "pipelined"):
    """Active energy per conv layer under a per-layer plane schedule:
    relation-(2) cycles at each layer's budget x that budget's per-cycle
    rate — the plane-proportional dynamic term rides on top of the cycle
    shrink, so truncation saves superlinearly."""
    if schedule is None:
        schedule = (N_BITS,)
    cycles = cm.schedule_layer_cycles(layers, schedule, mode=mode)
    return [
        c * active_rate_pj(cm._planes_for(schedule, i))
        for i, c in enumerate(cycles)
    ]


def schedule_pj(layers, schedule=None, *, mode: str = "pipelined") -> int:
    """Total active energy of one forward pass under ``schedule``."""
    return sum(schedule_layer_pj(layers, schedule, mode=mode))


# ---- speculative decode op classes -----------------------------------------


def spec_round_pj(
    *,
    k: int,
    draft_step_cycles: int,
    full_step_cycles: int,
    interval_cycles: int,
    draft_planes: int,
    planes: int = N_BITS,
    slots: int = 1,
    accepted: int | None = None,
) -> dict:
    """Energy of one speculative round, split by op class the way
    :func:`cm.lm_spec_step_cycles` splits cycles.

    Draft work runs the truncated ``draft_planes`` datapath (cheap per
    cycle *and* short); the verify pass runs the full-digit schedule.
    With ``accepted`` the wasted/useful split closes integer-exactly:
    ``useful_pj + wasted_pj == draft_pj + verify_pj``, with the wasted
    share priced per op class ((k-a) draft steps at the draft rate,
    (k-a) pipeline intervals at the full rate)."""
    if k < 1:
        raise ValueError(f"spec depth k {k} < 1")
    dr = active_rate_pj(draft_planes)
    fr = active_rate_pj(planes)
    draft_cycles = k * draft_step_cycles * slots
    verify_cycles = (full_step_cycles + k * interval_cycles) * slots
    out = dict(
        draft_rate_pj=dr,
        verify_rate_pj=fr,
        draft_cycles=draft_cycles,
        verify_cycles=verify_cycles,
        draft_pj=draft_cycles * dr,
        verify_pj=verify_cycles * fr,
    )
    out["total_pj"] = out["draft_pj"] + out["verify_pj"]
    if accepted is not None:
        if not 0 <= accepted <= k:
            raise ValueError(f"accepted {accepted} outside 0..{k}")
        wasted_draft = (k - accepted) * draft_step_cycles * slots
        wasted_verify = (k - accepted) * interval_cycles * slots
        out.update(
            wasted_draft_cycles=wasted_draft,
            wasted_verify_cycles=wasted_verify,
            wasted_pj=wasted_draft * dr + wasted_verify * fr,
        )
        out["useful_pj"] = out["total_pj"] - out["wasted_pj"]
        # the non-speculative cost of the tokens actually emitted
        out["baseline_pj"] = (accepted + 1) * full_step_cycles * fr * slots
    return out


# ---- calibration -----------------------------------------------------------


def calibration(mode: str = "pipelined") -> dict:
    """The golden-locked anchor: the calibrated full-8 U-Net, priced by
    this model, against Table 1's proposed row as printed."""
    layers = cm.unet_conv_layers(**cm.CALIBRATED_UNET)
    schedule = (N_BITS,)
    cycles = cm.schedule_cycles(layers, schedule, mode=mode)
    ops = cm.model_ops(layers)
    pj = schedule_pj(layers, schedule, mode=mode)
    row = PAPER_TABLE1["proposed"]
    gops_w = metered_gops_per_w(ops, pj)
    e_mj = pj_to_mj(pj)
    return dict(
        cycles=cycles,
        ops=ops,
        energy_pj=pj,
        energy_mj=e_mj,
        gops_w=gops_w,
        power_w=modeled_power_w(),
        paper_gops_w=row["gops_w"],
        paper_e_mj=row["e_mj"],
        paper_power_w=implied_chip_power_w(),
        rel_err_gops_w=(gops_w - row["gops_w"]) / row["gops_w"],
        rel_err_e_mj=(e_mj - row["e_mj"]) / row["e_mj"],
    )
