"""Paper Table 1, from the port's cycle model and measured on the card.

    python -m repro_torch.bench.table1

Rows (CSV ``name,us_per_call,derived``; ``us_per_call`` = time per image):
  * proposed(model)      — relations (2)+(3) on the calibrated U-Net,
                           pipelined steady state (matches time AND GOPS)
  * proposed(as-printed) — relation (2) verbatim (matches time only)
  * cascaded-msdf(model) — same datapath, un-merged delays (Sec. 3.2)
  * cuda(measured-here)  — the port's float U-Net forward at the calibrated
                           geometry on the CUDA card, and the int8 MMA
                           kernel path at the schedule's planes; GOPS only
                           (no power is sampled), beside the card's name
                           and power limit
  * paper rows           — printed values, with derived-column consistency

The model and paper rows are the reference package's
(``benchmarks/table1.py``), string for string.  The measured rows time one
forward from replays of a CUDA graph of 20 forwards, so the host's launch
rate is not what is timed.
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys

from repro_torch.core import cycle_model as cm


def paper_rows():
    out = []
    for name, r in cm.PAPER_TABLE1.items():
        power = r["gops"] / r["gops_w"]
        out.append((f"table1/{name}(paper)", r["time_ms"] * 1e3,
                    f"gops={r['gops']};gops_w={r['gops_w']};e_mj={r['e_mj']};power_w={power:.2f}"))
    return out


def model_rows():
    layers = cm.unet_conv_layers(**cm.CALIBRATED_UNET)
    rows = []
    # pipelined steady state (calibration target: time + GOPS jointly)
    tile = cm.pipelined_tile_cycles()
    cyc = cm.model_cycles(layers, tile_cycles=tile)
    t_ms = cyc / cm.FREQ_HZ * 1e3
    gops = cm.model_ops(layers) / (t_ms * 1e-3) / 1e9
    power = cm.PAPER_TABLE1["proposed"]["gops"] / cm.PAPER_TABLE1["proposed"]["gops_w"]
    rows.append(("table1/proposed(model-pipelined)", t_ms * 1e3,
                 f"gops={gops:.2f};gops_w={gops/power:.2f};e_mj={power*t_ms:.1f};"
                 f"err_t={abs(t_ms-53.25)/53.25*100:.1f}%;err_gops={abs(gops-52.95)/52.95*100:.1f}%"))
    # relation (2) exactly as printed
    row = cm.proposed_row(layers)
    rows.append(("table1/proposed(rel2-as-printed)", row.time_ms * 1e3,
                 f"gops={row.gops:.2f};gops_w={row.gops_per_w:.2f};e_mj={row.energy_mj:.1f}"))
    # cascaded baseline (the paper's own analytical comparison)
    c = cm.cascaded_row(layers)
    rows.append(("table1/cascaded-msdf(model)", c.time_ms * 1e3,
                 f"gops={c.gops:.2f};merged_speedup={c.time_ms/row.time_ms:.3f}x"))
    return rows


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: a profiler's device
    events, busy time without double counting overlaps."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def graph_ms(torch, fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in one CUDA
    graph, each replay timed by CUDA events, the median replay over
    ``calls``.  The host issues one replay per window, so a call shorter
    than its Python issue time is timed by the card, not by the host's
    launch rate (which CUDA events around Python calls measure)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def measured_rows(*, planes=None, device=None):
    """The port's U-Net forward per image at the calibrated geometry on the
    CUDA card: the float datapath, and the int8 datapath through the MMA
    kernel at ``planes`` (per conv; default the ``from_weights(0.05)``
    schedule of the weights).  Random weights from seed 0, one phantom
    image.  Raises without a card: no CPU time is reported."""
    import torch

    from repro_torch.configs.unet import config
    from repro_torch.device import resolve_device
    from repro_torch.models import unet
    from repro_torch.segserve.synth import phantom_image

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the measured rows time the CUDA card, not {dev}")
    cfg = dataclasses.replace(config(), quant_mode="none")
    params = unet.init_params(0, cfg, device=dev)
    x = torch.as_tensor(phantom_image(cfg.hw, cfg.hw, cfg.in_ch)[None], device=dev)
    if planes is None:
        planes = unet.schedule_from_params(params, 0.05).planes
    qcfg = dataclasses.replace(cfg, quant_mode="mma_int8", impl="kernel",
                               plane_schedule=tuple(int(b) for b in planes))
    layers = cm.unet_conv_layers(cfg.hw, cfg.in_ch, cfg.base, cfg.depth, cfg.convs_per_stage)
    ops = cm.model_ops(layers)
    card = card_line().replace(",", "")
    rows = []
    for name, fcfg, what in (
        ("table1/cuda(measured-here)", cfg, "float32"),
        ("table1/cuda-int8-mma(measured-here)", qcfg,
         "int8 MMA kernel planes=" + "-".join(str(b) for b in qcfg.plane_schedule)),
    ):
        ms = graph_ms(torch, lambda fcfg=fcfg: unet.forward(params, x, fcfg, device=dev))
        gops = ops / (ms * 1e-3) / 1e9
        rows.append((name, ms * 1e3, f"gops={gops:.2f};datapath={what};card={card}"))
    return rows


def run(**kw) -> list[tuple[str, float, str]]:
    return model_rows() + measured_rows(**kw) + paper_rows()


def main() -> int:
    print(card_line())
    print("name,us_per_call,derived")
    for name, us, derived in run():
        print(f"{name},{us:.3f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
