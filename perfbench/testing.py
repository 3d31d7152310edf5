"""A copy of the benchmark with small cells added, for the CPU tests.

``smoke_root(dir)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``dir`` and adds two cells the way a later change would: new files (a
configuration and a traffic mix each) and new entries in the manifest,
editing no file that was there.  The cells are the two configurations cut
to sizes a CPU runs in seconds.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

UNET_CELL, LM_CELL = "unet.smoke", "yi6b.smoke"


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def smoke_root(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    pb = dest / "perfbench"
    unet = json.loads((pb / "configs" / "unet_calibrated.json").read_text())
    unet["name"] = "unet_smoke"
    unet["model"].update(base=8, depth=2, hw=16)
    unet["serving"].update(batch=4, max_active=3)
    _write(pb / "configs" / "unet_smoke.json", unet)
    mix = json.loads((pb / "traffic" / "brats_crop_c8.json").read_text())
    mix.update(name="slices_smoke", clients=3, warmup_images=3, checked_images=3, pool_images=16)
    mix["image"].update(height=[40, 72], width=[40, 72], tumour_radius=[4, 10])
    _write(pb / "traffic" / "slices_smoke.json", mix)
    lm = json.loads((pb / "configs" / "yi_6b_qat.json").read_text())
    lm["name"] = "yi_smoke"
    lm["model"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                       vocab=512, microbatches=2, attn_chunk=64)
    # limits of this size, from calibrate.readings on the CPU over 8 seeds:
    # the program read at most 3.6e-4 / 3.0e-3 / 5.7e-4, the int4 control at
    # least 2.4e-3 / 0.045 / 0.016, half the batch 4.5e-3 / 0.053 / 0.165
    lm["check"] = {"loss_gap": 1.5e-3, "grad_norm_gap": 0.012, "change_norm_gap": 4e-3}
    _write(pb / "configs" / "yi_smoke.json", lm)
    tok = json.loads((pb / "traffic" / "qat_b8s512.json").read_text())
    tok.update(name="tokens_smoke", global_batch=4, seq_len=96, microbatches=2)
    _write(pb / "traffic" / "tokens_smoke.json", tok)

    man = json.loads((dest / "BENCHMARK.json").read_text())
    man["configs"] += [
        {"name": "unet_smoke", "source": "https://arxiv.org/abs/2606.25562",
         "file": "perfbench/configs/unet_smoke.json", "reduced": ["base", "depth"],
         "why": "CPU test size"},
        {"name": "yi_smoke", "source": "https://huggingface.co/01-ai/Yi-6B",
         "file": "perfbench/configs/yi_smoke.json", "reduced": ["n_layers"],
         "why": "CPU test size"},
    ]
    man["workloads"] += [
        {"name": UNET_CELL, "config": "unet_smoke", "traffic": "slices_smoke", "chips": 1,
         "why": "CPU test size"},
        {"name": LM_CELL, "config": "yi_smoke", "traffic": "tokens_smoke", "chips": 1,
         "why": "CPU test size"},
    ]
    for m in man["end_to_end"] + man["per_layer"]:
        cells = m.get("workloads", [])
        if "unet.brats-c8" in cells:
            cells.append(UNET_CELL)
        if "yi6b.qat-b8s512" in cells:
            cells.append(LM_CELL)
    _write(dest / "BENCHMARK.json", man)
    return dest
