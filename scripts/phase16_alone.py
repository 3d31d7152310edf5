#!/usr/bin/env python3
"""``chip_smoke.py``'s kernel build and phases 16 (parallel training) and 17
(sharded serving) alone, on the same four rank processes:

    python3 scripts/phase16_alone.py [--phases 16,17]

Prints the phases' lines, 16(a)-(c) and 17's gates included, and a JSON
summary of what they return.  ``--phases 17`` runs phase 17 alone (its
yardsticks, the dry run's prediction and the ranks' serving).  Needs a
CUDA card; about 5-8 minutes with the build for both.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="16,17", help="comma-separated: 16, 17 or both")
    phases = tuple(int(p) for p in ap.parse_args().phases.split(","))
    import numpy as np
    import torch

    from repro_torch.bench.table1 import card_line
    from repro_torch.kernels import mma_matmul as mk

    t0 = time.perf_counter()
    card = card_line()
    print(card)
    lib, _ = mk.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    out = chip_smoke.parallel_training(torch, np, torch.device("cuda"), card, phases=phases)
    print(json.dumps({k: v for k, v in out.items() if not k.endswith("per_shape")}))
    print(f"[done] phases {phases} alone in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
