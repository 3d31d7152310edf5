#!/usr/bin/env python3
"""``chip_smoke.py``'s kernel build and phase 16 (parallel training) alone:

    python3 scripts/phase16_alone.py

Prints phase 16's lines, (a)-(c) included, and a JSON summary of what it
returns.  Needs a CUDA card; about 5-7 minutes with the build.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.bench.table1 import card_line
    from repro_torch.kernels import mma_matmul as mk

    t0 = time.perf_counter()
    card = card_line()
    print(card)
    lib, _ = mk.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    out = chip_smoke.parallel_training(torch, np, torch.device("cuda"), card)
    print(json.dumps({k: v for k, v in out.items() if not k.endswith("per_shape")}))
    print(f"[done] phase 16 alone in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
