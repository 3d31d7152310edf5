"""The readings a cell's limits are set from: for each seed, the cell's
set-up and a short window at its own load, then the program's number
against the plain reference, and the same number of the lower-precision
control and of each fault the runner knows, put in the program's place.
One process for every seed.

    python3 perfbench/calibrate.py --workload <cell> --seconds 10 --seeds 1 2 3 ...

Prints one JSON line per seed and a summary.  The benchmark's own runs do
not run this.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device=None, root: Path = ROOT) -> dict:
    import torch

    cell = harness.resolve(workload, root)
    dev = torch.device("cuda" if device is None else device)
    mod = harness.load_module(root / "perfbench" / "runners" / f"{cell.config['runner']}.py",
                              f"runner_{cell.config['runner']}")
    runner = mod.make(cell.config, cell.mix, seed, dev, harness.Spans())
    t0 = time.perf_counter()
    runner.setup()
    runner.window(seconds, False)
    runner.release()
    out = {"seed": seed, **runner.readings(), "seconds": time.perf_counter() - t0}
    del runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.require_cards(1)
    rows = []
    for s in args.seeds:
        rows.append(readings(args.workload, s, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    keys = [k for k in rows[0] if k not in ("seed", "seconds", "images")]
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      **{k: {"min": min(r[k] for r in rows), "max": max(r[k] for r in rows)}
                         for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
