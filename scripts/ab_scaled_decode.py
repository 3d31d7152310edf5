#!/usr/bin/env python3
"""The scaled MMA kernel of two or more source trees, timed in turns on one
card: decode calls at the shapes the port serves.

    python3 scripts/ab_scaled_decode.py TREE [TREE ...]

Each TREE is a checkout of this repository (for example the parent commit,
unpacked with ``git archive``, beside the working tree ``.``).  The trees'
kernel libraries are built first, all at once (one ``nvcc`` each, into each
tree's own ``csrc/build/``).  Then each tree is timed in a process of its
own (the packages share a name), in turns: a, b, ..., b, a.  A process
draws random int8 weights from seed 0 and times, from CUDA-graph replays
with w cold in L2: one Yi-6B decode call at M = 4 (225 linears: 5 planes,
the head at 8), one minitron_4b decode call at M = 16 and at M = 20, and
Yi-6B's head alone at M = 4.  The last line is a JSON summary: per tree,
every turn's times and the card.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLANES, HEAD_PLANES = 5, 8  # the from_weights(0.05) schedules of the smoke's LMs


def _calls(torch, cfg, m, g, dev):
    """One decode call's linears of ``cfg`` at ``m`` rows: (x, w, x_scale,
    w_scale, planes), random int8 from ``g``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import lm_decode_shapes

    distinct = lm_decode_shapes(cfg)  # "wq/wo" names two linears of one shape
    shapes = [((k, n), PLANES) for _ in range(cfg.n_layers) for name, k, n in distinct
              if name != "head" for _ in name.split("/")]
    shapes += [((k, n), HEAD_PLANES) for name, k, n in distinct if name == "head"]
    xs = torch.full((1,), 0.01, device=dev)
    xk = {k: torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev, generator=g)
          for k in {s[0] for s, _ in shapes}}
    out = []
    for (k, n), p in shapes:
        w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=dev, generator=g)
        out.append((xk[k], w, xs, torch.rand(n, device=dev, generator=g) * 0.01 + 1e-4, p))
    return out


def one(tree: Path) -> dict:
    """Times of ``tree``'s scaled kernel, in this process."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.bench.table1 import card_line, graph_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import mma_matmul as mk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"card": card_line(), "source": str(mk.SOURCE)}

    def call_ms(calls):
        return graph_ms(torch, lambda: [mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p)
                                        for x, w, xs, ws, p in calls], calls=1)

    for name, m in (("yi_6b", 4), ("minitron_4b", 16), ("minitron_4b", 20)):
        calls = _calls(torch, get_config(name), m, g, dev)
        res[f"{name}_m{m}_ms"] = call_ms(calls)
        if name == "yi_6b":  # the head alone: 5,000 MiB per replay of 20 calls, cold
            x, w, xs, ws, p = calls[-1]
            res["yi_6b_head_m4_ms"] = graph_ms(
                torch, lambda: mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=p), calls=20)
        del calls
        torch.cuda.empty_cache()
    return res


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print(json.dumps(one(Path(args[1]).resolve())))
        return 0
    if args[:1] == ["--build"]:
        sys.path.insert(0, str(Path(args[1]).resolve() / "src"))
        from repro_torch.kernels import mma_matmul as mk

        path, _ = mk.build()
        print(path)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_scaled_decode: no CUDA card", file=sys.stderr)
        return 1
    trees = [Path(t).resolve() for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2

    def run(*cmd):
        proc = subprocess.run([sys.executable, __file__, *cmd], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd}: {proc.stdout}{proc.stderr}")
        return proc.stdout.strip().splitlines()[-1]

    with ThreadPoolExecutor(len(trees)) as pool:
        for tree, lib in zip(trees, pool.map(lambda t: run("--build", str(t)), trees)):
            print(f"[build] {tree}: {lib}")
    turns = {str(t): [] for t in trees}
    for tree in trees + trees[::-1]:
        res = json.loads(run("--one", str(tree)))
        turns[str(tree)].append(res)
        print(f"[time] {res['card']} | {tree}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items() if k.endswith("_ms")))
    print(json.dumps(turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
