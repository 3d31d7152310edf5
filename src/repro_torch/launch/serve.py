"""Serving launcher: the continuous-batching engine on an arch's smoke config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --requests 8 \
        [--quant mma_int8 --planes 6] [--device cpu]

Runs on the CUDA card unless ``--device cpu``.  The weights are the port's
seed-0 draw (the reference's ``jax.random`` draw cannot be reproduced); the
prompts are numpy's seed-0 draw, as the reference's launcher makes them.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--quant", default="none")
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.quant != "none":
        cfg = cfg.replace(quant=QuantConfig(mode=args.quant, planes=args.planes))
    mod = build(cfg)
    params = (mod.init_params(0, cfg, device=dev, max_dec_pos=args.max_seq)
              if cfg.family == "encdec" else mod.init_params(0, cfg, device=dev))

    eng = Engine(cfg, params, batch=args.batch, max_seq=args.max_seq, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(2, 10))),
                    max_new=args.max_new) for i in range(args.requests)]
    done = eng.run(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {list(r.prompt)[:4]}... -> {r.out}")
    return done


if __name__ == "__main__":
    main()
