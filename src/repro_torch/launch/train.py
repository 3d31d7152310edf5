"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --steps 50 --ckpt-dir <dir> [--resume] [--quant mma_int8] [--device cpu]

Runs on the CUDA card unless ``--device cpu``.  With ``--smoke`` it trains
the arch's reduced config, with random weights from seed 0 and the
synthetic data source; ``--resume`` continues from the latest checkpoint
in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.quant != "none":
        cfg = cfg.replace(quant=QuantConfig(mode=args.quant))
    mod = build(cfg)
    params = (mod.init_params(0, cfg, device=dev, max_dec_pos=args.seq + 1)
              if cfg.family == "encdec" else mod.init_params(0, cfg, device=dev))
    state = {"params": params, "opt": adamw.init(params)}
    if cfg.family == "moe" and cfg.moe.held and cfg.moe.bias_rate:
        state["router_bias"] = mod.init_router_bias(cfg, device=dev)

    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = (cfg.vlm_patches, cfg.d_model)
    if cfg.family == "encdec":
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                      microbatches=cfg.microbatches, extras=extras or None)
    tcfg = trainer.TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                                 ckpt_dir=args.ckpt_dir)

    start = 0
    if args.resume:
        restored, start = trainer.resume(state, tcfg)
        if restored is not None:
            state = restored
            print(f"resumed from step {start}")

    state, metrics = trainer.train(state, lambda st, b: ts.train_step(st, b, cfg, device=dev),
                                   dcfg, tcfg, start_step=start)
    if not metrics["losses"]:
        print(f"no step left to run: at step {start} of {args.steps}")
        return
    print(f"final loss {metrics['losses'][-1]:.4f}; "
          f"stragglers flagged: {metrics['stragglers']}")


if __name__ == "__main__":
    main()
