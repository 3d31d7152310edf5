"""Pipeline-parallel dry run: GPipe PP 16 x DP 16 on the single-pod mesh for
a dense arch (the PP alternative to the TP-collective-bound train cells).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pp --arch yi_6b [--out DIR]

As ``launch.dryrun`` does, this runs one rank's ``pipelined_loss_fn`` and
its gradient on ``meta`` tensors over the shape-only 16x16 mesh (stage 0,
data rank 0), the stages over ``model``, and counts its products and
collectives (:func:`count`, on any mesh).  Keys as the reference's ``dryrun_pp.py`` writes them; those
a compiler gives there (``compile_s``, ``temp_bytes``) are null here.

The global batch is ``n_micro`` x |data| sequences of 4096 tokens (512 at
the default 32 microbatches): the reference's 256 sequences do not split
into 32 microbatches over 16 data ranks.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import RESULTS, count_run
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models import transformer
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import bubble_fraction, pipelined_loss_fn, stage_shardings


def count(cfg, mesh, batch: dict, n_micro: int) -> dict:
    """One rank's ``pipelined_loss_fn`` and its gradient on ``meta``
    tensors over the shape-only ``mesh`` (stages over ``model``), at the
    rank's coordinates: ``launch.dryrun.count_run``'s products and
    collectives.  ``batch``: the global ``{"tokens": (B, S+1)}``, meta."""
    params = transformer.init_params(0, cfg, device="meta")
    local = layers.tree_map(lambda t: t.requires_grad_(),
                            shd.shard_tree(params, stage_shardings(params, mesh)))

    def loss_and_grad(local, batch):
        with shd.use_mesh(mesh):
            loss, _ = pipelined_loss_fn(local, batch, cfg, n_micro=n_micro, device="meta")
        return torch.autograd.grad(loss, tree_leaves(local))

    return count_run(loss_and_grad, (local, batch), mesh)


def run(arch: str = "yi_6b", n_micro: int = 32) -> dict:
    cfg = get_config(arch).replace(seq_shard=False, microbatches=1)
    mesh = make_production_mesh(device="meta")
    rows = n_micro * mesh.shape["data"]
    batch = {"tokens": torch.empty((rows, 4097), dtype=torch.int32, device="meta")}
    t0 = time.time()
    counted = count(cfg, mesh, batch, n_micro)
    coll = counted["collectives"]
    return dict(
        arch=arch, mode="pipeline", mesh="16x16",
        pp=mesh.shape["model"], dp=mesh.shape["data"], n_micro=n_micro, global_batch=rows,
        bubble=bubble_fraction(mesh.shape["model"], n_micro),
        compile_s=None, count_s=round(time.time() - t0, 2),
        flops_raw=float(counted["census"]["flops"]),
        collective_bytes_raw=coll["total_bytes"],
        collective_counts=coll["counts_by_kind"],
        temp_bytes=None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--n-micro", type=int, default=32)
    ap.add_argument("--out", default=str(RESULTS), help="directory for the JSON file")
    args = ap.parse_args(argv)
    out = run(args.arch, args.n_micro)
    d = Path(args.out)
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{args.arch}__train_4k__16_16__pp.json").write_text(json.dumps(out, indent=1))
    print(f"[ok] PP dry-run {args.arch}: counted {out['count_s']:.1f}s "
          f"bubble={out['bubble']:.2f} colls={out['collective_counts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
