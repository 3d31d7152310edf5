"""The dry run: every (arch x shape) cell on the production meshes, priced
without a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

The reference lowers and compiles each cell for 256 / 512 TPU chips and
reads XLA's cost and memory analyses.  Torch has no HLO, so the port
compiles nothing: it *runs* one rank's step on ``meta`` tensors over the
shape-only production mesh (``launch.mesh.make_production_mesh``, rank 0's
coordinates) and counts what passes:

- ``cost.flops``: 2·M·N·K of every matrix product the run dispatches
  (``mm``/``bmm``/``addmm``/``baddbmm``; the MMA's int8 products among
  them, ``core.mma.mma_dot``'s meta branch), per chip and step;
- ``collectives`` / ``cost.coll_bytes``: the collectives' counts and operand
  bytes by kind (``parallel.collectives``' counting mode) of every cell:
  one rank's sharded train step, prefill or decode step (every LM family
  has a sharded loss and sharded serving steps), ``"collectives_counted":
  true`` and ``flops_basis`` ``"per-rank step"``;
- ``census``: the run's product count (and its int8 products).

As the reference's probes do, a cell is counted at depth 1 and 2 (a hybrid
at one, two and one-plus-tail groups of ``attn_every``; an encdec with
encoder and decoder depth together) and extrapolated linearly to its
depth: every layer issues the same products and collectives.

``hbm_traffic_model``, ``roofline``, ``model_flops_per_chip`` and
``useful_flops_fraction`` follow the reference, with the NVIDIA H100 SXM
data sheet's peaks (``launch.hlo_analysis``).  ``memory`` holds
``argument_size_in_bytes`` only (per chip: the sharded state and batch, or
params, inputs and cache): temp and code sizes come from a compiler, which
the port does not run.

One JSON per cell goes to ``results/dryrun_torch/`` (``--out``); the
reference's ``results/dryrun/`` is never written.  ``--all`` over the 66
cells allocates nothing and takes about 16 minutes on one CPU core
(RWKV6's per-token loops most of it: its train and prefill cells).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses as dc
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import QuantConfig, cells
from repro_torch.launch import hlo_analysis, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd
from repro_torch.train import train_step as ts

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default: 0, _aten.addmm.default: 1, _aten.bmm.default: 0,
             _aten.baddbmm.default: 1}


class ProductCounter(TorchDispatchMode):
    """Counts the matrix products dispatched inside it and their FLOPs
    (2·M·N·K, times the batch of a ``bmm``); int8 operands (the MMA's
    products on ``meta``) apart too."""

    def __init__(self):
        super().__init__()
        self.products = self.flops = self.int8_products = self.int8_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        first = _PRODUCTS.get(func)
        if first is not None:
            a, b = args[first], args[first + 1]
            f = 2 * a.numel() * b.shape[-1]
            self.products += 1
            self.flops += f
            if a.dtype == torch.int8:
                self.int8_products += 1
                self.int8_flops += f
        return func(*args, **(kwargs or {}))

    def summary(self) -> dict:
        return {"products": self.products, "flops": self.flops,
                "int8_products": self.int8_products, "int8_flops": self.int8_flops}


def count_run(fn, args, mesh=None) -> dict:
    """Run ``fn(*args)`` (meta tensors) under a :class:`ProductCounter`; the
    products, and where ``mesh`` is given the collectives it issued."""
    if mesh is not None:
        coll.reset_stats(mesh)
    with ProductCounter() as pc:
        fn(*args)
    out = {"census": pc.summary()}
    if mesh is not None:
        out["collectives"] = coll.collective_stats(mesh)
    return out


def count_train_step(cfg, mesh, batch: dict) -> dict:
    """One rank's sharded train step (``train_step.build_jitted_train_step``)
    on meta tensors over the shape-only ``mesh`` (device ``meta``): its
    products and collectives.  ``batch``: the global batch, meta."""
    ab = ts.abstract_state(cfg)
    step = ts.build_jitted_train_step(cfg, mesh, ab, batch)
    state = shd.shard_tree(ab, ts.state_shardings(ab, cfg, mesh))
    return count_run(step, (state, batch), mesh)


def _count_cell(cfg, shape_name: str, mesh) -> dict:
    """One cell's counts: one rank's sharded step (the cell's ``fn``) on its
    slices of the cell's meta arguments; a train step takes the global
    batch and cuts its rows itself."""
    cell = specs.build_cell(cfg, shape_name, mesh)
    if cell["kind"] == "train":
        ab_state, batch = cell["args"]
        args = (shd.shard_tree(ab_state, cell["in_shardings"][0]), batch)
    else:
        args = tuple(shd.shard_tree(a, sh) if isinstance(a, dict) else shd.shard(a, sh)
                     for a, sh in zip(cell["args"], cell["in_shardings"]))
    with torch.no_grad():
        return count_run(cell["fn"], args, mesh)


def _flat(d: dict, prefix=()) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = v
    return out


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for keys, v in flat.items():
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def probe_counts(cfg, shape_name: str, mesh) -> dict:
    """The cell's counts at full depth, from runs at depth 1 and 2 (see the
    module's docstring): ``v(L) = v(1) + (v(2) - v(1)) (L - 1)``."""
    fam = cfg.family
    if fam == "hybrid":
        g = cfg.attn_every or 6
        n_groups, tail = cfg.n_layers // g, cfg.n_layers % g
        v_g = _flat(_count_cell(cfg.replace(n_layers=g), shape_name, mesh))
        v_2g = _flat(_count_cell(cfg.replace(n_layers=2 * g), shape_name, mesh))
        v_gt = _flat(_count_cell(cfg.replace(n_layers=g + tail), shape_name, mesh)) if tail else v_g
        keys = v_g.keys() | v_2g.keys() | v_gt.keys()
        return _unflat({k: v_g.get(k, 0) + (v_2g.get(k, 0) - v_g.get(k, 0)) * (n_groups - 1)
                        + v_gt.get(k, 0) - v_g.get(k, 0) for k in keys})
    if fam == "encdec":
        v1 = _flat(_count_cell(cfg.replace(n_layers=1, enc_layers=1), shape_name, mesh))
        v2 = _flat(_count_cell(cfg.replace(n_layers=2, enc_layers=2), shape_name, mesh))
    else:
        v1 = _flat(_count_cell(cfg.replace(n_layers=1), shape_name, mesh))
        v2 = _flat(_count_cell(cfg.replace(n_layers=2), shape_name, mesh))
    keys = v1.keys() | v2.keys()
    return _unflat({k: v1.get(k, 0) + (v2.get(k, 0) - v1.get(k, 0)) * (cfg.n_layers - 1)
                    for k in keys})


def argument_bytes(cell, mesh) -> int:
    """Per-chip bytes of the step's arguments: each sharded as the cell
    places it."""
    total = 0
    for arg, sh in zip(cell["args"], cell["in_shardings"]):
        total += specs.sharded_bytes(arg, sh, mesh)
    return total


def apply_overrides(cfg, overrides: dict):
    """Apply dotted-key overrides, e.g. {'moe.ep': True, 'attn_chunk': 512}."""
    plain = {k: v for k, v in overrides.items() if "." not in k}
    nested: dict[str, dict] = {}
    for k, v in overrides.items():
        if "." in k:
            outer, inner = k.split(".", 1)
            nested.setdefault(outer, {})[inner] = v
    if plain:
        cfg = cfg.replace(**plain)
    for outer, kv in nested.items():
        cfg = cfg.replace(**{outer: dc.replace(getattr(cfg, outer), **kv)})
    return cfg


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, quant: str = "none",
             overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    if quant != "none":
        # serving deploy mode: pre-quantized int8 weights and an int8 KV
        # cache, the int8 product as the compute model
        cfg = cfg.replace(quant=QuantConfig(mode=quant, impl="int8", weights_int8=True,
                                            kv_int8=True))
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    cell = specs.build_cell(cfg, shape_name, mesh)
    n_chips = mesh.size(mesh.axis_names)
    t0 = time.time()
    probe = probe_counts(cfg, shape_name, mesh)
    t_count = time.time() - t0
    census = probe["census"]
    flops = census["flops"]
    coll_stats = probe["collectives"]
    coll_bytes = coll_stats["total_bytes"]
    meta = cell["meta"]
    mem_model = hlo_analysis.analytic_hbm_bytes(cell["kind"], **meta["mem_in"])
    roof = hlo_analysis.roofline(flops, mem_model["total"], coll_bytes)
    # MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D inference, per chip
    n_active = meta["active_params"]
    mult = 6 if cell["kind"] == "train" else 2
    model_flops_per_chip = mult * n_active * meta["tokens"] / n_chips
    return dict(
        arch=arch, shape=shape_name, kind=cell["kind"],
        mesh="2x16x16" if multi_pod else "16x16", chips=int(n_chips), quant=quant,
        count_s=round(t_count, 2),
        params=meta["params"], active_params=n_active,
        serve_mode=meta.get("serve_mode", "-"),
        memory={"argument_size_in_bytes": argument_bytes(cell, mesh)},
        cost={"flops": float(flops), "coll_bytes": float(coll_bytes),
              "coll_count": float(coll_stats["total_count"])},
        flops_basis="per-rank step",
        hbm_traffic_model=mem_model,
        collectives=coll_stats, collectives_counted=True, census=census,
        roofline=roof,
        model_flops_per_chip=model_flops_per_chip,
        useful_flops_fraction=model_flops_per_chip / flops if flops else 0.0,
    )


def save(result: dict, tag: str = "", out: Path = RESULTS) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh'].replace('x', '_')}"
    if result.get("quant", "none") != "none":
        name += f"__{result['quant']}"
    if tag:
        name += f"__{tag}"
    p = out / f"{name}.json"
    p.write_text(json.dumps(result, indent=1))
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--quant", default="none")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (dotted keys ok), e.g. "
                         "--set moe.ep=True --set microbatches=8")
    ap.add_argument("--out", default=str(RESULTS), help="directory for the JSON files")
    args = ap.parse_args(argv)
    out = Path(args.out)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if args.all:
        todo = [(a, s) for a in ARCH_IDS for s in cells(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = []
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    if args.single_pod or not args.multi_pod:
        meshes.insert(0, False)

    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            out_name = f"{arch}__{shape}__{'2_16_16' if mp else '16_16'}"
            if args.quant != "none":
                out_name += f"__{args.quant}"
            if args.tag:
                out_name += f"__{args.tag}"
            if args.skip_existing and (out / f"{out_name}.json").exists():
                print(f"[skip] {out_name}")
                continue
            try:
                r = run_cell(arch, shape, multi_pod=mp, quant=args.quant,
                             overrides=overrides or None)
                save(r, args.tag, out)
                roof = r["roofline"]
                print(f"[ok] {out_name}: counted {r['count_s']:.1f}s "
                      f"flops/chip {r['cost']['flops']:.3e} "
                      f"coll {r['cost']['coll_bytes']:.3e}B "
                      f"dominant={roof['dominant']} "
                      f"bound={roof['step_time_lower_bound_s'] * 1e3:.2f}ms "
                      f"useful={r['useful_flops_fraction']:.2f}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                print(f"[FAIL] {out_name}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
