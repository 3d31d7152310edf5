"""The reference side of ``tests/test_torch_launch.py``'s bookkeeping
parity, run as a subprocess with 512 forced host devices:

    JAX_PLATFORMS=cpu python tests/_ref_specs.py OUT.json

For every cell (``configs.base.cells`` x the 16x16 and 2x16x16 production
meshes) it writes ``repro.launch.specs.build_cell``'s ``meta`` (params,
active params, tokens, serve mode, the analytic-memory inputs) and, for
each decode cell, the shape and spec of every leaf of the cache under
``serve_step.cache_shardings``; and, under ``__hlo__``, one small compiled
8-device program's HLO text.  No cell is lowered or compiled.  Meshes are
Auto-typed (jax 0.9's ``jax.make_mesh`` makes Explicit axes by
default).
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import ARCH_IDS, get_config  # noqa: E402
from repro.configs.base import SHAPES, cells  # noqa: E402
from repro.launch import specs  # noqa: E402
from repro.serve import serve_step as ss  # noqa: E402


def spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def main(path: str) -> None:
    out = {}
    for multi_pod in (False, True):
        shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
            (16, 16), ("data", "model"))
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
        tag = "2_16_16" if multi_pod else "16_16"
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape_name in cells(arch):
                cell = specs.build_cell(cfg, shape_name, mesh)
                meta = dict(cell["meta"])
                meta["kind"] = cell["kind"]
                sh = SHAPES[shape_name]
                if cell["kind"] == "decode":
                    _, ab_cache = ss.make_decode(cfg, sh.global_batch, sh.seq_len)
                    c_sh = ss.cache_shardings(ab_cache, cfg, mesh, sh.global_batch,
                                              max_seq=sh.seq_len)
                    meta["cache"] = [
                        [list(leaf.shape), spec_json(s.spec)]
                        for leaf, s in zip(jax.tree.leaves(ab_cache), jax.tree.leaves(
                            c_sh, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding)))]
                out[f"{arch}__{shape_name}__{tag}"] = meta
    # a compiled 8-device program's HLO text, for the collective parser
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh8 = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                          devices=jax.devices()[:8])

    def body(x):
        y = jax.lax.psum(x, "model")
        y = jax.lax.all_gather(y, "data", tiled=True)
        return jax.lax.ppermute(y, "model", [(0, 1), (1, 0)])

    prog = shard_map(body, mesh=mesh8, in_specs=P("data", "model"), out_specs=P(None, "model"),
                     check_rep=False)
    out["__hlo__"] = jax.jit(prog).lower(jnp.ones((16, 8), jnp.float32)).compile().as_text()
    with open(path, "w") as f:
        json.dump(out, f)
    print("REF_OK")


if __name__ == "__main__":
    main(sys.argv[1])
