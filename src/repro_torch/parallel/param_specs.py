"""Per-parameter partition specs (the TP/EP layout) for any model family,
the reference's rules on the port's trees.

Strategy: shape-based defaults plus path-name overrides, applied to the
abstract parameter tree (meta tensors, ``train.train_step.abstract_state``),
so nothing is allocated.

Defaults (2-D weights, after skipping the stacked-layer leading dims):
  (vocab, d)    -> ('vocab', None)      sharded embedding
  (d, vocab)    -> (None, 'vocab')      sharded LM head
  (d_in, d_out) -> (None, 'ffn')        column-parallel
  row-parallel by name: wo / w_down / out_proj / proj / wv_cm
                -> ('ffn', None)        contracts the sharded dim: all-reduce
  3-D (E, ., .) MoE expert stacks -> ('experts', None, None)
  1-D / norms / the rest -> replicated

Divisibility is checked against the mesh where the spec is resolved
(``sharding.spec_for``).
"""
from __future__ import annotations

from . import sharding as shd

ROW_PARALLEL_NAMES = ("wo", "w_down", "out_proj", "proj", "wv_cm")


def _path_str(path) -> str:
    """A leaf's path (its dict keys and list indices, outermost first) as
    the reference writes it: ``blocks/attn/wq/w``."""
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(path, tree)


def logical_for_leaf(path: str, shape: tuple[int, ...], cfg) -> tuple:
    """Logical axis names for one parameter leaf (full shape, the stacked
    leading dims included)."""
    names: list[str | None] = [None] * len(shape)
    # blocks/* leaves carry (L, ...); zamba2's groups (G, g, ...)
    skip = 0
    if any(seg in path for seg in ("blocks/", "groups/", "tail/", "enc_blocks/", "dec_blocks/")):
        skip = 2 if "groups/" in path else 1
    core = shape[skip:]
    v = cfg.vocab if hasattr(cfg, "vocab") else -1

    is_row = any(path.endswith(f"{n}/w") or path.endswith(f"{n}/w_q")
                 for n in ROW_PARALLEL_NAMES)
    # rwkv's channel-mix 'wv' is (d_ff, d), row-parallel (unlike attention's wv)
    is_row = is_row or path.endswith("channel_mix/wv/w") or path.endswith("channel_mix/wv/w_q")

    if len(core) == 2:
        r, c = core
        if r == v:
            names[skip], names[skip + 1] = "vocab", None
        elif c == v:
            names[skip], names[skip + 1] = None, "vocab"
        elif is_row:
            names[skip], names[skip + 1] = "ffn", None
        else:
            names[skip], names[skip + 1] = None, "ffn"
    elif len(core) == 3 and ("moe/" in path or "experts" in path):
        names[skip] = "experts"  # (E, d, f) / (E, f, d): experts over 'model'
    return tuple(names)


def param_specs(abstract_params, cfg):
    """A PartitionSpec tree matching the parameter tree (logical names,
    unresolved: the reference's ``P(*logical)``)."""
    return _map_with_path(
        lambda path, leaf: shd.P(*logical_for_leaf(_path_str(path), tuple(leaf.shape), cfg)),
        abstract_params)


def param_logical(abstract_params, cfg):
    """The logical-name tuple of every leaf (resolved under a mesh later)."""
    return _map_with_path(
        lambda path, leaf: logical_for_leaf(_path_str(path), tuple(leaf.shape), cfg),
        abstract_params)


def named_shardings(abstract_params, cfg, mesh, rules=None):
    """The NamedSharding of every leaf on ``mesh``, divisibility-guarded."""
    if rules is None:
        rules = shd.RULE_SETS.get(getattr(cfg, "shard_rules", "default"), shd.DEFAULT_RULES)

    def one(path, leaf):
        logical = logical_for_leaf(_path_str(path), tuple(leaf.shape), cfg)
        with shd.use_mesh(mesh, rules):
            return shd.named_sharding(*logical, shape=tuple(leaf.shape))

    return _map_with_path(one, abstract_params)
