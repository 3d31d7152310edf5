"""Minitron-4B — width-pruned Nemotron, dense GQA. [arXiv:2407.14679; hf]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron_4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,  # minitron keeps 128-dim heads after width pruning
        d_ff=9216,
        vocab=256_000,
        rope_theta=10_000.0,
        act="swiglu",
        microbatches=4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, microbatches=1, attn_chunk=64,
    )
