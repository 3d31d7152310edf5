"""RWKV6-3B ("Finch") — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

State is O(1) in sequence length -> long_500k RUNS.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6_3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # d_model / 64
        n_kv_heads=40,
        d_ff=8960,
        vocab=65_536,
        ssm_head_dim=64,
        microbatches=2,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, vocab=512,
        ssm_head_dim=64, microbatches=1, attn_chunk=64,
    )
