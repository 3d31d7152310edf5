"""Granite-20B (code) — llama-arch with MQA (kv=1). [arXiv:2405.04324; hf]

kv_heads=1 cannot shard over the 16-way model axis; the sharding rules fall
back automatically (head_dim sharding for the cache) — see parallel/sharding.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite_20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49_152,
        rope_theta=10_000.0,
        act="gelu",  # GPT-BigCode-style MLP
        microbatches=8,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256, vocab=512,
        microbatches=1, attn_chunk=64,
    )
