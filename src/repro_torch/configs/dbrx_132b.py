"""DBRX-132B — fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]
"""
from .base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx_132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100_352,
        rope_theta=500_000.0,
        act="swiglu",
        moe=MoEConfig(n_experts=16, top_k=4, expert_ff=10752, capacity_factor=1.25,
                      ep=True),
        microbatches=8,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=256, capacity_factor=1.25),
        microbatches=1, attn_chunk=64,
    )
