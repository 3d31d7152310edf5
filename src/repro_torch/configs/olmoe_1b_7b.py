"""OLMoE-1B-7B — MoE, 64 experts top-8, d_ff=1024 per expert.
[arXiv:2409.02060; hf]
"""
from .base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe_1b_7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50_304,
        rope_theta=10_000.0,
        act="swiglu",
        moe=MoEConfig(n_experts=64, top_k=8, expert_ff=1024, capacity_factor=1.25,
                      ep=True),
        microbatches=2,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=128, capacity_factor=1.25),
        microbatches=1, attn_chunk=64,
    )
