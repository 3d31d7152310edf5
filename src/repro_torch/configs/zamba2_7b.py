"""Zamba2-7B — hybrid: 81 Mamba2 layers + one weight-shared attention block
interleaved every 6 layers. [arXiv:2411.15242; unverified]

ssm_state=64; the shared attention block runs on [hidden ; embedding]
(2*d_model wide).  SSM state is O(1) in sequence length -> long_500k RUNS.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2_7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,  # unused by mamba blocks; shared block is attention-only
        vocab=32_000,
        rope_theta=10_000.0,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        attn_every=6,
        microbatches=4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        ssm_state=16, ssm_head_dim=32, attn_every=2, microbatches=1,
        attn_chunk=64,
    )
