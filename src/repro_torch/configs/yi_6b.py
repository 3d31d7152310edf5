"""Yi-6B — llama-architecture dense GQA. [arXiv:2403.04652; hf]"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi_6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64_000,
        rope_theta=5_000_000.0,
        act="swiglu",
        microbatches=4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        microbatches=1, attn_chunk=64,
    )
