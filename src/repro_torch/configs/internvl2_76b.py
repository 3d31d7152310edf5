"""InternVL2-76B — VLM: stub InternViT frontend + InternLM2-like 76B LM
backbone. [arXiv:2404.16821; unverified]

Per the assignment, only the transformer backbone is modeled; the vision
frontend is a stub (``input_specs`` provides 256 precomputed patch
embeddings prepended to the token stream).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2_76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128_256,
        rope_theta=1_000_000.0,
        act="swiglu",
        vlm_patches=256,
        microbatches=8,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        vlm_patches=8, microbatches=1, attn_chunk=64,
    )
