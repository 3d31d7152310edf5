"""H2O-Danube3-4B — llama/mistral mix with sliding-window attention.
[arXiv:2401.16818 (danube series); unverified]

SWA window 4096 keeps attention sub-quadratic, so this arch RUNS the
long_500k decode cell (the KV cache is bounded by the window).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o_danube_3_4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab=32_000,
        rope_theta=10_000.0,
        swa_window=4096,
        act="swiglu",
        microbatches=4,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        swa_window=32, microbatches=1, attn_chunk=64,
    )
