"""Whisper-large-v3 — enc-dec audio; conv/mel frontend is a stub
(precomputed frame embeddings). [arXiv:2212.04356; unverified]

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA), GELU MLP.
Assigned seq shapes apply to the decoder stream (DESIGN.md).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper_large_v3",
        family="encdec",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51_866,
        act="gelu",
        enc_layers=32,
        enc_seq=1500,
        microbatches=2,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        enc_layers=2, enc_seq=32, microbatches=1, attn_chunk=64,
    )
