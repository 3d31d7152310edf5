"""Moonlight-16B-A3B — DeepSeek-V3's block: multi-head latent attention, 64
sigmoid-routed experts top-6 with 2 shared, one leading dense layer.
[arXiv:2502.16982; hf moonshotai/Moonlight-16B-A3B (model_type deepseek_v3);
equations: DeepSeek-V3, arXiv:2412.19437 §2.1; MLA: arXiv:2405.04434]

``q_lora_rank`` is null: the query is one product of the residual stream.
The checkpoint's RoPE pairs are interleaved; the port rotates halves, which
is the same up to a fixed permutation of ``wq``'s and ``wkv_a``'s rope
columns, to be applied when loading published weights (the port loads
none).  ``config()`` holds every routed expert; a rank of an
expert-parallel deployment sets ``moe.held`` and ``moe.held_first``.
"""
from .base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="moonlight_16b_a3b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=11_264,  # the leading dense layer's MLP
        vocab=163_840,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=50_000.0,
        norm_eps=1e-5,
        act="swiglu",
        moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, held=64, n_shared=2,
                      routed_scale=2.446, first_dense=1,
                      aux_coef=0.001, bias_rate=0.001),
        microbatches=1,
        attn_chunk=1024,
    )


def smoke_config() -> ArchConfig:
    return config().replace(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=192, vocab=512,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=MoEConfig(n_experts=16, top_k=4, expert_ff=32, held=16, n_shared=2,
                      routed_scale=2.446, first_dense=1,
                      aux_coef=0.001, bias_rate=0.001),
        attn_chunk=64,
    )
