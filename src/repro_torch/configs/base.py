"""Config schema shared by every architecture, plus the input-shape sets.

A framework-free copy of the reference's schema.  Families: 'dense'
(decoder-only transformer, optionally GQA/MQA/SWA), 'moe' (dense +
mixture-of-experts FFN), 'hybrid' (Mamba2 backbone with a shared attention
block — Zamba2), 'ssm' (attention-free RWKV6), 'encdec' (Whisper), 'vlm'
(dense LM + stub patch-embedding prefix), 'unet' (the paper's target
application).  The port serves every family.  The moe family's
DeepSeek-V3 block (Moonlight-16B-A3B) adds latent attention
(``kv_lora_rank`` > 0) and the held-expert layer (``MoEConfig.held`` > 0:
shared experts, sigmoid scores with a selection bias, leading dense
layers); it trains, and is not served.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class QuantConfig:
    """The paper's technique as a first-class feature: any linear can run
    int8 through the MMA datapath with MSDF-style plane truncation."""

    mode: str = "none"  # 'none' | 'mma_int8'
    planes: int = 8  # MSB planes consumed (global early-termination knob)
    # Per-layer plane budgets (dynamic precision, MINT-style).  Consumed by
    # the transformer families (dense/moe/vlm) — models.build rejects it
    # elsewhere.  When set, it overrides ``planes`` for the block stack:
    # entry l is layer l's budget (clamped to the last entry for deeper
    # stacks).  Non-block linears (the lm head) keep the global ``planes``.
    # Build with core.PlaneSchedule.from_weights /
    # serve.engine.lm_schedule_from_params.
    plane_schedule: tuple[int, ...] | None = None
    impl: str = "horner"  # 'kernel' | 'horner' | 'cascade' | 'int8'
    # Serving extensions: store weights as int8 (+per-channel scale) instead
    # of quantizing on the fly, and keep the KV cache in int8 with a
    # calibrated static scale.
    weights_int8: bool = False
    kv_int8: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    expert_ff: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    ep: bool = False  # expert parallelism
    # The held-expert layer (DeepSeek-V3's, models.moe.moe_held), taken only
    # where ``held`` > 0: this rank holds routed experts ``held_first`` ..
    # ``held_first + held - 1`` of ``n_experts``, routes over all of them and
    # computes its own experts' part, every assignment to them (dropless).
    held: int = 0
    held_first: int = 0
    n_shared: int = 0  # shared experts, one SwiGLU of width n_shared * expert_ff
    routed_scale: float = 1.0  # top-k weights normalised, then times this
    first_dense: int = 0  # leading dense layers (MLP of width d_ff) before the MoE ones
    aux_coef: float = 0.01  # the balance loss's coefficient in the training loss
    bias_rate: float = 0.0  # the selection bias's update speed (0: no bias)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | unet
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # multi-head latent attention (DeepSeek-V2), taken where kv_lora_rank > 0:
    # per-head query and key dims qk_nope_dim + qk_rope_dim, values v_head_dim
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    rope_theta: float = 10_000.0
    swa_window: int = 0  # 0 = full attention; >0 = sliding window
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    moe: MoEConfig = field(default_factory=MoEConfig)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attn block after every N ssm layers
    # enc-dec
    enc_layers: int = 0
    enc_seq: int = 1500  # stub audio frontend frames
    # vlm
    vlm_patches: int = 0
    # quantized MMA datapath
    quant: QuantConfig = field(default_factory=QuantConfig)
    # training knobs
    remat: str = "full"  # none | full
    microbatches: int = 1
    seq_shard: bool = True  # sequence-parallel residual stream
    attn_chunk: int = 1024  # flash-attention kv chunk
    scan_unroll: bool = False  # unroll layer scans (dry-run cost probes)
    shard_rules: str = "default"  # logical->mesh rule set
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The assigned LM shape set (identical across the 10 archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs whose attention is sub-quadratic run the long_500k cell; full
# attention at 500k tokens is skipped, as in the reference.
LONG_CONTEXT_OK = {"h2o_danube_3_4b", "zamba2_7b", "rwkv6_3b"}


# Archs with no sharded step: Moonlight-16B-A3B's latent attention and
# held-expert layer train on one card (its rank's share), and are not served.
ONE_CARD_ONLY = {"moonlight_16b_a3b"}


def cells(arch_name: str) -> list[str]:
    """The shape cells that are runnable for this arch (on a mesh)."""
    if arch_name.replace("-", "_") in ONE_CARD_ONLY:
        return []
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name.replace("-", "_") in LONG_CONTEXT_OK:
        out.append("long_500k")
    return out
