"""Architecture configs of the port: Yi-6B, Minitron-4B, H2O-Danube3-4B
(sliding-window attention) and Granite-20B (MQA), the dense family;
OLMoE-1B-7B and DBRX-132B, the moe family, with Moonlight-16B-A3B
(DeepSeek-V3's block: latent attention, ``kv_lora_rank`` and the
``qk_*``/``v_head_dim`` sizes; shared experts, sigmoid routing with a
selection bias and leading dense layers, ``MoEConfig``'s ``n_shared``,
``routed_scale``, ``bias_rate``, ``first_dense``, and the experts a rank holds,
``held``); RWKV6-3B, the ssm family;
Zamba2-7B, the hybrid family; Whisper-large-v3, the encdec family;
InternVL2-76B, the vlm family; and the U-Net.

``get_config(name)`` returns the full-size config; ``get_smoke_config(name)``
a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "minitron_4b",
    "yi_6b",
    "h2o_danube_3_4b",
    "granite_20b",
    "internvl2_76b",
    "olmoe_1b_7b",
    "dbrx_132b",
    "zamba2_7b",
    "whisper_large_v3",
    "rwkv6_3b",
    "moonlight_16b_a3b",
]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.config()


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.smoke_config()
