"""Model zoo of the port: the U-Net, the transformer LM (the dense, moe and
vlm families), RWKV6 (ssm), Zamba2 (hybrid) and Whisper (encdec).

``build(cfg)`` returns the module that serves a config (init / forward /
decode API), as the reference's ``models.build`` does.
"""

# Families whose forward consumes cfg.quant.plane_schedule (the per-layer
# dynamic-precision policy rides the transformer block stack).  Elsewhere a
# schedule would be silently ignored — reject it instead.
PLANE_SCHEDULE_FAMILIES = ("dense", "moe", "vlm")


def build(cfg):
    """Return the model module for a config (forward/init/decode API)."""
    from . import rwkv6, transformer, unet, whisper, zamba2

    quant = getattr(cfg, "quant", None)
    if (quant is not None and getattr(quant, "plane_schedule", None) is not None
            and cfg.family not in PLANE_SCHEDULE_FAMILIES):
        raise NotImplementedError(
            f"quant.plane_schedule is only consumed by the transformer "
            f"families {PLANE_SCHEDULE_FAMILIES}, not {cfg.family!r}; use the "
            f"global quant.planes knob there (U-Net has its own "
            f"UNetConfig.plane_schedule)"
        )
    mods = {"dense": transformer, "moe": transformer, "vlm": transformer, "hybrid": zamba2,
            "ssm": rwkv6, "encdec": whisper, "unet": unet}
    return mods[cfg.family]
