"""Model zoo of the port: the U-Net and the transformer LM (the dense and
moe families) so far.

``build(cfg)`` returns the module that serves a config (init / forward /
decode API), as the reference's ``models.build`` does; families not yet
ported raise ``NotImplementedError``.
"""

# Families whose forward consumes cfg.quant.plane_schedule (the per-layer
# dynamic-precision policy rides the transformer block stack).  Elsewhere a
# schedule would be silently ignored — reject it instead.
PLANE_SCHEDULE_FAMILIES = ("dense", "moe", "vlm")


def build(cfg):
    """Return the model module for a config (forward/init/decode API)."""
    from . import transformer, unet

    quant = getattr(cfg, "quant", None)
    if (quant is not None and getattr(quant, "plane_schedule", None) is not None
            and cfg.family not in PLANE_SCHEDULE_FAMILIES):
        raise NotImplementedError(
            f"quant.plane_schedule is only consumed by the transformer "
            f"families {PLANE_SCHEDULE_FAMILIES}, not {cfg.family!r}; use the "
            f"global quant.planes knob there (U-Net has its own "
            f"UNetConfig.plane_schedule)"
        )
    mods = {"dense": transformer, "moe": transformer, "vlm": transformer, "unet": unet}
    if cfg.family not in mods:
        raise NotImplementedError(
            f"family {cfg.family!r} (zamba2, rwkv6, whisper) is a later slice of "
            f"the port (the other families)"
        )
    return mods[cfg.family]
