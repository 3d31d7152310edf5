"""The port's config as the reference's schema sees it, for the tests that
compare the two packages' configs field by field."""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig


def reference_view(cfg, ref_cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the fields the reference's schema
    lacks (latent attention, the held-expert layer), each asserted at its
    default: an architecture of the reference uses none of them."""
    out, ref = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    for cls, mine, theirs in ((ArchConfig, out, ref), (MoEConfig, out["moe"], ref["moe"])):
        for extra in set(mine) - set(theirs):
            assert mine.pop(extra) == cls.__dataclass_fields__[extra].default, extra
    return out
