"""The paper's U-Net (Table-1-calibrated geometry) — see models/unet.py."""
from repro_torch.models.unet import UNetConfig


def config() -> UNetConfig:
    return UNetConfig()


def smoke_config() -> UNetConfig:
    return UNetConfig(hw=16, in_ch=4, base=8, depth=2, n_classes=3)
