"""Model zoo of the port (slice 1: the U-Net)."""
