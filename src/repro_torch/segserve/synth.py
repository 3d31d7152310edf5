"""Synthetic medical-style test images for the segmentation bench/examples.

One generator shared by ``benchmarks/segserve.py`` and
``examples/segment_image.py`` so the image the bench prices and the image
the example demonstrates never drift apart.
"""
from __future__ import annotations

import numpy as np


def phantom_image(h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    """Quiet background with one bright structure near the top-left — the
    content-adaptive case: tiles whose halo window clears the structure sit
    orders of magnitude below the image amplitude."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0.0, 0.01, (h, w, c))
    sh, sw = max(1, h // 5), max(1, w // 4)
    img[sh : 2 * sh, sw : 2 * sw] += rng.normal(0.0, 1.0, (sh, sw, c))
    return img.astype(np.float32)
