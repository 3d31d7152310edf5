"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  A
missing card is an error, never a quiet fall back to the CPU: the CPU runs
only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` naming the missing card when CUDA is asked for
    (explicitly or by default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is false. The port runs "
            "on the GPU by default; pass device='cpu' to run its plain "
            "PyTorch version on the CPU"
        )
    return dev
