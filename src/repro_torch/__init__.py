"""PyTorch/CUDA port of the MSDF merged multiply-add system.

Mirrors ``repro`` (the JAX reference) one module per module.  Imports
torch, numpy and the standard library only — never jax, never ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
