"""Optimizers: AdamW (mixed precision, clipping), the LR schedule, and
error-feedback int8 gradient compression."""
from . import adamw, grad_compress, schedule  # noqa: F401
