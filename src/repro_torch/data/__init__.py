"""The data pipeline: step-indexed, seeded batches (numpy)."""
from . import pipeline  # noqa: F401
