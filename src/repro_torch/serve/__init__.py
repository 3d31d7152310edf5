"""Serving of the port: the LM decode engine (continuous batching over a
slot table) and the serving primitives it shares with the segmentation
engine (FIFO admission queue + slot table)."""
from .engine import Engine, Request  # noqa: F401
