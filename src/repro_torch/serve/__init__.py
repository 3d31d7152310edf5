"""Serving primitives of the port: FIFO admission queue + slot table."""
