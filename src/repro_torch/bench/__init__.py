"""Benchmarks of the port that run as modules (``python -m
repro_torch.bench.<name>``)."""
