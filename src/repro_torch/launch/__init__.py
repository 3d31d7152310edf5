"""Entry points run as ``python -m repro_torch.launch.<name>``."""
