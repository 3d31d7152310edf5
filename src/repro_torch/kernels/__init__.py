"""Hand-written Hopper kernels of the port (sources in ``../csrc``), their
plain PyTorch versions and oracles."""
