"""Parallelism: logical-axis sharding rules and the device mesh
(``sharding``), per-parameter specs (``param_specs``), the collectives
(``collectives``), the dense transformer's tensor- and data-parallel loss
(``sharded_lm``) and GPipe pipeline parallelism (``pipeline``)."""
from . import sharding  # noqa: F401
