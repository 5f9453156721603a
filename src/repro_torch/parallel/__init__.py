"""Heterogeneous shard splits (``repro_torch.parallel.hetero``).

The mesh sharding layer (``repro.parallel.sharding``/``ops``) is not
ported yet."""
from .hetero import hetero_split, replan_on_failure  # noqa: F401
