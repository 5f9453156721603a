"""Heterogeneous shard splits (``repro_torch.parallel.hetero``) and the
training loss's single-device ``token_nll`` (``parallel.ops``).

The mesh sharding layer (``repro.parallel.sharding``, ``sharded_embed``)
is not ported yet."""
from .hetero import hetero_split, replan_on_failure  # noqa: F401
