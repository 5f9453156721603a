"""Heterogeneous shard splits (``repro_torch.parallel.hetero``), the
sharding rules (``parallel.sharding``) and the sharded forward's ops
(``parallel.ops``: ``sharded_embed``, the ``local_map`` bodies'
collectives, ``token_nll``)."""
from .hetero import hetero_split, replan_on_failure  # noqa: F401
