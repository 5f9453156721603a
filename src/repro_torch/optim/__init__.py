"""Optimizers of the port (tree-based, as the reference's): AdamW,
Adafactor and the cosine schedule."""
from .adamw import adamw_init, adamw_update, OptState  # noqa: F401
from .adafactor import adafactor_init, adafactor_update  # noqa: F401
from .schedule import cosine_warmup  # noqa: F401
