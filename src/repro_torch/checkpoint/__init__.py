"""Atomic, reference-compatible checkpointing."""
from .manager import CheckpointManager  # noqa: F401
