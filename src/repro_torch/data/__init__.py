"""Deterministic, resumable data pipeline."""
from .pipeline import TokenStream, make_batch_iterator  # noqa: F401
