"""Device selection for the port's entry points.

Every entry point takes a ``device`` and defaults to ``"cuda"``.  There is
no silent CPU path: asking for CUDA on a machine without a card raises,
and the CPU runs only when the caller names it (as the CPU tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None → ``"cuda"``) as a :class:`torch.device`.

    Raises ``RuntimeError`` for a CUDA device when no card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain-torch path")
    return dev
