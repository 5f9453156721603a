"""Carry the reference's parameters into the port (for the tests).

``repro``'s ``init_model`` draws with ``jax.random``; the port draws its
own with a seeded ``torch.Generator``, so the two never share values by
construction.  The parity tests take the reference's tree as numpy
(``jax.tree.map(np.asarray, params)``) and convert it here, so both
packages compute the same function.  The tree layouts are the same: dicts,
and the list of a model's prefix layers.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ArchConfig
from .models.lm import torch_dtype

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """The reference's parameter tree (numpy leaves) as the port's tensors
    on ``device`` (default ``cuda``).  Each leaf keeps its own dtype:
    ``cfg.dtype``, or float32 where the reference keeps a leaf in float32
    inside any config (the MoE router, Mamba's ``a_log``); any other
    dtype raises."""
    dev = resolve_device(device)
    allowed = {torch_dtype(cfg), torch.float32}

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        dt = getattr(torch, str(x.dtype))
        if dt not in allowed:
            raise TypeError(f"leaf of dtype {x.dtype} in a {cfg.dtype} "
                            f"model")
        # via float32: numpy has no bfloat16 that torch can read directly,
        # and every bfloat16 value is exact in float32
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(
            device=dev, dtype=dt)

    return conv(tree)
