"""LR schedules — the port of ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup → cosine decay to ``floor``·peak.

    The returned ``lr(step)`` computes in float32, as the reference's
    ``jnp`` does (Python scalars enter each operation as float32), and
    returns a 0-d float32 tensor on the step's device (the CPU for a
    Python int)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
