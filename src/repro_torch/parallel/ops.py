"""Primitive ops used by the training loss — the port of
``repro.parallel.ops``, single-device.

``token_nll`` is the reference's cross-entropy; its sharded embedding
(``sharded_embed``) arrives with the port's parallelism.
"""
from __future__ import annotations

import torch

__all__ = ["token_nll"]


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(labels) per token.

    logits (B, T, V) any dtype; labels (B, T) integer (int32 as the data
    pipeline gives them) → (B, T) float32.  The max is detached, as the
    reference's ``stop_gradient``; the label's logit is gathered (the
    reference's iota-compare sum picks the same value)."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    shifted = lg - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked
