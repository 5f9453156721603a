"""input_specs(): allocation-free stand-ins for every model input of every
(arch × shape) cell — the port of ``repro.launch.specs``.

The stand-ins are fake tensors (``torch._subclasses.FakeTensorMode``: a
shape, a dtype and a device, no storage), the caches the
:func:`~repro_torch.models.init_cache_shapes` template of ``(shape,
dtype)`` leaves.  Modality frontends are stubs, as in the reference:
``enc_feats`` (audio frames) and ``patch_feats`` (vision patches) arrive
as precomputed embeddings, and for the VLM the text length is reduced so
patches + text == the cell's seq_len.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..models import ArchConfig, ShapeCell, init_cache_shapes
from ..models.lm import torch_dtype
from ..parallel.sharding import (batch_sharding, cache_shardings,
                                 data_axes_of, mesh_shape)

__all__ = ["input_specs", "input_shardings", "microbatches_for"]


def input_specs(cfg: ArchConfig, cell: ShapeCell, *, device="cuda",
                fake_mode=None) -> Dict[str, Any]:
    """Model inputs for one cell, as fake tensors of ``fake_mode`` (a new
    ``FakeTensorMode`` when None) on ``device``.  Keys depend on
    cell.kind:

    train:   tokens, labels (+ modality feats)
    prefill: tokens (+ modality feats), caches
    decode:  tokens (B,1), pos (B,), caches (+ enc_out for enc-dec)
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode() if fake_mode is None else fake_mode
    B, T = cell.global_batch, cell.seq_len
    text_T = T
    if cfg.frontend == "vision":
        text_T = T - cfg.frontend_len
    dt = torch_dtype(cfg)

    def sds(shape, dtype):
        with fake_mode:
            return torch.empty(shape, dtype=dtype, device=device)

    feats = (B, cfg.frontend_len, cfg.frontend_dim)
    out: Dict[str, Any] = {}
    if cell.kind == "train":
        out["tokens"] = sds((B, text_T), torch.int32)
        out["labels"] = sds((B, text_T), torch.int32)
        if cfg.enc_dec:
            out["enc_feats"] = sds(feats, dt)
        if cfg.frontend == "vision":
            out["patch_feats"] = sds(feats, dt)
    elif cell.kind == "prefill":
        out["tokens"] = sds((B, text_T), torch.int32)
        if cfg.enc_dec:
            out["enc_feats"] = sds(feats, dt)
        if cfg.frontend == "vision":
            out["patch_feats"] = sds(feats, dt)
        out["caches"] = init_cache_shapes(cfg, B, T)
    elif cell.kind == "decode":
        out["tokens"] = sds((B, 1), torch.int32)
        out["pos"] = sds((B,), torch.int32)
        out["caches"] = init_cache_shapes(cfg, B, T)
        if cfg.enc_dec:
            out["enc_out"] = sds((B, cfg.frontend_len, cfg.d_model), dt)
    else:
        raise ValueError(cell.kind)
    return out


def input_shardings(specs: Dict[str, Any], mesh, cell: ShapeCell
                    ) -> Dict[str, Any]:
    """The PartitionSpec tree matching ``input_specs``' output."""
    B = cell.global_batch
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "caches":
            out[k] = cache_shardings(v, mesh, B)
        else:
            out[k] = batch_sharding(mesh, tuple(v.shape))
    return out


# Per-arch microbatch counts for the train cells (memory-term lever; the
# global batch must stay divisible by dp × n_micro).
_BIG = {"deepseek-v3-671b", "jamba-1.5-large-398b", "dbrx-132b"}


def microbatches_for(cfg: ArchConfig, cell: ShapeCell, mesh,
                     override: Optional[int] = None) -> int:
    if cell.kind != "train":
        return 1
    if override is not None:
        return override
    shape = mesh_shape(mesh)
    dp = math.prod(shape[a] for a in data_axes_of(mesh))
    cap = max(1, cell.global_batch // dp)      # ≥1 sequence per shard
    want = 16 if cfg.name in _BIG else 8
    n = min(want, cap)
    while cell.global_batch % (dp * n):
        n -= 1
    return max(n, 1)
