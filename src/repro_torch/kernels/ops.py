"""Public wrappers around the Hopper kernels — the port of
``repro.kernels.ops``.

Same signatures and shape conventions as the reference: (S,) vs (S, B)
vectors, 128-aligned packed shard tiles, generated-parity lane specs.  The
kernels mask their own ragged edges, so ``matmul`` needs no padding; the
skinny product pads its contraction to ``block_k`` exactly as the
reference does (which also gives the kernel's 16-byte rows).  Every call
on a CUDA tensor launches the hand-written kernel or raises; CPU tensors
take the plain version (:mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs import device_span
from .coded_matvec import coded_matvec as _coded_matvec
from .matmul import matmul
from .mds_encode import counter_parity_rows_dev, gen_parity_matvec

__all__ = ["matmul", "coded_matvec", "coded_shard_matmul_batch",
           "counter_parity_rows", "parity_scale", "gen_parity_products",
           "GeneratedParity"]


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def parity_scale(L: int) -> float:
    """The float32 ``sqrt(3/L)`` every counter-derived entry is scaled by."""
    return float(np.float32(np.sqrt(3.0 / L)))


def _u32_tensor(ctrs, device: torch.device) -> torch.Tensor:
    """Host uint32 counters → an int64 tensor of the same values."""
    if isinstance(ctrs, torch.Tensor):
        return ctrs.to(device)
    return torch.from_numpy(
        np.asarray(ctrs, dtype=np.uint32).astype(np.int64)).to(device)


def coded_matvec(a_tilde: torch.Tensor, x: torch.Tensor, *,
                 block_k: int = 128) -> torch.Tensor:
    """y = Ã @ x for x (S,) or (S, B); pads the contraction, keeps B whole."""
    squeeze = x.dim() == 1
    xm = x[:, None] if squeeze else x
    ap = _pad_to(a_tilde.float(), 1, block_k).contiguous()
    xp = _pad_to(xm.float(), 0, block_k).contiguous()
    y = _coded_matvec(ap, xp)
    return y[:, 0] if squeeze else y


def counter_parity_rows(key: Tuple[int, int], L: int, ctrs, *,
                        cols=None, device=None) -> torch.Tensor:
    """Counter-derived parity generator rows R[ctrs] (n, L) float32 — or
    only the columns ``cols`` (n, m) when given.

    Bit-identical to :func:`repro_torch.core.mds.counter_parity_rows` for
    the same ``(key, ctrs)`` (the column subset is the same entries).
    ``ctrs`` may be host uint32 counters or a device tensor; the result
    lies on ``device`` (default ``cuda``)."""
    dev = ctrs.device if isinstance(ctrs, torch.Tensor) and device is None \
        else resolve_device(device)
    c = _u32_tensor(ctrs, dev)
    j = torch.arange(L, device=dev) if cols is None \
        else _u32_tensor(cols, dev)
    return counter_parity_rows_dev(key, parity_scale(L), c, j)


def gen_parity_products(key: Tuple[int, int], ctrs, w: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Generated-parity shard products (n, C): ``R_gen[ctrs] @ (W @ x)``.

    ``w`` (L, D) float32 systematic weights (device-resident), ``x``
    (D', C) with D' ≥ D — rows beyond D are the packed tiles' zero padding
    and are dropped (the reference's XLA twin contracted the padded x
    against the unpadded W and failed whenever D was not a multiple of
    128)."""
    L, D = w.shape
    c = _u32_tensor(ctrs, w.device)
    with device_span("gen_parity_products", cat="kernel",
                     args={"rows": int(c.numel()), "L": int(L)}) as fence:
        out = fence(gen_parity_matvec(key, parity_scale(L), c, w,
                                      x[:D].float()))
    return out


@dataclasses.dataclass
class GeneratedParity:
    """Virtual-parity lane spec for one packed problem.

    ``lanes`` index into the flattened (T·R,) tile row space; their
    products come from the generated kernel instead of the tiles (whose
    corresponding rows are zero-filled).  ``ctrs`` are the packed
    (row | draw << 24) counters, ``w`` the layer's device-resident
    systematic weights.
    """
    lanes: np.ndarray           # (n,) flat lane indices in tile space
    ctrs: np.ndarray            # (n,) packed parity-row counters (uint32)
    key: Tuple[int, int]        # per-layer threefry key
    w: torch.Tensor             # (L, D) float32 systematic weights


def coded_shard_matmul_batch(tiles: torch.Tensor, x: torch.Tensor, *,
                             block_rows: int = 128, block_k: int = 128,
                             parity_mode: str = "materialized",
                             parity: Optional[Sequence[GeneratedParity]]
                             = None) -> torch.Tensor:
    """Every packed shard tile of a serving step against one operand, in
    one launch: ``tiles`` (T, R, K) block-aligned encoded-row tiles, ``x``
    (K, C) → (T, R, C).

    The tile axis flattens into the row axis of the coded_matvec kernel
    (per-row results are independent of the bucketing, so the packing
    layer may re-bucket ragged shards freely).  ``parity_mode=
    "generated"`` is virtual-parity execution: parity lanes are zero rows
    in ``tiles`` and each :class:`GeneratedParity` entry re-derives those
    lanes' products through :func:`gen_parity_products`.  The reference's
    ``mode="vmap"`` jnp fallback has no counterpart: CPU tensors take the
    plain version inside the kernel wrapper.
    """
    T, R, K = tiles.shape
    if parity_mode not in ("materialized", "generated"):
        raise ValueError(f"unknown parity_mode {parity_mode!r}; expected "
                         f"materialized | generated")
    if R % block_rows or K % block_k:
        raise ValueError(f"tiles must be block-aligned, got R={R} K={K} "
                         f"for block ({block_rows}, {block_k})")
    gen = parity_mode == "generated" and parity
    with device_span("coded_shard_matmul_batch", cat="kernel",
                     args={"tiles": T, "rows": T * R, "k": K,
                           "parity_mode": parity_mode}) as fence:
        flat = fence(_coded_matvec(tiles.reshape(T * R, K),
                                   x.float().contiguous()))
    if gen:
        for spec in parity:
            yp = gen_parity_products(spec.key, spec.ctrs, spec.w, x)
            lanes = torch.from_numpy(
                np.asarray(spec.lanes, dtype=np.int64)).to(flat.device)
            flat[lanes] = yp
    return flat.reshape(T, R, -1)
