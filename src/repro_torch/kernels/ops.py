"""Public wrappers around the Hopper kernels — the port of
``repro.kernels.ops``.

Same signatures and shape conventions as the reference: (S,) vs (S, B)
vectors, 128-aligned packed shard tiles, generated-parity lane specs,
shared or per-task generators.  The kernels mask their own ragged edges,
so ``matmul`` and ``mds_encode`` need no padding; the skinny product pads
its contraction to ``block_k`` exactly as the reference does (which also
gives the kernel's 16-byte rows), and ``coded_matvec_batch`` only to the
16-byte vector width (its operands are the executor's whole task
matrices).  Every call on a CUDA tensor launches the hand-written kernel
or raises; CPU tensors take the plain version
(:mod:`repro_torch.kernels.ref`).

Products that feed an MDS decode (``coded_shard_matmul_batch``,
``gen_parity_products``) come out in float64 by default: float32 inputs,
exact products, float64 sums.

``wkv6`` keeps the reference's WKV signature (one shared ``u``, output
only); ``wkv6_heads`` is the RWKV mixer's form (per-head ``u``, optional
initial state, final state returned).  Both run the one ``wkv6`` kernel.
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
from .mds_encode import (counter_parity_rows_dev, gen_parity_matvec,
                         mds_encode_dev, parity_contract_dev)
from .wkv6 import wkv6_dev

__all__ = ["matmul", "mds_encode", "mds_encode_batch", "coded_matvec",
           "coded_matvec_batch", "coded_shard_matmul_batch",
           "counter_parity_rows", "parity_contract", "parity_scale",
           "gen_parity_products",
           "GeneratedParity", "wkv6", "wkv6_heads"]


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
    """uint32 values → a tensor on ``device``: host arrays as int32 of the
    same bits (the kernels' operand type, so the wrappers convert
    nothing), tensors as they are."""
    if isinstance(ctrs, torch.Tensor):
        return ctrs.to(device)
    return torch.from_numpy(
        np.asarray(ctrs, dtype=np.uint32).view(np.int32)).to(device)


def coded_matvec(a_tilde: torch.Tensor, x: torch.Tensor, *,
                 block_k: int = 128) -> torch.Tensor:
    """y = Ã @ x for x (S,) or (S, B); pads the contraction, keeps B whole."""
    squeeze = x.dim() == 1
    xm = x[:, None] if squeeze else x
    ap = _pad_to(a_tilde.float(), 1, block_k).contiguous()
    xp = _pad_to(xm.float(), 0, block_k).contiguous()
    y = _coded_matvec(ap, xp)
    return y[:, 0] if squeeze else y


def mds_encode(g: torch.Tensor, a: torch.Tensor, *,
               systematic: bool = True) -> torch.Tensor:
    """Ã = G @ A for G (L̃, L), A (L, S).  With ``systematic`` the identity
    prefix is copied through bit-exact and only the parity rows are
    multiplied.  float64 A encodes in float64, anything else in float32."""
    return mds_encode_batch(g, a[None], systematic=systematic)[0]


def mds_encode_batch(g: torch.Tensor, a: torch.Tensor, *,
                     systematic: bool = True) -> torch.Tensor:
    """Batched Ã_b = G_b @ A_b over a leading task axis, in one launch.

    ``g`` is (B, L̃, L) per-task generators or a shared (L̃, L); ``a`` is
    (B, L, S)."""
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    return mds_encode_dev(g.to(dt).contiguous(), a.to(dt).contiguous(),
                          systematic=systematic)


def coded_matvec_batch(a_tilde: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Batched per-task coded products y_b = Ã_b @ x_b, in one launch
    per 8 columns of x.

    ``a_tilde`` (B, L, S), ``x`` (B, S) or (B, S, C) → (B, L[, C]).
    float64 operands run in float64, anything else in float32."""
    squeeze = x.dim() == 2
    xm = x[..., None] if squeeze else x
    dt = torch.float64 if (a_tilde.dtype == torch.float64
                           and x.dtype == torch.float64) else torch.float32
    vec = 2 if dt == torch.float64 else 4       # 16-byte loads
    ap = _pad_to(a_tilde.to(dt), 2, vec).contiguous()
    xp = _pad_to(xm.to(dt), 1, vec).contiguous()
    y = _coded_matvec(ap, xp)
    return y[..., 0] if squeeze else y


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
    j = torch.arange(L, dtype=torch.int32, device=dev) if cols is None \
        else _u32_tensor(cols, dev)
    return counter_parity_rows_dev(key, parity_scale(L), c, j)


def parity_contract(key: Tuple[int, int], L: int, ctrs, z: torch.Tensor, *,
                    cols=None, chunk: Optional[int] = None) -> torch.Tensor:
    """``R[ctrs][:, cols] @ z`` (n, C) float64 for the parity rows of an
    L-column generator: ``z`` (m, C) float64, ``cols`` (m,) column ids
    (None: 0..L-1, so m = L).  The counter-derived entries are the
    same bits as :func:`counter_parity_rows`'; on the card they are
    contracted on the chip and R never exists in memory (one launch for up
    to 8 columns of z, past 8 one launch per 64); on the CPU R is derived
    in row chunks of about ``chunk`` entries.  ``ctrs`` and ``cols`` may
    be host uint32 arrays or tensors; the result lies on z's device."""
    if cols is None and z.shape[0] != L:
        raise ValueError(f"parity_contract: z of {z.shape[0]} rows for "
                         f"the {L} columns of the generator")
    dev = z.device
    c = _u32_tensor(ctrs, dev)
    j = None if cols is None else _u32_tensor(cols, dev)
    return parity_contract_dev(key, parity_scale(L), c, j, z, chunk=chunk)


def gen_parity_products(key: Tuple[int, int], ctrs, w: torch.Tensor,
                        x: torch.Tensor, *,
                        out_dtype: torch.dtype = torch.float64
                        ) -> torch.Tensor:
    """Generated-parity shard products (n, C): ``R_gen[ctrs] @ (W @ x)``,
    accumulated and returned in ``out_dtype``.

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
                                      x[:D].float(), out_dtype=out_dtype))
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
                             = None,
                             out_dtype: torch.dtype = torch.float64
                             ) -> torch.Tensor:
    """Every packed shard tile of a serving step against one operand, in
    one launch per 8 columns: ``tiles`` (T, R, K) block-aligned float32
    encoded-row tiles, ``x`` (K, C) → (T, R, C) in ``out_dtype``.  The
    products feed the step's decode, so by default they are accumulated in
    float64 (float32 is the reference's numerics).

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
                                   x.float().contiguous(),
                                   out_dtype=out_dtype))
    if gen:
        for spec in parity:
            yp = gen_parity_products(spec.key, spec.ctrs, spec.w, x,
                                     out_dtype=out_dtype)
            lanes = torch.from_numpy(
                np.asarray(spec.lanes, dtype=np.int64)).to(flat.device)
            flat[lanes] = yp
    return flat.reshape(T, R, -1)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = 64) -> torch.Tensor:
    """Batched WKV6 with the reference's signature and result: r, k, w
    (BH, T, K), v (BH, T, V), one shared u (K,) → out (BH, T, V) in v's
    dtype, differentiable (the ``wkv6`` operator).  ``chunk`` is the plain version's
    chunk (CPU tensors); the kernel pads a ragged chunk itself."""
    K = r.shape[-1]
    out, _ = wkv6_dev(r.contiguous(), k.contiguous(), v.contiguous(),
                      w.contiguous(), u.float().reshape(1, K).contiguous(),
                      chunk=chunk)
    return out


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV mixer's WKV: r, k, w (B, H, T, K), v (B, H, T, V), u (H,
    K), ``state`` (B, H, K, V) or None for zeros → (out (B, H, T, V) in
    v's dtype, final state (B, H, K, V) float32), in one launch, and its
    gradient in one backward launch (the ``wkv6`` operator)."""
    B, H, T, K = r.shape
    V = v.shape[-1]

    def rows(t, width):
        return t.contiguous().reshape(B * H, T, width)

    s0 = None if state is None \
        else state.float().contiguous().reshape(B * H, K, V)
    out, s = wkv6_dev(rows(r, K), rows(k, K), rows(v, V), rows(w, K),
                      u.float().contiguous(), s0)
    return out.reshape(B, H, T, V), s.reshape(B, H, K, V)
