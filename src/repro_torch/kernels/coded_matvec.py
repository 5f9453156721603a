"""Skinny coded product Y = Ã @ X — the port of
``repro.kernels.coded_matvec.coded_matvec_pallas``, with an optional task
axis (the reference's ``vmap`` of it in ``ops.coded_matvec_batch``).

The CUDA kernels are in ``csrc/coded_matvec.cu`` (design notes there),
launched on the plans of :func:`repro_torch.kernels.plan.matvec_launches`:
the narrow SIMT routes, 8 columns a launch, and for more than 8 columns
summed in float64 the wide route on the FP64 tensor cores, 64 columns a
launch.  On a CPU tensor :func:`coded_matvec` runs the plain version; on a
CUDA tensor it launches the kernels or raises.

Types: float32 in → float32 out (the reference's numerics), float32 in →
float64 out (products that feed an MDS decode: exact products, float64
sums), float64 in → float64 out (the static executor).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._launch import I, P, check_cuda, raise_on_error, sm_count, stream_ptr
from .plan import matvec_launches
from .ref import coded_matvec_ref

__all__ = ["coded_matvec", "coded_matvec_cuda", "LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`)
LAUNCHES = 0

#: (input dtype, output dtype) → the C entry point's ``types`` code
_TYPES = {(torch.float32, torch.float32): 0,
          (torch.float32, torch.float64): 1,
          (torch.float64, torch.float64): 2}


def _lib():
    lib = _build.library("coded_matvec")
    if not getattr(lib, "_typed", False):
        lib.repro_coded_matvec.argtypes = [I, P, P, P, I, I, I, I, I, I, I,
                                           I, I, I, P, P]
        lib.repro_coded_matvec.restype = I
        lib.repro_coded_matvec_wide.argtypes = [I, P, P, P, I, I, I, I, I,
                                                I, I, I, P]
        lib.repro_coded_matvec_wide.restype = I
        lib._typed = True
    return lib


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor, *,
                      out_dtype: Optional[torch.dtype] = None,
                      route: Optional[str] = None) -> torch.Tensor:
    """Y = A @ X on the card: ``a`` (R, K) with ``x`` (K, C), or ``a``
    (B, R, K) with ``x`` (B, K, C), one launch per column chunk of X (8
    columns on the narrow routes, 64 on the wide; the task axis is in the
    grid), each on its plan from :func:`matvec_launches`.  ``out_dtype``
    defaults to the input dtype; K must be a multiple of the 16-byte
    vector width.  ``route="narrow"`` keeps a float64-output product of
    more than 8 columns on the 8-column launches, and ``route="element"``
    runs the direct route's launches as the parent did (X read element by
    element unless C is 1), for holding two routes to each other on the
    same inputs."""
    global LAUNCHES
    if route not in (None, "narrow", "element"):
        raise ValueError(f"coded_matvec: unknown route {route!r}")
    dev = a.device
    out_dtype = a.dtype if out_dtype is None else out_dtype
    types = _TYPES.get((a.dtype, out_dtype))
    if types is None:
        raise ValueError(f"coded_matvec: unsupported types {a.dtype} -> "
                         f"{out_dtype}")
    nd = a.dim()
    if nd not in (2, 3):
        raise ValueError(f"coded_matvec: expected 2-D or 3-D A, got shape "
                         f"{tuple(a.shape)}")
    check_cuda("coded_matvec a", a, a.dtype, nd, dev)
    check_cuda("coded_matvec x", x, a.dtype, nd, dev)
    B = a.shape[0] if nd == 3 else 1
    R, K = a.shape[-2:]
    if x.shape[-2] != K or (nd == 3 and x.shape[0] != B):
        raise ValueError(f"coded_matvec: shapes differ, {tuple(a.shape)} @ "
                         f"{tuple(x.shape)}")
    vec = 16 // a.element_size()
    if K % vec or a.data_ptr() % 16:
        raise ValueError(f"coded_matvec: the contraction width must be a "
                         f"multiple of {vec} and A 16-byte aligned (16-byte "
                         f"loads)")
    C = x.shape[-1]
    # a tuple of ints: a torch.Size costs a single call ~3 us more host work
    y = torch.empty((B, R, C) if nd == 3 else (R, C), dtype=out_dtype,
                    device=dev)
    if y.numel() == 0:
        return y
    lib, st = _lib(), stream_ptr(dev)
    out_esz = a.element_size() if route == "narrow" else y.element_size()
    for c0, p in matvec_launches(a.element_size(), R, K, C, B, sm_count(dev),
                                 out_esz):
        if p.route == "wide":
            err = lib.repro_coded_matvec_wide(
                types, a.data_ptr(), x.data_ptr(), y.data_ptr(), B, R, K, C,
                c0, p.grid[0], p.splits, p.k_span, st)
        else:
            code, xcopy = p.route_code, None
            if p.route == "direct" and route == "element":
                code = 2
            elif p.route == "direct" and (p.x_copy or x.data_ptr() % 16):
                xcopy = torch.empty(B * p.cc * K, dtype=a.dtype, device=dev)
            err = lib.repro_coded_matvec(
                types, a.data_ptr(), x.data_ptr(), y.data_ptr(), B, R, K, C,
                c0, code, p.grid[0], p.rows_per_block, p.slab_bytes,
                p.blocks_per_sm, None if xcopy is None else xcopy.data_ptr(),
                st)
        raise_on_error("coded_matvec", err)
        LAUNCHES += 1
    return y


def coded_matvec(a: torch.Tensor, x: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Y = Ã @ X for X (K, C) (or a stack of both): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return coded_matvec_ref(a, x, out_dtype=out_dtype)
    return coded_matvec_cuda(a, x, out_dtype=out_dtype)
