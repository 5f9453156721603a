"""Skinny coded product Y = Ã @ X — the port of
``repro.kernels.coded_matvec.coded_matvec_pallas``.

The CUDA kernel is ``csrc/coded_matvec.cu`` (design notes there).  On a
CPU tensor :func:`coded_matvec` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, check_cuda, raise_on_error, stream_ptr
from .ref import coded_matvec_ref

__all__ = ["coded_matvec", "coded_matvec_cuda", "LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`)
LAUNCHES = 0


def _lib():
    lib = _build.library("coded_matvec")
    if not getattr(lib, "_typed", False):
        lib.repro_coded_matvec_f32.argtypes = [P, P, P, I, I, I, P]
        lib.repro_coded_matvec_f32.restype = I
        lib._typed = True
    return lib


def coded_matvec_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y (R, C) = A (R, K) @ X (K, C) on the card, float32; K % 4 == 0."""
    global LAUNCHES
    dev = a.device
    check_cuda("coded_matvec a", a, torch.float32, 2, dev)
    check_cuda("coded_matvec x", x, torch.float32, 2, dev)
    R, K = a.shape
    if x.shape[0] != K:
        raise ValueError(f"coded_matvec: inner dims differ, {tuple(a.shape)}"
                         f" @ {tuple(x.shape)}")
    if K % 4 or a.data_ptr() % 16:
        raise ValueError("coded_matvec: the contraction width must be a "
                         "multiple of 4 and A 16-byte aligned (float4 loads)")
    C = x.shape[1]
    y = torch.empty((R, C), dtype=torch.float32, device=dev)
    err = _lib().repro_coded_matvec_f32(a.data_ptr(), x.data_ptr(),
                                        y.data_ptr(), R, K, C,
                                        stream_ptr(dev))
    raise_on_error("coded_matvec", err)
    LAUNCHES += 1
    return y


def coded_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = Ã @ X for X (K, C): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.device.type == "cpu":
        return coded_matvec_ref(a, x)
    return coded_matvec_cuda(a, x)
