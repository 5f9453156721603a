"""Tiled float32 GEMM — the port of ``repro.kernels.matmul.matmul_pallas``.

The CUDA kernel is ``csrc/matmul.cu`` on the float32 core of
``csrc/sgemm.cuh`` (design notes there), launched on the plan of
:func:`repro_torch.kernels.plan.gemm_plan`.  On a CPU tensor
:func:`matmul` runs the plain version; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import I, P, check_cuda, raise_on_error, sm_count, stream_ptr
from .plan import gemm_plan
from .ref import matmul_ref

__all__ = ["matmul", "matmul_cuda", "LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`)
LAUNCHES = 0


def _lib():
    lib = _build.library("matmul")
    if not getattr(lib, "_typed", False):
        lib.repro_matmul_f32.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        lib.repro_matmul_f32.restype = I
        lib._typed = True
    return lib


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the card: ``a`` (M, K), ``b`` (K, N) float32 CUDA."""
    global LAUNCHES
    dev = a.device
    check_cuda("matmul a", a, torch.float32, 2, dev)
    check_cuda("matmul b", b, torch.float32, 2, dev)
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"matmul: inner dims differ, {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    N = b.shape[1]
    plan = gemm_plan("f32", M, N, K, sms=sm_count(dev))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = torch.empty((max(plan.ws_elems, 1),), dtype=torch.float32,
                     device=dev)
    err = _lib().repro_matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  ws.data_ptr(), M, N, K, plan.config.code,
                                  plan.splits, plan.k_span, stream_ptr(dev))
    raise_on_error("matmul", err)
    LAUNCHES += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, float32 accumulation, in A's dtype: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    return matmul_cuda(a.float().contiguous(),
                       b.float().contiguous()).to(a.dtype)
