"""Shared checks and launch plumbing for the ctypes-bound CUDA kernels."""
from __future__ import annotations

import ctypes

import torch

__all__ = ["check_cuda", "stream_ptr", "raise_on_error", "sm_count",
           "fake_only", "P", "I", "U32", "F32"]

P = ctypes.c_void_p
I = ctypes.c_int
U32 = ctypes.c_uint32
F32 = ctypes.c_float


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
               device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` CUDA tensor of rank
    ``ndim`` on ``device``."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer (read
    without building a ``torch.cuda.Stream``: a launch's host work)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(idx)


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def fake_only(name: str, t: torch.Tensor) -> None:
    """An operator's shape-only implementation runs for fake tensors alone
    (the dry-run's traces): a meta tensor has no device to run on."""
    from torch._subclasses.fake_tensor import is_fake
    if not is_fake(t):
        raise ValueError(f"{name}: expected a tensor on a CUDA device or "
                         f"the CPU, got {t.device}")
