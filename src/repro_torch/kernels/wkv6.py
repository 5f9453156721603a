"""RWKV-6 WKV recurrence — the port of ``repro.kernels.wkv6.wkv6_pallas``
with the model's interface (``repro.models.rwkv.wkv6_chunked``): a
per-head ``u``, an optional initial state, and the final state returned.

The CUDA kernel is ``csrc/wkv6.cu`` (design notes there).  On CPU tensors
:func:`wkv6_dev` runs the plain version
(:func:`repro_torch.kernels.ref.wkv6_chunked_ref`); on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import I, P, check_cuda, raise_on_error, stream_ptr
from .ref import wkv6_chunked_ref

__all__ = ["wkv6_dev", "wkv6_cuda", "WKV6_LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`)
WKV6_LAUNCHES = 0

#: input dtype → the C entry point's ``types`` code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: state rows per thread (K must be a multiple) and the largest head size
_KS, _K_MAX = 8, 128


def _lib():
    lib = _build.library("wkv6")
    if not getattr(lib, "_typed", False):
        lib.repro_wkv6.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                   P]
        lib.repro_wkv6.restype = I
        lib._typed = True
    return lib


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 on the card.  r, k, w (BH, T, K) and v (BH, T, V) float32 or
    bfloat16, all one type; u (H, K) float32 (row bh uses head bh % H);
    ``state`` (BH, K, V) float32 or None for zeros.  Returns (out (BH, T,
    V) in the input type, final state (BH, K, V) float32)."""
    global WKV6_LAUNCHES
    dev, dt = r.device, r.dtype
    if dt not in _TYPES:
        raise ValueError(f"wkv6: expected float32 or bfloat16, got {dt}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        check_cuda(f"wkv6 {name}", t, dt, 3, dev)
    check_cuda("wkv6 u", u, torch.float32, 2, dev)
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:2] != (BH, T) \
            or u.shape[1] != K or BH % H:
        raise ValueError(f"wkv6: shapes differ, r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} w "
                         f"{tuple(w.shape)} u {tuple(u.shape)}")
    if K % _KS or K > _K_MAX or BH > 65535:
        raise ValueError(f"wkv6: the head size must be a multiple of {_KS} "
                         f"up to {_K_MAX} and B*H at most 65535, got K={K}, "
                         f"BH={BH}")
    if state is not None:
        check_cuda("wkv6 state", state, torch.float32, 3, dev)
        if tuple(state.shape) != (BH, K, V):
            raise ValueError(f"wkv6: state must be {(BH, K, V)}, got "
                             f"{tuple(state.shape)}")
    out = torch.empty((BH, T, V), dtype=dt, device=dev)
    s_out = torch.empty((BH, K, V), dtype=torch.float32, device=dev)
    err = _lib().repro_wkv6(_TYPES[dt], r.data_ptr(), k.data_ptr(),
                            v.data_ptr(), w.data_ptr(), u.data_ptr(),
                            None if state is None else state.data_ptr(),
                            out.data_ptr(), s_out.data_ptr(), BH, H, T, K, V,
                            stream_ptr(dev))
    raise_on_error("wkv6", err)
    WKV6_LAUNCHES += 1
    return out, s_out


def wkv6_dev(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over (BH, T, ·) rows with u (H, K): the kernel for CUDA
    tensors, the plain chunked version (``chunk`` steps per chunk) for CPU
    tensors.  Returns (out, final state) as :func:`wkv6_cuda` does."""
    if r.device.type != "cpu":
        return wkv6_cuda(r, k, v, w, u, state)
    BH, T, K = r.shape
    H, V = u.shape[0], v.shape[-1]
    B = BH // H
    out, s = wkv6_chunked_ref(
        r.reshape(B, H, T, K), k.reshape(B, H, T, K), v.reshape(B, H, T, V),
        w.reshape(B, H, T, K), u,
        None if state is None else state.reshape(B, H, K, V), chunk=chunk)
    return out.reshape(BH, T, V), s.reshape(BH, K, V)
