"""RWKV-6 WKV recurrence — the port of ``repro.kernels.wkv6.wkv6_pallas``
with the model's interface (``repro.models.rwkv.wkv6_chunked``): a
per-head ``u``, an optional initial state, and the final state returned.

The CUDA kernels are ``csrc/wkv6.cu`` (design notes there): a chunked
tensor-core form for T > 1 and a state-streaming decode for T <= 1, on the
plan of :func:`repro_torch.kernels.plan.wkv6_plan`.  On CPU tensors
:func:`wkv6_dev` runs the plain version
(:func:`repro_torch.kernels.ref.wkv6_chunked_ref`); on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import I, P, check_cuda, raise_on_error, stream_ptr
from .plan import WKV_K_MAX, wkv6_plan
from .ref import wkv6_chunked_ref

__all__ = ["wkv6_dev", "wkv6_cuda", "WKV6_LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`)
WKV6_LAUNCHES = 0

#: input dtype → the C entry point's ``types`` code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("wkv6")
    if not getattr(lib, "_typed", False):
        lib.repro_wkv6.argtypes = [I] + [P] * 8 + [I] * 14 + [P]
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
    V) in the input type, final state (BH, K, V) float32), one launch on
    the :func:`wkv6_plan` of the shape."""
    global WKV6_LAUNCHES
    dev, dt = r.device, r.dtype
    # types and shapes first, then devices: every refusal raises
    if dt not in _TYPES:
        raise ValueError(f"wkv6: expected float32 or bfloat16, got {dt}")
    if any(t.dtype != dt for t in (k, v, w)) or u.dtype != torch.float32 \
            or (state is not None and state.dtype != torch.float32):
        raise ValueError(f"wkv6: r, k, v, w must share one type and u, "
                         f"state be float32, got {r.dtype} {k.dtype} "
                         f"{v.dtype} {w.dtype} u {u.dtype}")
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError(f"wkv6: expected r, k, v, w of rank 3 and u of "
                         f"rank 2, got {tuple(r.shape)} {tuple(v.shape)} "
                         f"{tuple(u.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:2] != (BH, T) \
            or u.shape[1] != K or H == 0 or BH % H:
        raise ValueError(f"wkv6: shapes differ, r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} w "
                         f"{tuple(w.shape)} u {tuple(u.shape)}")
    if K % 8 or K > WKV_K_MAX or BH > 65535:
        raise ValueError(f"wkv6: the head size must be a multiple of 8 up "
                         f"to {WKV_K_MAX} and B*H at most 65535, got K={K}, "
                         f"BH={BH}")
    if state is not None and tuple(state.shape) != (BH, K, V):
        raise ValueError(f"wkv6: state must be {(BH, K, V)}, got "
                         f"{tuple(state.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t is not None:
            check_cuda(f"wkv6 {name}", t, t.dtype, t.dim(), dev)
    out = torch.empty((BH, T, V), dtype=dt, device=dev)
    s_out = torch.empty((BH, K, V), dtype=torch.float32, device=dev)
    if BH == 0 or V == 0:
        return out, s_out
    # 16-byte state rows for the decode when the layout allows them
    vec = 4 if V % 4 == 0 and (state is None or state.data_ptr() % 16 == 0) \
        else 1
    p = wkv6_plan(T, K, V, BH, vec)
    err = _lib().repro_wkv6(_TYPES[dt], r.data_ptr(), k.data_ptr(),
                            v.data_ptr(), w.data_ptr(), u.data_ptr(),
                            None if state is None else state.data_ptr(),
                            out.data_ptr(), s_out.data_ptr(), BH, H, T, K, V,
                            p.route_code, p.chunk, p.sub, p.kk, p.vb, p.vec,
                            p.grid[0], p.smem_bytes, p.blocks_per_sm,
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
    tensors.  Returns (out, final state) as :func:`wkv6_cuda` does.

    The kernel has no backward: on the card a call that autograd would
    record (grad mode on and an input that requires grad) raises rather
    than return an output that drops its gradient.  The plain version is
    differentiable."""
    if r.device.type != "cpu":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (r, k, v, w, u, state)):
            raise RuntimeError(
                "wkv6: the CUDA kernel has no backward, so it cannot train "
                "(run it under torch.no_grad() or inference_mode, or train "
                "RWKV on the CPU)")
        return wkv6_cuda(r, k, v, w, u, state)
    BH, T, K = r.shape
    H, V = u.shape[0], v.shape[-1]
    B = BH // H
    out, s = wkv6_chunked_ref(
        r.reshape(B, H, T, K), k.reshape(B, H, T, K), v.reshape(B, H, T, V),
        w.reshape(B, H, T, K), u,
        None if state is None else state.reshape(B, H, K, V), chunk=chunk)
    return out.reshape(BH, T, V), s.reshape(BH, K, V)
