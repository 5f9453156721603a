"""Counter-derived parity kernels — the ports of
``repro.kernels.mds_encode.counter_parity_rows_pallas`` and
``gen_parity_matvec_pallas``.

The CUDA kernels are in ``csrc/mds_encode.cu`` (design notes there).  On
CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.  ``mds_encode_pallas`` (Ã = G @ A for the
static executor) is not ported yet.
"""
from __future__ import annotations

import torch

from . import _build
from ._launch import F32, I, P, U32, check_cuda, raise_on_error, stream_ptr
from .coded_matvec import coded_matvec
from .ref import counter_parity_rows_ref, gen_parity_ref

__all__ = ["counter_parity_rows_dev", "gen_parity_matvec", "ROWS_LAUNCHES",
           "GEN_LAUNCHES"]

#: launches of the counter-rows kernel since the last reset
ROWS_LAUNCHES = 0
#: launches of the generated-parity contraction kernel since the last reset
GEN_LAUNCHES = 0

_M32 = 0xFFFFFFFF


def _lib():
    lib = _build.library("mds_encode")
    if not getattr(lib, "_typed", False):
        lib.repro_counter_parity_rows.argtypes = [U32, U32, F32, P, I, P, I,
                                                  P, P]
        lib.repro_counter_parity_rows.restype = I
        lib.repro_gen_parity_contract.argtypes = [U32, U32, F32, P, I, P, I,
                                                  I, P, P]
        lib.repro_gen_parity_contract.restype = I
        lib._typed = True
    return lib


def _as_u32(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor of uint32 values → int32 storage with the same bits
    (what the kernels read as ``uint32_t``)."""
    if t.dtype == torch.int32:
        return t.contiguous()
    t = t.to(torch.int64) & _M32
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def counter_parity_rows_dev(key, scale: float, ctrs: torch.Tensor,
                            cols: torch.Tensor) -> torch.Tensor:
    """R[ctrs][:, cols] float32 (n, m).  ``ctrs``/``cols`` integer tensors
    of uint32 values on one device; bit-identical on both paths."""
    global ROWS_LAUNCHES
    dev = ctrs.device
    if dev.type == "cpu":
        return counter_parity_rows_ref(key, scale, ctrs, cols)
    c32 = _as_u32(ctrs)
    j32 = _as_u32(cols)
    check_cuda("counter_parity_rows ctrs", c32, torch.int32, 1, dev)
    check_cuda("counter_parity_rows cols", j32, torch.int32, 1, dev)
    n, m = c32.numel(), j32.numel()
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    err = _lib().repro_counter_parity_rows(
        int(key[0]) & _M32, int(key[1]) & _M32, float(scale), c32.data_ptr(),
        n, j32.data_ptr(), m, out.data_ptr(), stream_ptr(dev))
    raise_on_error("counter_parity_rows", err)
    ROWS_LAUNCHES += 1
    return out


def gen_parity_matvec(key, scale: float, ctrs: torch.Tensor, w: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Generated-parity products ``R_gen[ctrs] @ (W @ x)`` (n, C) float32.

    ``w`` (L, D) float32 systematic weights, ``x`` (D, C).  On the card
    ``W @ x`` runs once through the coded_matvec kernel and the contraction
    kernel derives every R entry in registers — no R and no WR in memory."""
    global GEN_LAUNCHES
    dev = w.device
    if dev.type == "cpu":
        return gen_parity_ref(key, scale, ctrs, w, x)
    L = w.shape[0]
    n, C = ctrs.numel(), x.shape[1]
    c32 = _as_u32(ctrs)
    check_cuda("gen_parity ctrs", c32, torch.int32, 1, dev)
    wx = coded_matvec(w, x.contiguous())               # (L, C), one launch
    out = torch.empty((n, C), dtype=torch.float32, device=dev)
    for c0 in range(0, C, 8):
        cc = min(8, C - c0)
        wxc = wx[:, c0:c0 + cc].contiguous() if C > 8 else wx
        yc = out if C <= 8 else torch.empty((n, cc), dtype=torch.float32,
                                             device=dev)
        err = _lib().repro_gen_parity_contract(
            int(key[0]) & _M32, int(key[1]) & _M32, float(scale),
            c32.data_ptr(), n, wxc.data_ptr(), L, cc, yc.data_ptr(),
            stream_ptr(dev))
        raise_on_error("gen_parity_matvec", err)
        GEN_LAUNCHES += 1
        if C > 8:
            out[:, c0:c0 + cc] = yc
    return out
