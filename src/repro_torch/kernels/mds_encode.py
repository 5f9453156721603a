"""MDS encode kernels — the ports of
``repro.kernels.mds_encode.mds_encode_pallas`` (Ã = G @ A, with the
systematic prefix copied through and a task axis, as ``ops.mds_encode`` /
``ops.mds_encode_batch`` drive it), ``counter_parity_rows_pallas`` and
``gen_parity_matvec_pallas``, and the counter-derived parity contraction
``R[ctrs][:, cols] @ Z`` that serves both the generated-parity lanes and
the decode's substitution term (which the reference forms from whole
``counter_parity_rows_pallas`` blocks).

The CUDA kernels are in ``csrc/mds_encode_gemm.cu`` (the encode: GEMM
tiles, or one float32 stream pass for a few rows against a few) and
``csrc/mds_encode.cu`` (design notes there).  On CPU tensors the wrappers
run the plain versions; on CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._launch import (F32, I, P, U32, check_cuda, raise_on_error, sm_count,
                      stream_ptr)
from .coded_matvec import coded_matvec
from .plan import contract_launches, encode_plan, gemm_plan
from .ref import (counter_parity_rows_ref, gen_parity_ref, mds_encode_ref,
                  parity_contract_ref)

__all__ = ["mds_encode_dev", "mds_encode_cuda", "counter_parity_rows_dev",
           "gen_parity_matvec", "parity_contract_dev", "ENCODE_LAUNCHES",
           "ROWS_LAUNCHES", "GEN_LAUNCHES", "CONTRACT_LAUNCHES",
           "WIDE_CONTRACT_LAUNCHES"]

#: launches of the encode GEMM since the last reset
ENCODE_LAUNCHES = 0
#: launches of the counter-rows kernel since the last reset
ROWS_LAUNCHES = 0
#: launches of the narrow contraction kernel for generated-parity lanes
#: since the last reset
GEN_LAUNCHES = 0
#: launches of the narrow contraction kernel through parity_contract_dev
#: (the decode's substitution term) since the last reset
CONTRACT_LAUNCHES = 0
#: launches of the wide contraction kernel (more than 8 float64 columns),
#: through either wrapper, since the last reset
WIDE_CONTRACT_LAUNCHES = 0

_M32 = 0xFFFFFFFF


def _lib():
    lib = _build.library("mds_encode")
    if not getattr(lib, "_typed", False):
        lib.repro_counter_parity_rows.argtypes = [U32, U32, F32, P, I, P, I,
                                                  P, P]
        lib.repro_counter_parity_rows.restype = I
        lib.repro_parity_contract.argtypes = [I, U32, U32, F32, P, I, P, I,
                                              P, I, P, P]
        lib.repro_parity_contract.restype = I
        lib.repro_parity_contract_wide.argtypes = [U32, U32, F32, P, I, P, I,
                                                   P, I, I, P, I, I, I, P]
        lib.repro_parity_contract_wide.restype = I
        lib._typed = True
    return lib


def _gemm_lib():
    lib = _build.library("mds_encode_gemm")
    if not getattr(lib, "_typed", False):
        lib.repro_mds_encode.argtypes = [I, P, ctypes.c_longlong, P, P, I, I,
                                         I, I, I, I, I, I, P, P]
        lib.repro_mds_encode.restype = I
        lib.repro_mds_encode_stream.argtypes = [
            P, ctypes.c_longlong, P, P, I, I, I, ctypes.c_longlong, I, I, P]
        lib.repro_mds_encode_stream.restype = I
        lib._typed = True
    return lib


def _encode_shapes(g: torch.Tensor, a: torch.Tensor) -> Tuple[int, ...]:
    if a.dim() != 3 or g.dim() not in (2, 3):
        raise ValueError(f"mds_encode: expected a (B, L, S) and g (L~, L) or "
                         f"(B, L~, L), got {tuple(a.shape)}, "
                         f"{tuple(g.shape)}")
    B, L, S = a.shape
    Lt = g.shape[-2]
    if g.shape[-1] != L or (g.dim() == 3 and g.shape[0] != B):
        raise ValueError(f"mds_encode: g {tuple(g.shape)} does not match a "
                         f"{tuple(a.shape)}")
    return B, L, S, Lt


def mds_encode_dev(g: torch.Tensor, a: torch.Tensor, *,
                   systematic: bool = True) -> torch.Tensor:
    """Ã_b = G_b @ A_b for a stack: ``a`` (B, L, S), ``g`` one shared
    (L̃, L) generator or per-task (B, L̃, L), one dtype (float32 or
    float64, which is also the accumulation type) → (B, L̃, S).

    With ``systematic`` and L̃ > L, G's top L rows are taken to be I_L: the
    first L output rows are A's, bit-exact, and only the parity rows are
    multiplied.  CPU tensors take the plain version, CUDA tensors
    :func:`mds_encode_cuda`."""
    B, L, S, Lt = _encode_shapes(g, a)
    if a.device.type == "cpu":
        if not (systematic and Lt > L):
            return mds_encode_ref(g, a)
        return torch.cat([a, mds_encode_ref(g[..., L:, :], a)], dim=1)
    return mds_encode_cuda(g, a, systematic=systematic)


def mds_encode_cuda(g: torch.Tensor, a: torch.Tensor, *,
                    systematic: bool = True,
                    route: Optional[str] = None) -> torch.Tensor:
    """:func:`mds_encode_dev` on the card: one launch for the whole stack
    on the plan of :func:`repro_torch.kernels.plan.encode_plan` for the
    (L̃ - L or L̃) x L @ L x S products -- the float32 stream for a few
    rows against a few, else the GEMM tiles (the systematic prefix copied
    beside them).  ``route`` ("stream" or "gemm") overrides the plan's
    choice, for holding one route to the other on the same inputs."""
    global ENCODE_LAUNCHES
    B, L, S, Lt = _encode_shapes(g, a)
    dev = a.device
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mds_encode: expected float32 or float64, got "
                         f"{a.dtype}")
    check_cuda("mds_encode a", a, a.dtype, 3, dev)
    check_cuda("mds_encode g", g, a.dtype, g.dim(), dev)
    sys = systematic and Lt > L
    dt, M, sms = ("f64" if a.dtype == torch.float64 else "f32",
                  Lt - L if sys else Lt, sm_count(dev))
    plan = encode_plan(dt, M, S, L, B, sms)
    if route == "gemm" and plan.route != "gemm":
        plan = gemm_plan(dt, M, S, L, B, sms)
    elif route not in (None, plan.route):
        raise ValueError(f"mds_encode: route {route!r} cannot take a "
                         f"{dt} ({M} x {L}) @ ({L} x {S}) encode")
    out = torch.empty((B, Lt, S), dtype=a.dtype, device=dev)
    g_stride = Lt * L if g.dim() == 3 else 0
    if plan.route == "stream":
        err = _gemm_lib().repro_mds_encode_stream(
            g.data_ptr(), g_stride, a.data_ptr(), out.data_ptr(), B, Lt, L,
            S, int(sys), plan.grid[0], stream_ptr(dev))
    else:
        ws = torch.empty((max(plan.ws_elems, 1),), dtype=a.dtype,
                         device=dev)
        err = _gemm_lib().repro_mds_encode(
            int(dt == "f64"), g.data_ptr(), g_stride, a.data_ptr(),
            out.data_ptr(), B, Lt, L, S, int(sys), plan.config.code,
            plan.splits, plan.k_span, ws.data_ptr(), stream_ptr(dev))
    raise_on_error("mds_encode", err)
    ENCODE_LAUNCHES += 1
    return out


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


def _contract(key, scale: float, c32: torch.Tensor, j32, z: torch.Tensor,
              what: str, route: Optional[str] = None
              ) -> Tuple[torch.Tensor, int]:
    """R[c32][:, j32 or 0..m-1] @ z on the card, on the launches of
    :func:`repro_torch.kernels.plan.contract_launches` (a float32 z takes
    the narrow route) → (out (n, C) in z's dtype, narrow launches); the
    wide launches are counted here."""
    global WIDE_CONTRACT_LAUNCHES
    dev = z.device
    n, (m, C) = c32.numel(), z.shape
    f64 = z.dtype == torch.float64
    if route == "wide" and not f64:
        raise ValueError(f"{what}: the wide route takes a float64 z, got "
                         f"{z.dtype}")
    out = torch.empty((n, C), dtype=z.dtype, device=dev)
    lib, st = _lib(), stream_ptr(dev)
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    cols = None if j32 is None else j32.data_ptr()
    launches = {"narrow": 0, "wide": 0}
    for c0, p in contract_launches(n, m, C, route if f64 else "narrow"):
        if p.route == "wide":
            err = lib.repro_parity_contract_wide(
                k0, k1, float(scale), c32.data_ptr(), n, cols, m,
                z.data_ptr(), C, c0, out.data_ptr(), p.grid[0], p.splits,
                p.m_span, st)
            raise_on_error(what, err)
        else:
            # the narrow kernel takes Z and Y whole: a chunk of a wider z
            # is copied in and out
            whole = p.cc == C
            zc = z if whole else z[:, c0:c0 + p.cc].contiguous()
            yc = out if whole else torch.empty((n, p.cc), dtype=z.dtype,
                                               device=dev)
            err = lib.repro_parity_contract(
                int(f64), k0, k1, float(scale), c32.data_ptr(), n, cols, m,
                zc.data_ptr(), p.cc, yc.data_ptr(), st)
            raise_on_error(what, err)
            if not whole:
                out[:, c0:c0 + p.cc] = yc
        launches[p.route] += 1
    WIDE_CONTRACT_LAUNCHES += launches["wide"]
    return out, launches["narrow"]


def parity_contract_dev(key, scale: float, ctrs: torch.Tensor,
                        cols: Optional[torch.Tensor], z: torch.Tensor, *,
                        chunk: Optional[int] = None,
                        route: Optional[str] = None) -> torch.Tensor:
    """``R[ctrs][:, cols] @ z`` (n, C) float64, R never in memory.

    ``ctrs`` (n,) and ``cols`` (m,) integer tensors of uint32 values
    (``cols`` None: columns 0..m-1), ``z`` (m, C) float64, all on one
    device.  Each float32 R entry is widened exactly and accumulated in
    float64, in a fixed order (repeated calls give the same bits); on the
    card one launch for up to 8 columns of z, and past 8 the wide route,
    one launch per 64 columns, whose column's bits depend only on its
    data and m.  ``route`` ("narrow" or "wide") overrides that choice on
    the card, for holding the routes to each other on the same inputs.
    On the CPU the plain version derives R in row chunks of about
    ``chunk`` entries."""
    global CONTRACT_LAUNCHES
    if route not in (None, "narrow", "wide"):
        raise ValueError(f"parity_contract: unknown route {route!r}")
    dev = z.device
    if z.dtype != torch.float64 or z.dim() != 2:
        raise ValueError(f"parity_contract: expected z (m, C) float64, got "
                         f"{z.dtype} of shape {tuple(z.shape)}")
    m = z.shape[0]
    if cols is not None and (cols.dim() != 1 or cols.numel() != m):
        raise ValueError(f"parity_contract: {cols.numel()} columns for z of "
                         f"{m} rows")
    for name, t in (("ctrs", ctrs), ("cols", cols)):
        if t is not None and t.device != dev:
            raise ValueError(f"parity_contract {name}: expected a tensor on "
                             f"{dev}, got {t.device}")
    if dev.type == "cpu":
        return parity_contract_ref(
            key, scale, ctrs, torch.arange(m) if cols is None else cols, z,
            chunk=chunk)
    c32 = _as_u32(ctrs)
    check_cuda("parity_contract ctrs", c32, torch.int32, 1, dev)
    j32 = None
    if cols is not None:
        j32 = _as_u32(cols)
        check_cuda("parity_contract cols", j32, torch.int32, 1, dev)
    check_cuda("parity_contract z", z, torch.float64, 2, dev)
    out, n = _contract(key, scale, c32, j32, z, "parity_contract", route)
    CONTRACT_LAUNCHES += n
    return out


def gen_parity_matvec(key, scale: float, ctrs: torch.Tensor, w: torch.Tensor,
                      x: torch.Tensor, *,
                      out_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Generated-parity products ``R_gen[ctrs] @ (W @ x)`` (n, C).

    ``w`` (L, D) float32 systematic weights, ``x`` (D, C) float32.
    ``out_dtype`` float64 (the default: the products feed a decode)
    accumulates both products in float64; float32 is the reference's
    numerics.  On the card ``W @ x`` runs once through the coded_matvec
    kernel and the contraction kernel derives every R entry on the chip
    (the wide route's for more than 8 float64 columns) — no R and no WR in
    memory."""
    global GEN_LAUNCHES
    dev = w.device
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"gen_parity: unsupported output {out_dtype}")
    if dev.type == "cpu":
        return gen_parity_ref(key, scale, ctrs, w, x, out_dtype=out_dtype)
    c32 = _as_u32(ctrs)
    check_cuda("gen_parity ctrs", c32, torch.int32, 1, dev)
    wx = coded_matvec(w, x.contiguous(), out_dtype=out_dtype)   # (L, C)
    out, n = _contract(key, scale, c32, None, wx, "gen_parity_matvec")
    GEN_LAUNCHES += n
    return out
