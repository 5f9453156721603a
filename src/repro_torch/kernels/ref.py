"""Plain-PyTorch versions of every kernel on the coded-serving path.

The CPU tests run these (a wrapper takes them only for CPU tensors) and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  They
repeat the kernels' arithmetic and are no yardstick of speed.

The counter-derived parity rows need uint32 wrap-around, which torch's
integer ops do not offer on every device: the threefry rounds run in int64
and mask to 32 bits after every add and rotate, which is the same modular
arithmetic, so the rows are bit-identical to
:func:`repro_torch.core.mds.counter_parity_rows`.
"""
from __future__ import annotations

import torch

__all__ = ["matmul_ref", "coded_matvec_ref", "threefry2x32_ref",
           "counter_parity_rows_ref", "gen_parity_ref"]

_M32 = 0xFFFFFFFF
_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TF_PARITY = 0x1BD11BDA
#: entries per chunk of the plain counter derivation (bounds the int64
#: temporaries at ~128 MB each)
_CHUNK = 1 << 24


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation, in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def coded_matvec_ref(a_tilde: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = Ã @ x for x of shape (S,) or (S, B)."""
    return torch.matmul(a_tilde.float(), x.float()).to(x.dtype)


def threefry2x32_ref(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """20-round threefry2x32 on int64 tensors holding uint32 values."""
    ks2 = (k0 ^ k1 ^ _TF_PARITY) & _M32
    sched = (k1, ks2, k0)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for d in range(5):
        for r in _TF_ROT[d % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + sched[d % 3]) & _M32
        x1 = (x1 + sched[(d + 1) % 3] + d + 1) & _M32
    return x0, x1


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def counter_parity_rows_ref(key, scale: float, ctrs: torch.Tensor,
                            cols: torch.Tensor) -> torch.Tensor:
    """R[ctrs][:, cols] float32 — ``ctrs`` (n,) and ``cols`` (m,) integer
    tensors holding uint32 values; ``scale`` the float32 ``sqrt(3/L)``."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ctrs = ctrs.to(torch.int64)
    cols = cols.to(torch.int64)
    n, m = ctrs.numel(), cols.numel()
    out = torch.empty((n, m), dtype=torch.float32, device=ctrs.device)
    step = max(1, _CHUNK // max(m, 1))
    c1a = (cols * 2) & _M32
    c1b = (c1a + 1) & _M32
    for i in range(0, n, step):
        c0 = ctrs[i:i + step, None]
        a0, a1 = threefry2x32_ref(k0, k1, c0, c1a[None, :])
        b0, b1 = threefry2x32_ref(k0, k1, c0, c1b[None, :])
        g = (_uniform24(a0) + _uniform24(a1)) \
            + (_uniform24(b0) + _uniform24(b1)) - 2.0
        out[i:i + step] = g * scale
    return out


def gen_parity_ref(key, scale: float, ctrs: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Generated-parity products ``R_gen[ctrs] @ (W @ x)`` (n, C) float32,
    with R derived row-chunk by row-chunk (never all of it at once)."""
    L = w.shape[0]
    wx = torch.matmul(w.float(), x.float())
    cols = torch.arange(L, device=w.device)
    n = ctrs.numel()
    out = torch.empty((n, x.shape[1]), dtype=torch.float32, device=w.device)
    step = max(1, _CHUNK // max(L, 1))
    for i in range(0, n, step):
        r = counter_parity_rows_ref(key, scale, ctrs[i:i + step], cols)
        out[i:i + step] = r @ wx
    return out
