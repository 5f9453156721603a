"""Real-valued MDS coding for distributed matrix multiplication (paper §II).

The paper encodes A_m row-wise with an (L̃, L) MDS code; the master recovers
A_m x_m from the inner products of **any** L coded rows.  Over the reals a
random Gaussian generator is MDS with probability 1; we default to the
*systematic* variant [I; R] so the fast path (no stragglers) is decode-free.

Shapes:  A (L, S),  G (L̃, L),  Ã = G A (L̃, S),  y = Ã x (L̃,),
recover A x from any L entries of y via the corresponding rows of G.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "make_generator",
    "encode",
    "split_loads",
    "decode",
    "decode_ls",
    "integer_loads",
    "parity_cond",
    "PARITY_COND_LIMIT",
    "threefry2x32",
    "parity_counters",
    "counter_gaussian_tile",
    "counter_parity_rows",
    "PARITY_ROW_LIMIT",
    "PARITY_DRAW_LIMIT",
]

#: Redraw threshold for :func:`parity_cond`.  A fresh N(0, 1/L) parity
#: block has singular values in ≈ [1−√(r/L), 1+√(r/L)] w.h.p.
#: (Marchenko–Pastur), so its 2-norm condition sits in the tens; per-scope
#: serving measures decode error ≈ cond · ε_machine per solve (the trunk
#: scope's 2.6e-11 vs the head's 1.2e-12 in BENCH_serve.json is exactly
#: this: many small mixed-row solves whose random square sub-blocks have a
#: fatter conditioning tail than the head's near-complete prefixes).  1e6
#: keeps worst-case decode error ≲ 1e-10 ≪ the 1e-9 per-scope bound the
#: tests assert, while firing only on genuinely degenerate draws.
PARITY_COND_LIMIT = 1e6


def parity_cond(R: np.ndarray) -> float:
    """2-norm condition diagnostic of a parity-generator block.

    ``R`` is an (r, L) block of parity rows (any slice of the generator
    below the identity prefix).  Mixed-row substitution decodes solve
    square minors of ``R``; their conditioning is not cheaply boundable
    minor-by-minor, but a collapsed spectrum of the block itself is the
    necessary symptom of every degenerate minor, so σ_max/σ_min of the
    block is the cheap guard: ``CodedLinear`` redraws any parity chunk
    whose diagnostic exceeds :data:`PARITY_COND_LIMIT` before encoding it.
    Returns +inf for a rank-deficient block.
    """
    R = np.asarray(R, dtype=np.float64)
    if R.size == 0:
        return 1.0
    s = np.linalg.svd(R, compute_uv=False)
    if s[-1] <= 0.0:
        return float("inf")
    return float(s[0] / s[-1])


# ---------------------------------------------------------------------------
# Counter-based parity derivation (virtual parity rows)
# ---------------------------------------------------------------------------

#: parity row index must fit in the low 24 bits of the threefry counter
#: (the high 8 bits carry the conditioning-guard redraw index)
PARITY_ROW_LIMIT = 1 << 24
#: conditioning-guard redraws per block fit in the counter's high byte
PARITY_DRAW_LIMIT = 1 << 8

_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TF_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, c0, c1):
    """20-round Threefry-2x32 block cipher over uint32 counters.

    ``k0``/``k1`` are uint32 key words, ``c0``/``c1`` broadcastable uint32
    counter arrays.  Returns the two output words.  Written against the
    operator set numpy and jax.numpy share, so the *same* code runs on the
    host (parity replay, decode plans) and inside the Pallas generated-
    parity kernels — bit-equality between the two paths is by construction,
    not by test luck.  All arithmetic wraps mod 2^32 (uint32 dtype).
    """
    u32 = np.uint32          # numpy scalar: both backends absorb it
    x0 = c0 + k0
    x1 = c1 + k1
    ks2 = k0 ^ k1 ^ u32(_TF_PARITY)
    sched = (k1, ks2, k0)      # injected after rounds 4, 8, 12, 16, 20
    for d in range(5):
        for r in _TF_ROT[d % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + sched[d % 3]
        x1 = x1 + sched[(d + 1) % 3] + u32(d + 1)
    return x0, x1


def parity_counters(row_ids, draws) -> np.ndarray:
    """Pack absolute parity-row ids + redraw indices into uint32 counters.

    ``row_ids`` (n,) int parity-row indices (0-based within the parity
    region, < 2^24); ``draws`` scalar or (n,) conditioning-guard redraw
    index per row (< 256, the high counter byte).  The packed counter is
    the *only* state a parity row needs — a frozen plan carries these
    through packed stages instead of encoded-row indices.
    """
    row_ids = np.asarray(row_ids, dtype=np.int64)
    draws = np.broadcast_to(np.asarray(draws, dtype=np.int64), row_ids.shape)
    if row_ids.size and (row_ids.min() < 0
                         or row_ids.max() >= PARITY_ROW_LIMIT):
        raise ValueError(f"parity row ids must be in [0, {PARITY_ROW_LIMIT})")
    if draws.size and (draws.min() < 0 or draws.max() >= PARITY_DRAW_LIMIT):
        raise ValueError(f"parity redraw index must be < {PARITY_DRAW_LIMIT}")
    return (row_ids | (draws << 24)).astype(np.uint32)


def _uniform24(bits):
    """uint32 → float32 uniform in [0, 1) from the top 24 bits (exact)."""
    return (bits >> np.uint32(8)).astype("float32") * np.float32(2.0 ** -24)


def counter_gaussian_tile(k0, k1, ctrs, cols, scale):
    """One tile of counter-derived parity values — numpy *and* jnp.

    ``ctrs`` (r, 1) packed row counters (:func:`parity_counters`), ``cols``
    (1, c) uint32 column indices, ``scale`` = float32(sqrt(3/L)).  Each
    value draws four 24-bit uniforms through two threefry calls and maps
    them to a zero-mean Gaussian approximant (Irwin–Hall order 4, variance
    1/3 before scaling) — a continuous iid entry distribution, so the MDS
    any-L-rows property holds with probability 1 exactly as for the
    Gaussian draw it replaces, while every arithmetic step (integer ops,
    exact 24-bit-to-float32 conversion, fixed-order float32 adds) is
    bit-reproducible across numpy and the XLA/Pallas backends.
    """
    two = np.uint32(2)
    one = np.uint32(1)
    a0, a1 = threefry2x32(k0, k1, ctrs, cols * two)
    b0, b1 = threefry2x32(k0, k1, ctrs, cols * two + one)
    u = _uniform24
    g = (u(a0) + u(a1)) + (u(b0) + u(b1)) - np.float32(2.0)
    return g * scale


def counter_parity_rows(key, ctrs, L: int, *,
                        dtype=np.float64) -> np.ndarray:
    """Parity generator rows R[ctrs] derived from counters alone (host).

    ``key`` is the per-layer (k0, k1) uint32 pair, ``ctrs`` (n,) packed
    row counters, ``L`` the row width.  Row r is a pure function of
    (key, counter) — independent of any growth history or draw order,
    which is the replay contract virtual parity storage rests on.  Values
    are float32-exact (the kernel twin generates identical bits) returned
    in ``dtype`` for the float64 host decode path.
    """
    k0 = np.uint32(key[0])
    k1 = np.uint32(key[1])
    ctrs = np.asarray(ctrs, dtype=np.uint32)[:, None]
    cols = np.arange(L, dtype=np.uint32)[None, :]
    scale = np.float32(np.sqrt(3.0 / L))
    return counter_gaussian_tile(k0, k1, ctrs, cols, scale).astype(dtype)


def make_generator(L: int, L_tilde: int, *, kind: str = "systematic",
                   rng: np.random.Generator | int = 0,
                   dtype=np.float32) -> np.ndarray:
    """Build an (L̃, L) real MDS generator matrix.

    kind="systematic": G = [I; R], R ~ N(0, 1/L) — decode-free when the first
    L rows arrive.  kind="gaussian": fully random (used by property tests).
    """
    if L_tilde < L:
        raise ValueError("L_tilde must be >= L")
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    if kind == "systematic":
        R = rng.normal(0.0, 1.0 / np.sqrt(L), size=(L_tilde - L, L))
        G = np.concatenate([np.eye(L), R], axis=0)
    elif kind == "gaussian":
        G = rng.normal(0.0, 1.0 / np.sqrt(L), size=(L_tilde, L))
    else:
        raise ValueError(f"unknown generator kind {kind!r}")
    return G.astype(dtype)


def encode(G: np.ndarray, A: np.ndarray) -> np.ndarray:
    """Ã = G A  (row-wise MDS encoding)."""
    return G @ A


def integer_loads(l: np.ndarray, L: float) -> np.ndarray:
    """Round real loads to integers, preserving Σl ≥ ceil(required).

    The paper drops integrality (7c); real deployments need integers.  We
    ceil every positive load — the redundancy only grows, recovery is safe.
    """
    l = np.asarray(l, dtype=np.float64)
    return np.where(l > 0, np.ceil(l - 1e-9), 0.0).astype(np.int64)


def split_loads(L_tilde: int, loads: Sequence[int]) -> Tuple[np.ndarray, ...]:
    """Partition row indices 0..L̃-1 into per-node contiguous slices."""
    loads = np.asarray(loads, dtype=np.int64)
    if loads.sum() != L_tilde:
        raise ValueError("loads must sum to L_tilde")
    edges = np.concatenate([[0], np.cumsum(loads)])
    return tuple(np.arange(edges[i], edges[i + 1]) for i in range(len(loads)))


def decode(G: np.ndarray, rows: np.ndarray, y_rows: np.ndarray) -> np.ndarray:
    """Recover A x (or A B) from exactly-L received coded results.

    ``rows`` are the indices of the received coded rows (len == L),
    ``y_rows`` the received results, shape (L,) or (L, C).
    """
    L = G.shape[1]
    rows = np.asarray(rows)
    if rows.size != L:
        raise ValueError(f"decode needs exactly L={L} rows, got {rows.size}")
    Gs = G[rows].astype(np.float64)
    return np.linalg.solve(Gs, np.asarray(y_rows, dtype=np.float64))


def decode_ls(G: np.ndarray, rows: np.ndarray, y_rows: np.ndarray) -> np.ndarray:
    """Least-squares decode from ≥ L received rows (overdetermined: averages
    out numerical noise; the robust path for float32 pipelines)."""
    L = G.shape[1]
    rows = np.asarray(rows)
    if rows.size < L:
        raise ValueError(f"need >= L={L} rows, got {rows.size}")
    Gs = G[rows].astype(np.float64)
    sol, *_ = np.linalg.lstsq(Gs, np.asarray(y_rows, dtype=np.float64), rcond=None)
    return sol
