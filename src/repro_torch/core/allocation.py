"""Load-allocation theorems of the paper (Thm 1, Thm 2, Thm 3).

* Theorem 1 — Markov's-inequality convex surrogate (problem P4), any delay
  distribution with known mean:  l* = L/(θ Σ 1/(2θ)),  t* = L/Σ 1/(4θ).
* Theorem 2 — exact optimum of P3 when computation delay dominates, via the
  lower branch of the Lambert-W function.
* Theorem 3 — fractional-assignment KKT condition  l* = t*/(2θ).

θ values come from ``repro.core.problem.theta_*``; entries with θ = inf are
non-participating nodes and receive zero load.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "lambertw_m1",
    "phi_comp_dominant",
    "markov_loads",
    "comp_dominant_loads",
    "fractional_loads",
]


# ---------------------------------------------------------------------------
# Lambert W, lower branch  W_{-1}: [-1/e, 0) -> (-inf, -1]
# ---------------------------------------------------------------------------

def lambertw_m1(y):
    """Lower branch of the Lambert-W function, vectorised.

    Solves w·e^w = y for y ∈ [-1/e, 0), returning w ≤ -1.  Uses the
    asymptotic seed w0 = ln(-y) - ln(-ln(-y)) followed by Halley iterations
    (quadratic-plus convergence; 6 iterations reach ~1e-15 everywhere on the
    branch, including the awkward region near -1/e where we seed with the
    square-root expansion instead).
    """
    y = np.asarray(y, dtype=np.float64)
    if np.any(y >= 0) or np.any(y < -np.exp(-1.0) * (1 + 1e-12)):
        raise ValueError("lambertw_m1 domain is [-1/e, 0)")
    y = np.minimum(y, -1e-300)

    # Seeds.  Near the branch point -1/e use the series w ≈ -1 - s - s²/3,
    # s = sqrt(2(1 + e·y)); elsewhere use the log-log asymptote.
    s = np.sqrt(np.maximum(2.0 * (1.0 + np.e * y), 0.0))
    w_branch = -1.0 - s - s * s / 3.0
    ly = np.log(-y)
    with np.errstate(invalid="ignore"):
        w_asym = ly - np.log(-ly)
    w = np.where(y > -0.25 / np.e, w_asym, w_branch)
    w = np.minimum(w, -1.0 - 1e-12)

    for _ in range(20):
        ew = np.exp(w)
        f = w * ew - y
        # Halley step.
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        step = f / np.where(np.abs(denom) < 1e-300, 1e-300, denom)
        w_new = w - step
        w_new = np.minimum(w_new, -1.0)       # stay on the lower branch
        if np.all(np.abs(w_new - w) <= 1e-14 * (1 + np.abs(w_new))):
            w = w_new
            break
        w = w_new
    return w


def phi_comp_dominant(a, u):
    """φ_{m,n} = [ -W_{-1}(-e^{-u·a-1}) - 1 ] / u  (paper Thm 2).

    φ is the optimal per-row deadline-to-load ratio t*/l* for a
    shifted-exponential server; a > 0 required (a = 0 degenerates to the
    memoryless case where φ solves (1+uφ)e^{-uφ}=1 → φ→0; we clamp a).
    """
    a = np.maximum(np.asarray(a, dtype=np.float64), 1e-9)
    u = np.asarray(u, dtype=np.float64)
    y = -np.exp(-u * a - 1.0)
    return (-lambertw_m1(y) - 1.0) / u


# ---------------------------------------------------------------------------
# Theorem 1 — Markov-approximation loads (problem P4)
# ---------------------------------------------------------------------------

def markov_loads(L, theta) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal loads/delay of the convex surrogate P4 (paper Thm 1).

    Parameters
    ----------
    L:      (M,) required useful rows per master.
    theta:  (M, N+1) expected unit delays; inf → node not participating.

    Returns ``(l, t)`` with ``l`` (M, N+1) and ``t`` (M,).
    Each participating node is expected to deliver exactly half its load by
    t* (the Markov bound is tight at 1/2), giving redundancy Σl = 2L.
    """
    L = np.asarray(L, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    inv = np.where(np.isfinite(theta), 1.0 / theta, 0.0)
    half = 0.5 * inv.sum(axis=-1)            # Σ 1/(2θ)
    quarter = 0.25 * inv.sum(axis=-1)        # Σ 1/(4θ)
    t = L / quarter
    l = (L / half)[..., None] * inv
    return l, t


# ---------------------------------------------------------------------------
# Theorem 2 — exact loads when computation delay dominates (problem P3(1))
# ---------------------------------------------------------------------------

def comp_dominant_loads(L, a, u, participate) -> Tuple[np.ndarray, np.ndarray]:
    """Exact optimum of P3 with T = T_cp only (paper Thm 2).

    l* = L/(φ Σ' u/(1+uφ)),  t* = L/Σ' u/(1+uφ)  over participating nodes.
    """
    L = np.asarray(L, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    part = np.asarray(participate) > 0
    phi = phi_comp_dominant(a, u)
    w = np.where(part, u / (1.0 + u * phi), 0.0)   # per-node effective rate
    denom = w.sum(axis=-1)
    t = L / denom
    l = t[..., None] / phi * (part.astype(np.float64))
    # zero the non-participants exactly
    l = np.where(part, l, 0.0)
    return l, t


# ---------------------------------------------------------------------------
# Theorem 3 — fractional KKT loads
# ---------------------------------------------------------------------------

def fractional_loads(L, theta) -> Tuple[np.ndarray, np.ndarray]:
    """Loads satisfying the fractional KKT condition l* = t*/(2θ) (Thm 3).

    Identical in form to Theorem 1 — the KKT condition pins l θ / t = 1/2 —
    but θ here is the *fractional* θ_{m,n}(k, b) of eq. (24).
    """
    return markov_loads(L, theta)
