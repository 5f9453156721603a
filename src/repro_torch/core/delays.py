"""Delay distributions of the paper (§II-B, eqs. (1)-(5)).

Communication delay of shipping ``l`` coded rows from master m to worker n
with bandwidth fraction ``b``:      T_tr ~ Exp(rate = b·γ / l).
Computation delay of ``l`` coded rows with computing-power fraction ``k``:
    T_cp ~ a·l/k + Exp(rate = k·u / l)    (shifted exponential).

All CDFs and expectations below are closed-form and vectorised; they are the
oracles the Monte-Carlo simulator and the optimization layers are tested
against.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "cdf_comm", "cdf_comp", "cdf_total", "cdf_local",
    "expected_total", "expected_received", "sample_total",
]

_EPS = 1e-12


def cdf_comm(t, l, b, gamma):
    """Eq. (1): P[T_tr <= t] for shipping l coded rows at bandwidth b·γ."""
    t, l = np.asarray(t, dtype=np.float64), np.asarray(l, dtype=np.float64)
    rate = np.where(l > 0, b * gamma / np.maximum(l, _EPS), np.inf)
    return np.where(t >= 0, 1.0 - np.exp(-rate * np.maximum(t, 0.0)), 0.0)


def cdf_comp(t, l, k, a, u):
    """Eq. (2): P[T_cp <= t], shifted exponential with shift a·l/k."""
    t, l = np.asarray(t, dtype=np.float64), np.asarray(l, dtype=np.float64)
    shift = a * l / np.maximum(k, _EPS)
    rate = k * u / np.maximum(l, _EPS)
    z = np.maximum(t - shift, 0.0)
    out = 1.0 - np.exp(-rate * z)
    return np.where((t >= shift) & (l > 0), out, np.where(l > 0, 0.0, 1.0))


def cdf_total(t, l, k, b, a, u, gamma):
    """Eqs. (3)/(4): CDF of T = T_tr + T_cp for a worker node.

    Handles the resonant case b·γ == k·u via eq. (4); fully vectorised.
    Zero-load entries return CDF 1 (an empty shipment completes at t=0).
    """
    t = np.asarray(t, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    lpos = l > 0
    lsafe = np.maximum(l, _EPS)
    ksafe = np.maximum(k, _EPS)
    cu = k * u          # computation rate numerator
    cg = b * gamma      # communication rate numerator
    shift = a * l / ksafe
    z = np.maximum(t - shift, 0.0)           # time past the deterministic shift
    ru = cu / lsafe     # computation exp rate
    rg = cg / lsafe     # communication exp rate
    same = np.isclose(cg, cu, rtol=1e-9, atol=1e-15)
    denom = np.where(same, 1.0, cg - cu)
    # Eq. (3): 1 - [bγ e^{-ru z} - ku e^{-rg z}] / (bγ - ku)
    general = 1.0 - (cg * np.exp(-ru * z) - cu * np.exp(-rg * z)) / denom
    # Eq. (4): 1 - (1 + ru z) e^{-ru z}
    resonant = 1.0 - (1.0 + ru * z) * np.exp(-ru * z)
    out = np.where(same, resonant, general)
    out = np.where(t >= shift, out, 0.0)
    return np.where(lpos, out, 1.0)


def cdf_local(t, l, a0, u0):
    """Eq. (5): local computation at the master (no communication)."""
    return cdf_comp(t, l, 1.0, a0, u0)


def expected_total(l, k, b, a, u, gamma):
    """E[T] = l·(1/(bγ) + 1/(ku) + a/k) — the Markov-inequality numerator (9)/(23)."""
    l = np.asarray(l, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = 1.0 / (b * gamma) + 1.0 / (k * u) + a / np.maximum(k, _EPS)
    return l * theta


def expected_received(t, l, k, b, a, u, gamma):
    """E[X_m(t)] = Σ_n l_n · P[T_n <= t]  (paper eq. below (7)).

    Inputs are (M, N+1) arrays with column 0 = the master's local node
    (no communication, eq. (5)).
    """
    l = np.asarray(l, dtype=np.float64)
    p = np.empty_like(l)
    p[:, 0] = cdf_local(t, l[:, 0], a[:, 0], u[:, 0])
    p[:, 1:] = cdf_total(t, l[:, 1:], k[:, 1:], b[:, 1:],
                         a[:, 1:], u[:, 1:], gamma[:, 1:])
    return (l * p).sum(axis=-1)


def sample_total(rng: np.random.Generator, shape, l, k, b, a, u, gamma,
                 *, local_col0: bool = True):
    """Sample T = T_tr + T_cp.  ``shape`` prepends realization axes.

    With ``local_col0`` (the default for (M, N+1) plan arrays), column 0 is
    the master's local processor: its communication delay is identically 0.
    Zero-load nodes return 0 delay (they contribute nothing anyway).
    """
    l = np.asarray(l, dtype=np.float64)
    lsafe = np.maximum(l, _EPS)
    ksafe = np.maximum(k, _EPS)
    bsafe = np.maximum(b, _EPS)
    t_tr = rng.exponential(1.0, size=shape + l.shape) * lsafe / (bsafe * gamma)
    if local_col0:
        t_tr[..., 0] = 0.0
    t_cp = (a * l / ksafe
            + rng.exponential(1.0, size=shape + l.shape) * lsafe / (ksafe * u))
    total = t_tr + t_cp
    return np.where(l > 0, total, 0.0)
