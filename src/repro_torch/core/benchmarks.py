"""Benchmark policies from the paper's §V-B.

1. Uncoded computation with uniform worker assignment — each master gets
   ⌊N/M⌋ workers (contiguous blocks; remainder spread round-robin), A_m is
   split *evenly and without coding*, so the master must wait for **all** of
   its workers (no local compute, no redundancy).
2. Coded computation with uniform worker assignment — same worker split, but
   MDS-coded loads from Theorem 2 (the single-master scheme of [5], which
   ignores communication delay).
3. Near-optimal fractional benchmark — the paper brute-forces (k, b) on a
   0.01 grid for the 2×5 scenario.  A raw 0.01 grid over all 2·M·N fractions
   is ~1e10 points even there, so we implement the practical equivalent:
   multi-start coordinate ascent on the true max-min objective, sweeping each
   worker's (κ, β) split on the same 0.01 grid until a fixed point — followed
   by the same SCA load enhancement the paper applies.  On the small scenario
   this matches/beats Algorithm 4 everywhere we checked, which is the role
   the "optimal" curve plays in Fig. 4(a).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .allocation import comp_dominant_loads, fractional_loads, markov_loads
from .problem import Plan, Scenario, theta_dedicated, theta_fractional

__all__ = [
    "uniform_assignment",
    "uncoded_uniform",
    "coded_uniform",
    "near_optimal_fractional",
]


def uniform_assignment(sc: Scenario) -> np.ndarray:
    """Contiguous equal split of workers across masters → k (M, N+1)."""
    k = np.zeros((sc.M, sc.N + 1))
    k[:, 0] = 1.0
    owners = np.array([m % sc.M for m in range(sc.N)])
    owners = np.sort(owners)  # contiguous blocks, remainder round-robin
    for n, m in enumerate(owners):
        k[m, n + 1] = 1.0
    return k


def uncoded_uniform(sc: Scenario) -> Plan:
    """Benchmark 1: equal uncoded partition; needs *all* workers to finish.

    The predicted t_per_master is the expected max of the workers' delays
    (computed by the simulator; here we store the Markov point estimate of a
    single worker as a placeholder — empirical delay is what the paper
    plots)."""
    k = uniform_assignment(sc)
    l = np.zeros_like(k)
    for m in range(sc.M):
        w = np.nonzero(k[m, 1:] > 0)[0] + 1
        if w.size:
            l[m, w] = sc.L[m] / w.size
    theta = theta_dedicated(sc, k)
    # crude deterministic estimate: slowest worker's expected finish time;
    # a master with no workers at all (tiny pools) cannot finish uncoded.
    with np.errstate(invalid="ignore"):
        vals = np.where(l > 0, l * theta, -np.inf).max(axis=1)
    est = np.where((l > 0).any(axis=1), vals, np.inf)
    return Plan(k=k, b=k.copy(), l=l, t_per_master=est, method="uncoded-uniform")


def coded_uniform(sc: Scenario) -> Plan:
    """Benchmark 2: uniform assignment + Theorem-2 loads (scheme of [5])."""
    k = uniform_assignment(sc)
    part = k.copy()
    part[:, 0] = 1.0
    l, t = comp_dominant_loads(sc.L, sc.a, sc.u, part)
    return Plan(k=k, b=k.copy(), l=l, t_per_master=t, method="coded-uniform")


# ---------------------------------------------------------------------------
# Near-optimal fractional benchmark (paper's brute-force curve)
# ---------------------------------------------------------------------------

def _minV(sc: Scenario, k: np.ndarray, b: np.ndarray) -> float:
    theta = theta_fractional(sc, k, b)
    inv = np.where(np.isfinite(theta), 1.0 / theta, 0.0)
    V = 0.25 * inv.sum(axis=1) / sc.L
    return float(np.min(V))


def near_optimal_fractional(sc: Scenario, step: float = 0.01,
                            restarts: int = 8, max_sweeps: int = 50,
                            rng: np.random.Generator | int = 0) -> Plan:
    """Multi-start coordinate-ascent grid search on max-min V (paper's
    brute-force benchmark, small scenarios only)."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    if sc.M != 2:
        raise NotImplementedError("the paper's brute-force benchmark is M=2 only")
    grid = np.round(np.arange(0.0, 1.0 + step / 2, step), 10)

    best_kb: Optional[Tuple[np.ndarray, np.ndarray]] = None
    best_val = -np.inf
    for r in range(restarts):
        if r == 0:
            kappa = np.full(sc.N, 0.5)
            beta = np.full(sc.N, 0.5)
        else:
            kappa = rng.choice(grid, size=sc.N)
            beta = rng.choice(grid, size=sc.N)

        def kb_of(kpa, bta):
            k = np.zeros((2, sc.N + 1))
            b = np.zeros((2, sc.N + 1))
            k[:, 0] = b[:, 0] = 1.0
            k[0, 1:], k[1, 1:] = kpa, 1.0 - kpa
            b[0, 1:], b[1, 1:] = bta, 1.0 - bta
            return k, b

        cur = _minV(sc, *kb_of(kappa, beta))
        for _ in range(max_sweeps):
            improved = False
            for n in range(sc.N):
                # joint sweep of (κ_n, β_n) over the grid
                vals = np.empty((grid.size, grid.size))
                for i, kv in enumerate(grid):
                    kappa_n = kappa.copy(); kappa_n[n] = kv
                    for j, bv in enumerate(grid):
                        beta_n = beta.copy(); beta_n[n] = bv
                        vals[i, j] = _minV(sc, *kb_of(kappa_n, beta_n))
                i, j = np.unravel_index(np.argmax(vals), vals.shape)
                if vals[i, j] > cur + 1e-12:
                    kappa[n], beta[n] = grid[i], grid[j]
                    cur = vals[i, j]
                    improved = True
            if not improved:
                break
        if cur > best_val:
            best_val = cur
            best_kb = kb_of(kappa, beta)

    k, b = best_kb
    theta = theta_fractional(sc, k, b)
    l, t = fractional_loads(sc.L, theta)
    return Plan(k=k, b=b, l=l, t_per_master=t, method="bruteforce-fractional")
