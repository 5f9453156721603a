"""Worker-assignment algorithms of the paper (§III-C, §IV-B).

* Algorithm 1 — iterated greedy (insertion / interchange / exploration) for
  the NP-hard max-min allocation problem P5.
* Algorithm 2 — simple greedy (largest-value-first to the poorest master).
* Algorithm 4 — fractional greedy: balance ``V_max`` vs ``V_min`` by moving
  (part of) a worker's computing power & bandwidth between masters.

Values are ``v_{m,n} = 1/(4 L_m θ_{m,n})`` (Markov mode, Thm 1) or
``v_{m,n} = u_{m,n} / (L_m (1 + u_{m,n} φ_{m,n}))`` (computation-dominant
mode, Thm 2); the sum ``V_m = Σ v`` is exactly ``1/t*_m``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

import numpy as np

from .allocation import (comp_dominant_loads, fractional_loads, markov_loads,
                         phi_comp_dominant)
from .problem import Plan, Scenario, theta_dedicated, theta_fractional

ValueMode = Literal["markov", "comp_exact"]

__all__ = [
    "value_matrix",
    "simple_greedy",
    "iterated_greedy",
    "fractional_greedy",
    "plan_from_assignment",
]


def value_matrix(sc: Scenario, mode: ValueMode = "markov") -> np.ndarray:
    """v_{m,n} for all (m, n) incl. the local column 0 (paper eq. (17))."""
    full = np.ones((sc.M, sc.N + 1))
    if mode == "markov":
        theta = theta_dedicated(sc, full)
        return 1.0 / (4.0 * sc.L[:, None] * theta)
    elif mode == "comp_exact":
        phi = phi_comp_dominant(sc.a, sc.u)
        return sc.u / (sc.L[:, None] * (1.0 + sc.u * phi))
    raise ValueError(f"unknown value mode {mode!r}")


def _assignment_to_k(sc: Scenario, owner: np.ndarray) -> np.ndarray:
    """owner: (N,) int array of the master owning each worker → k (M, N+1)."""
    k = np.zeros((sc.M, sc.N + 1))
    k[:, 0] = 1.0
    for n in range(sc.N):
        if owner[n] >= 0:
            k[owner[n], n + 1] = 1.0
    return k


# ---------------------------------------------------------------------------
# Algorithm 2 — simple greedy
# ---------------------------------------------------------------------------

def simple_greedy(sc: Scenario, mode: ValueMode = "markov") -> np.ndarray:
    """Largest-value-first assignment (paper Alg. 2).  Returns k (M, N+1)."""
    v = value_matrix(sc, mode)
    V = v[:, 0].copy()
    owner = np.full(sc.N, -1, dtype=int)
    remaining = list(range(1, sc.N + 1))
    while remaining:
        m_star = int(np.argmin(V))
        n_star = max(remaining, key=lambda n: v[m_star, n])
        V[m_star] += v[m_star, n_star]
        owner[n_star - 1] = m_star
        remaining.remove(n_star)
    return _assignment_to_k(sc, owner)


# ---------------------------------------------------------------------------
# Algorithm 1 — iterated greedy
# ---------------------------------------------------------------------------

def iterated_greedy(sc: Scenario, mode: ValueMode = "markov",
                    max_iters: int = 30, explore_frac: float = 0.3,
                    patience: int = 5,
                    rng: np.random.Generator | int = 0) -> np.ndarray:
    """Iterated greedy with insertion / interchange / exploration (Alg. 1).

    The reported assignment is the best post-interchange snapshot (the
    paper's "final output is the worker assignment after the interchange
    phase").
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    v = value_matrix(sc, mode)
    M, N = sc.M, sc.N
    if M == 1:                 # single master: every worker helps it
        return _assignment_to_k(sc, np.zeros(N, dtype=int))

    # --- initialization: each worker to the master valuing it most -------
    owner = np.argmax(v[:, 1:], axis=0).astype(int)      # (N,)
    V = v[:, 0].copy()
    for n in range(N):
        V[owner[n]] += v[owner[n], n + 1]

    def lex_better(V_new, V_old, tol=1e-15):
        """Lexicographic improvement of the sorted value vector.

        The paper's insertion accepts only strict global-min improvements;
        with symmetric masters (e.g. the EC2 scenario, where every master
        values a worker identically) several masters tie at the minimum and
        no single move can raise it — the literal rule deadlocks with all
        workers on one master.  Sorted-vector lexicographic acceptance is
        the standard max-min plateau fix and strictly generalizes the
        paper's condition."""
        a, b = np.sort(V_new), np.sort(V_old)
        for x, y in zip(a, b):
            if x > y + tol:
                return True
            if x < y - tol:
                return False
        return False

    best_owner, best_min = owner.copy(), float(np.min(V))
    stall = 0
    for _ in range(max_iters):
        # --- insertion phase ---------------------------------------------
        for n in range(N):
            m1 = owner[n]
            others = [m for m in range(M) if m != m1]
            m2 = min(others, key=lambda m: V[m])
            V_new = V.copy()
            V_new[m1] -= v[m1, n + 1]
            V_new[m2] += v[m2, n + 1]
            if lex_better(V_new, V):
                V = V_new
                owner[n] = m2

        # --- interchange phase -------------------------------------------
        for n1 in range(N):
            for n2 in range(n1 + 1, N):
                m1, m2 = owner[n1], owner[n2]
                if m1 == m2:
                    continue
                if v[m1, n1 + 1] + v[m2, n2 + 1] >= v[m1, n2 + 1] + v[m2, n1 + 1]:
                    continue
                Vmin = np.min(V)
                V1 = V[m1] - v[m1, n1 + 1] + v[m1, n2 + 1]
                V2 = V[m2] - v[m2, n2 + 1] + v[m2, n1 + 1]
                if V1 > Vmin and V2 > Vmin:
                    V[m1], V[m2] = V1, V2
                    owner[n1], owner[n2] = m2, m1

        # snapshot after interchange (the paper's reporting point)
        cur_min = float(np.min(V))
        if cur_min > best_min + 1e-15:
            best_min, best_owner = cur_min, owner.copy()
            stall = 0
        else:
            stall += 1
            if stall >= patience:
                break

        # --- exploration phase -------------------------------------------
        n_remove = max(1, int(round(explore_frac * N)))
        removed = rng.choice(N, size=n_remove, replace=False)
        for n in removed:
            V[owner[n]] -= v[owner[n], n + 1]
            owner[n] = -1
        pool = list(removed)
        while pool:
            # jointly pick (m*, n*) with max value among removed workers
            sub = v[:, [n + 1 for n in pool]]
            m_star, j = np.unravel_index(np.argmax(sub), sub.shape)
            n_star = pool[j]
            owner[n_star] = int(m_star)
            V[m_star] += v[m_star, n_star + 1]
            pool.remove(n_star)

    return _assignment_to_k(sc, best_owner)


# ---------------------------------------------------------------------------
# Plans from dedicated assignments
# ---------------------------------------------------------------------------

def plan_from_assignment(sc: Scenario, k: np.ndarray,
                         mode: ValueMode = "markov",
                         method: str = "") -> Plan:
    """Attach Thm-1 (or Thm-2) loads to a dedicated assignment."""
    if mode == "markov":
        theta = theta_dedicated(sc, k)
        l, t = markov_loads(sc.L, theta)
    else:
        part = k.copy()
        part[:, 0] = 1.0
        l, t = comp_dominant_loads(sc.L, sc.a, sc.u, part)
    return Plan(k=k, b=k.copy(), l=l, t_per_master=t, method=method or f"dedicated-{mode}")


# ---------------------------------------------------------------------------
# Algorithm 4 — fractional greedy
# ---------------------------------------------------------------------------

def fractional_greedy(sc: Scenario, init: Optional[np.ndarray] = None,
                      mode: ValueMode = "markov", max_iters: int = 500,
                      tol: float = 1e-7, loads: ValueMode = "markov",
                      rng: np.random.Generator | int = 0) -> Plan:
    """Fractional worker assignment by V_max / V_min balancing (Alg. 4).

    ``loads``: how to allocate loads on the final (k, b).  "markov" = Thm-3
    KKT loads; "comp_exact" = Thm-2 with the paper's effective-parameter
    substitution (û = k·u, â = a/k) — the right choice when computation
    delay dominates (§V-C)."""
    if init is None:
        init = iterated_greedy(sc, mode=mode, rng=rng)
    k = init.astype(np.float64).copy()
    b = k.copy()

    def V_of(k_, b_):
        theta = theta_fractional(sc, k_, b_)
        inv = np.where(np.isfinite(theta), 1.0 / theta, 0.0)
        return (0.25 * inv.sum(axis=1)) / sc.L, theta

    V, theta = V_of(k, b)
    for _ in range(max_iters):
        m1, m2 = int(np.argmax(V)), int(np.argmin(V))
        if V[m1] - V[m2] <= tol * max(V[m2], 1e-300):
            break
        cand = np.nonzero((k[m1, 1:] > 0) & (k[m2, 1:] == 0))[0] + 1
        if cand.size == 0:
            break
        # Potential θ'_{m2,n}: m2 gets *all* of n's current m1 resources.
        kk, bb = k[m1, cand], b[m1, cand]
        theta_p = (1.0 / (bb * sc.gamma[m2, cand])
                   + 1.0 / (kk * sc.u[m2, cand])
                   + sc.a[m2, cand] / kk)
        j = int(np.argmin(theta_p))
        n1 = int(cand[j])
        gain_full = 1.0 / (4.0 * theta_p[j] * sc.L[m2])
        loss_full = 1.0 / (4.0 * theta[m1, n1] * sc.L[m1])
        k_tot, b_tot = k[m1, n1], b[m1, n1]

        if V[m1] - loss_full <= V[m2] + gain_full:
            # Partial transfer: keep fraction f at m1, bisect V_m1(f)=V_m2(1-f).
            base1, base2 = V[m1] - loss_full, V[m2]

            def diff(f):
                th1 = (1.0 / (f * b_tot * sc.gamma[m1, n1])
                       + 1.0 / (f * k_tot * sc.u[m1, n1])
                       + sc.a[m1, n1] / (f * k_tot)) if f > 0 else np.inf
                g = 1.0 - f
                th2 = (1.0 / (g * b_tot * sc.gamma[m2, n1])
                       + 1.0 / (g * k_tot * sc.u[m2, n1])
                       + sc.a[m2, n1] / (g * k_tot)) if g > 0 else np.inf
                v1 = base1 + (1.0 / (4.0 * th1 * sc.L[m1]) if np.isfinite(th1) else 0.0)
                v2 = base2 + (1.0 / (4.0 * th2 * sc.L[m2]) if np.isfinite(th2) else 0.0)
                return v1 - v2

            lo, hi = 0.0, 1.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if diff(mid) > 0:
                    hi = mid
                else:
                    lo = mid
            f = 0.5 * (lo + hi)
            k[m1, n1], b[m1, n1] = f * k_tot, f * b_tot
            k[m2, n1], b[m2, n1] = (1 - f) * k_tot, (1 - f) * b_tot
        else:
            # Full transfer of worker n1's m1 share to m2.
            k[m2, n1], b[m2, n1] = k_tot, b_tot
            k[m1, n1], b[m1, n1] = 0.0, 0.0

        V, theta = V_of(k, b)

    if loads == "comp_exact":
        ksafe = np.maximum(k, 1e-12)
        a_eff = sc.a / ksafe
        u_eff = k * sc.u
        a_eff[:, 0], u_eff[:, 0] = sc.a[:, 0], sc.u[:, 0]
        part = (k > 0)
        part[:, 0] = True
        l, t = comp_dominant_loads(sc.L, a_eff, np.maximum(u_eff, 1e-12),
                                   part)
    else:
        theta = theta_fractional(sc, k, b)
        l, t = fractional_loads(sc.L, theta)
    return Plan(k=k, b=b, l=l, t_per_master=t,
                method=f"fractional-greedy-{loads}")
