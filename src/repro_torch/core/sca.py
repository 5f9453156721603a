"""SCA-enhanced load allocation (paper §III-D, Algorithm 3).

The non-convex recovery constraint of P3,

    L_m - E[X_m(t)] <= 0,
    E[X_m(t)] = Σ_n l_n · P[T_n <= t],

has a difference-of-convex structure (paper eq. (20)):

    L_m - E[X_m] = L_m - Σ_{n∈Ω} l_n + h0(l_0,t) + Σ_{n∈Ω} (h+_n - h-_n),

with, for p = max(γ̂, û), q = min(γ̂, û), d = p - q and effective rates
γ̂ = b·γ, û = k·u, â = a/k (dedicated: k = b = 1):

    h+_n(l,t) = p·l·e^{-q(t/l - â)} / d      (convex)
    h-_n(l,t) = q·l·e^{-p(t/l - â)} / d      (convex)
    h0(l,t)   = -l·(1 - e^{-u0(t/l - a0)})   (convex; paper Appendix B)

Linearizing h- at the current point z gives the convex restriction P(z)
(eq. (22)); Algorithm 3 iterates  z ← z + γ_r (w* - z),
γ_{r+1} = γ_r(1 - α γ_r), from the Theorem-1 feasible point.

P(z) is solved exactly by bisection on t; for fixed t the constraint
residual is *separable* in the per-node loads, and each 1-D convex piece is
minimized by golden-section search.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from . import delays
from .allocation import markov_loads
from .problem import Plan, Scenario, theta_dedicated, theta_fractional

__all__ = ["sca_enhance_master", "sca_enhance_plan", "feasible_deadline",
           "kkt_residual"]

_GOLD = 0.5 * (3.0 - np.sqrt(5.0))  # 0.381966...


@dataclasses.dataclass
class _MasterInst:
    """Effective single-master instance: local node + participating workers."""
    L: float
    a0: float
    u0: float
    a_hat: np.ndarray    # (W,) effective shifts of the workers
    p: np.ndarray        # (W,) max(γ̂, û)
    q: np.ndarray        # (W,) min(γ̂, û)

    @property
    def d(self) -> np.ndarray:
        return self.p - self.q


def _build_instance(sc: Scenario, m: int, k: np.ndarray, b: np.ndarray,
                    workers: np.ndarray) -> _MasterInst:
    g_hat = b[m, workers] * sc.gamma[m, workers]
    u_hat = k[m, workers] * sc.u[m, workers]
    a_hat = sc.a[m, workers] / k[m, workers]
    # Perturb the resonant case γ̂ == û (paper handles it by eq. (4); an
    # ε-perturbation keeps the DC decomposition well-defined).
    same = np.isclose(g_hat, u_hat, rtol=1e-9)
    g_hat = np.where(same, g_hat * (1.0 + 1e-6), g_hat)
    return _MasterInst(
        L=float(sc.L[m]), a0=float(sc.a[m, 0]), u0=float(sc.u[m, 0]),
        a_hat=a_hat, p=np.maximum(g_hat, u_hat), q=np.minimum(g_hat, u_hat))


# -- convex pieces and gradients -------------------------------------------

def _h_plus(inst: _MasterInst, l, t):
    l = np.maximum(l, 1e-300)
    return inst.p * l * np.exp(-inst.q * (t / l - inst.a_hat)) / inst.d


def _h_minus(inst: _MasterInst, l, t):
    l = np.maximum(l, 1e-300)
    return inst.q * l * np.exp(-inst.p * (t / l - inst.a_hat)) / inst.d


def _h_minus_grad(inst: _MasterInst, l, t) -> Tuple[np.ndarray, np.ndarray]:
    """(∂h-/∂l, ∂h-/∂t) at (l, t), elementwise over workers."""
    l = np.maximum(l, 1e-300)
    e = np.exp(-inst.p * (t / l - inst.a_hat))
    gl = inst.q / inst.d * e * (1.0 + inst.p * t / l)
    gt = -inst.q * inst.p / inst.d * e
    return gl, gt


def _h0(inst: _MasterInst, l0, t):
    l0 = np.maximum(l0, 1e-300)
    return -l0 * (1.0 - np.exp(-inst.u0 * (t / l0 - inst.a0)))


def _true_EX(inst: _MasterInst, l0, l, t):
    """Exact E[X_m(t)] for the instance (oracle for feasibility checks)."""
    return (-_h0(inst, l0, t)
            + np.sum(l - (_h_plus(inst, l, t) - _h_minus(inst, l, t))))


# -- P(z) subproblem ---------------------------------------------------------

def _golden_min(f, lo: np.ndarray, hi: np.ndarray, iters: int = 52):
    """Vectorised golden-section minimization of elementwise-convex f."""
    lo = lo.astype(np.float64).copy()
    hi = hi.astype(np.float64).copy()
    x1 = lo + _GOLD * (hi - lo)
    x2 = hi - _GOLD * (hi - lo)
    f1, f2 = f(x1), f(x2)
    for _ in range(iters):
        take_left = f1 < f2
        hi = np.where(take_left, x2, hi)
        lo = np.where(take_left, lo, x1)
        x1n = lo + _GOLD * (hi - lo)
        x2n = hi - _GOLD * (hi - lo)
        # recompute both (cheap, keeps the vectorised logic branch-free)
        x1, x2 = x1n, x2n
        f1, f2 = f(x1), f(x2)
    x = 0.5 * (lo + hi)
    return x, f(x)


def _solve_subproblem(inst: _MasterInst, z_l0: float, z_l: np.ndarray,
                      z_t: float, *, bisect_iters: int = 44,
                      l_cap_scale: float = 8.0):
    """Solve P(z): min t s.t. the linearized constraint holds, l >= 0.

    Returns (l0, l, t).  Assumes (z_l0, z_l, z_t) is P3-feasible, hence
    P(z)-feasible (the linearization is exact at z).
    """
    gl, gt = _h_minus_grad(inst, z_l, z_t)
    # Constant of the linearization: -Σ[h-(z) - gl·z_l] - (Σ gt)·(t - z_t)
    c_lin = np.sum(_h_minus(inst, z_l, z_t) - gl * z_l)
    gts = np.sum(gt)
    l_cap = l_cap_scale * inst.L

    def min_residual(t: float):
        """min over l >= 0 of the constraint residual G(l, t)."""
        # local node: minimize h0(l0, t)
        l0, h0v = _golden_min(lambda x: _h0(inst, x, t),
                              np.array([0.0]), np.array([l_cap]))
        # worker nodes: minimize h+(l,t) - (1 + gl)·l
        def psi(l):
            return _h_plus(inst, l, t) - (1.0 + gl) * l
        lw, psiv = _golden_min(psi, np.zeros_like(inst.p),
                               np.full_like(inst.p, l_cap))
        resid = (inst.L + h0v[0] + np.sum(psiv)
                 - c_lin - gts * (t - z_t))
        return resid, float(l0[0]), lw

    # Bisection on t over [0, z_t]; predicate = feasible (residual <= 0).
    t_hi = z_t
    r_hi, l0_hi, lw_hi = min_residual(t_hi)
    if r_hi > 1e-9 * inst.L:
        # z not recognized feasible under numerics; return z unchanged.
        return z_l0, z_l.copy(), z_t
    t_lo = 0.0
    best = (l0_hi, lw_hi, t_hi)
    for _ in range(bisect_iters):
        t_mid = 0.5 * (t_lo + t_hi)
        r, l0m, lwm = min_residual(t_mid)
        if r <= 0.0:
            t_hi = t_mid
            best = (l0m, lwm, t_mid)
        else:
            t_lo = t_mid
    return best[0], best[1], best[2]


# -- Algorithm 3 -------------------------------------------------------------

def sca_enhance_master(sc: Scenario, m: int, k: np.ndarray, b: np.ndarray,
                       l_init: np.ndarray, t_init: float, *,
                       alpha: float = 0.995, gamma0: float = 1.0,
                       max_iters: int = 12, rtol: float = 1e-7,
                       ) -> Tuple[np.ndarray, float]:
    """Run Algorithm 3 for one master.  Returns (l_row, t) with l_row of
    length N+1 (column 0 local)."""
    workers = np.nonzero(l_init[1:] > 0)[0] + 1
    if workers.size == 0:
        return l_init.copy(), t_init
    inst = _build_instance(sc, m, k, b, workers)

    z_l0 = float(l_init[0])
    z_l = l_init[workers].astype(np.float64).copy()
    z_t = float(t_init)

    gam = gamma0
    for _ in range(max_iters):
        w_l0, w_l, w_t = _solve_subproblem(inst, z_l0, z_l, z_t)
        new_l0 = z_l0 + gam * (w_l0 - z_l0)
        new_l = z_l + gam * (w_l - z_l)
        new_t = z_t + gam * (w_t - z_t)
        moved = abs(new_t - z_t) > rtol * max(z_t, 1e-300)
        z_l0, z_l, z_t = new_l0, new_l, new_t
        gam = gam * (1.0 - alpha * gam)
        gam = max(gam, 1e-4)
        if not moved:
            break

    # Tighten t to the exact feasibility boundary at the final loads.
    lo, hi = 0.0, z_t * 2.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _true_EX(inst, z_l0, z_l, mid) >= inst.L:
            hi = mid
        else:
            lo = mid
    z_t = hi

    out = np.zeros_like(l_init)
    out[0] = z_l0
    out[workers] = z_l
    return out, float(z_t)


def feasible_deadline(sc: Scenario, m: int, k: np.ndarray, b: np.ndarray,
                      l_row: np.ndarray, *, t_hi: Optional[float] = None,
                      iters: int = 60) -> float:
    """Smallest t with E[X_m(t)] >= L_m at *fixed* loads (exact CDFs).

    The online replanner warm-starts Algorithm 3 from the previous plan's
    loads; Algorithm 3 requires a feasible (l, t) pair, so this bisection
    recovers the matching deadline.  Returns inf when Σl < L_m (the loads
    can never recover L_m useful rows)."""
    l_row = np.asarray(l_row, dtype=np.float64)
    if l_row.sum() < float(sc.L[m]) - 1e-9:
        return np.inf

    def ex(t: float) -> float:
        return float(delays.expected_received(
            t, l_row[None, :], k[m][None, :], b[m][None, :],
            sc.a[m][None, :], sc.u[m][None, :], sc.gamma[m][None, :])[0])

    if t_hi is None:
        t_hi = 1.0
        for _ in range(200):
            if ex(t_hi) >= sc.L[m]:
                break
            t_hi *= 2.0
        else:
            return np.inf
    lo, hi = 0.0, float(t_hi)
    if ex(hi) < sc.L[m]:
        return np.inf
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if ex(mid) >= sc.L[m]:
            hi = mid
        else:
            lo = mid
    return hi


def kkt_residual(sc: Scenario, k: np.ndarray, b: np.ndarray,
                 l: np.ndarray, t: np.ndarray) -> float:
    """First-order (KKT) optimality residual of a fractional plan.

    Two stationarity systems govern the planning stack, and the residual is
    the larger normalised violation of the two:

    * **loads** (P3/P4, Theorems 1 & 3): at fixed shares the Markov-bound
      optimum has ``2 l_n θ_n = t`` on every active node and meets the
      recovery bound ``Σ_n l_n (1 - l_n θ_n / t) = L`` with equality.
    * **shares** (P4', Algorithm 4): no fractional transfer of a worker's
      shares to the minimum-value master can improve ``min_m V_m`` — the
      fractional-greedy stopping rule.  The residual term is the best
      achievable normalised improvement from a single full transfer,
      capped by the value headroom of the donating master (transferring
      more than half the V gap would overshoot the min).

    A freshly solved plan scores near zero on both.  The incremental
    repairer (``stream.replan.OnlinePlanner``) records this residual at
    every full solve and falls back to a full re-solve whenever a repaired
    plan's residual exceeds that baseline by ``ReplanPolicy.repair_tol`` —
    an *anchored* criterion: successive repairs may drift, but only until
    the accumulated first-order error crosses the tolerance.

    Vectorised O(M·N); never calls the exact-CDF oracle.
    """
    th = theta_fractional(sc, k, b)
    l = np.asarray(l, dtype=np.float64)
    tt = np.maximum(np.asarray(t, dtype=np.float64), 1e-300)[:, None]
    fin = np.isfinite(th)
    th0 = np.where(fin, th, 0.0)
    active = (l > 0) & fin

    # Load-level stationarity: |2 l θ / t - 1| on active nodes.
    stat = np.where(active, np.abs(2.0 * l * th0 / tt - 1.0), 0.0)
    r_load = float(stat.max()) if stat.size else 0.0

    # Recovery-bound tightness (Markov form): Σ l (1 - lθ/t) = L.
    recv = (l * np.maximum(1.0 - l * th0 / tt, 0.0) * fin).sum(axis=1)
    r_cover = float(np.max(np.abs(recv - sc.L) / np.maximum(sc.L, 1e-300)))

    # Share-level stationarity: best single-transfer gain toward min-V.
    r_share = 0.0
    W = th.shape[1]
    if sc.M >= 2 and W > 1:
        inv = np.where(fin, 1.0 / np.where(fin, th, 1.0), 0.0)
        V = 0.25 * inv.sum(axis=1) / np.maximum(sc.L, 1e-300)
        m2 = int(np.argmin(V))
        kk, bb = k[:, 1:], b[:, 1:]
        held = (kk > 0) & (bb > 0)
        th_p = np.where(
            held,
            1.0 / np.where(held, bb * sc.gamma[m2, 1:][None, :], 1.0)
            + 1.0 / np.where(held, kk * sc.u[m2, 1:][None, :], 1.0)
            + sc.a[m2, 1:][None, :] / np.where(held, kk, 1.0),
            np.inf)
        gain = 0.25 / (th_p * np.maximum(sc.L[m2], 1e-300))  # 0 where inf
        headroom = np.maximum(V[:, None] - V[m2], 0.0)
        gain = np.minimum(gain, 0.5 * headroom)
        gain[m2, :] = 0.0
        r_share = float(gain.max() / np.maximum(V[m2], 1e-300))
    return max(r_load, r_cover, r_share)


def sca_enhance_plan(sc: Scenario, plan: Plan, *, alpha: float = 0.995,
                     max_iters: int = 60,
                     warm_l: Optional[np.ndarray] = None) -> Plan:
    """Apply Algorithm 3 to every master of a plan (dedicated or fractional).

    Fractional plans are handled by the paper's remark at the end of §IV-B:
    substitute γ → bγ, u → ku, a → a/k inside the DC pieces (done by
    ``_build_instance``).

    ``warm_l`` (optional, (M, N+1)) warm-starts each master's SCA iteration
    from previous loads instead of the plan's Theorem-1/3 point — the online
    replanner passes the previous plan here so few SCA iterations suffice
    when the worker pool changed only slightly.  Warm rows that put load on
    nodes the plan assigns no resources to, or whose total cannot cover
    L_m, fall back to the plan's own loads.
    """
    l_new = plan.l.copy()
    t_new = plan.t_per_master.copy()
    for m in range(sc.M):
        l_init, t_init = plan.l[m], float(plan.t_per_master[m])
        if warm_l is not None:
            cand = np.where((plan.k[m] > 0) & (plan.b[m] > 0), warm_l[m], 0.0)
            cand[0] = warm_l[m][0]
            t_cand = feasible_deadline(sc, m, plan.k, plan.b, cand)
            if np.isfinite(t_cand) and t_cand <= t_init:
                l_init, t_init = cand, t_cand
        l_row, t_m = sca_enhance_master(
            sc, m, plan.k, plan.b, l_init, t_init,
            alpha=alpha, max_iters=max_iters)
        if t_m <= t_new[m]:
            l_new[m] = l_row
            t_new[m] = t_m
    return Plan(k=plan.k.copy(), b=plan.b.copy(), l=l_new,
                t_per_master=t_new, method=plan.method + "+sca")
