"""Problem definitions for the multi-master / heterogeneous-worker coded
computation system (paper §II).

Conventions used throughout ``repro.core``:

* Node axis has length ``N + 1``; **column 0 is the master's local processor**
  (the paper's index ``n = 0``), columns ``1..N`` are the shared workers.
* All per-(master, node) parameters are dense ``(M, N + 1)`` arrays.
* ``k`` (computing-power fraction) and ``b`` (bandwidth fraction) are
  ``(M, N + 1)`` with column 0 pinned to 1 (a master is always dedicated to
  itself, paper §II-A).  Dedicated assignment means ``k ∈ {0,1}`` and
  ``b == k``; fractional means ``k, b ∈ [0,1]`` with per-worker column sums
  ``≤ 1`` (excluding column 0).
* Loads ``l`` are non-negative reals (the paper relaxes integrality in (7c)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Scenario",
    "Plan",
    "theta_dedicated",
    "theta_fractional",
    "validate_plan",
    "small_scale_scenario",
    "large_scale_scenario",
    "ec2_scenario",
]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """System parameters for one problem instance.

    Attributes
    ----------
    a:      (M, N+1) shift parameter of the shifted-exponential computation
            delay per coded row (paper eq. (2)); column 0 is local compute.
    u:      (M, N+1) rate parameter of the computation delay.
    gamma:  (M, N+1) rate parameter of the exponential communication delay
            per coded row at full bandwidth (paper eq. (1)).  Column 0 is
            ignored (local compute has no communication, eq. (5)).
    L:      (M,) number of *useful* inner products master m must recover.
    """

    a: np.ndarray
    u: np.ndarray
    gamma: np.ndarray
    L: np.ndarray

    def __post_init__(self):
        a = np.asarray(self.a, dtype=np.float64)
        u = np.asarray(self.u, dtype=np.float64)
        g = np.asarray(self.gamma, dtype=np.float64)
        L = np.asarray(self.L, dtype=np.float64)
        object.__setattr__(self, "a", a)
        object.__setattr__(self, "u", u)
        object.__setattr__(self, "gamma", g)
        object.__setattr__(self, "L", L)
        if a.shape != u.shape or a.shape != g.shape:
            raise ValueError("a, u, gamma must share shape (M, N+1)")
        if a.ndim != 2 or L.shape != (a.shape[0],):
            raise ValueError("bad scenario shapes")
        if np.any(u <= 0) or np.any(a < 0) or np.any(L <= 0):
            raise ValueError("u must be > 0, a >= 0, L > 0")
        if np.any(g[:, 1:] <= 0):
            raise ValueError("worker gamma must be > 0")

    @property
    def M(self) -> int:
        return self.a.shape[0]

    @property
    def N(self) -> int:
        return self.a.shape[1] - 1


@dataclasses.dataclass
class Plan:
    """A full solution: worker assignment + resource split + load allocation.

    ``t_per_master`` is the *predicted* (model-based) completion delay of each
    master under the allocation model that produced the plan; ``t`` is the
    min-max objective ``max_m t_per_master``.  Empirical delays come from
    ``repro.sim.montecarlo``.
    """

    k: np.ndarray                    # (M, N+1) computing-power fractions
    b: np.ndarray                    # (M, N+1) bandwidth fractions
    l: np.ndarray                    # (M, N+1) loads (coded rows)
    t_per_master: np.ndarray         # (M,)
    method: str = ""

    @property
    def t(self) -> float:
        return float(np.max(self.t_per_master))

    @property
    def redundancy(self) -> np.ndarray:
        """Per-master coding redundancy  Σ_n l_{m,n} / L_m  (≥ 1)."""
        return self.l.sum(axis=1)

    def workers_of(self, m: int) -> np.ndarray:
        """Worker indices (1-based columns) serving master m (paper Ω_m)."""
        return np.nonzero(self.l[m, 1:] > 0)[0] + 1


# ---------------------------------------------------------------------------
# Expected unit-delay θ (paper eqs. (10) and (24))
# ---------------------------------------------------------------------------

def theta_dedicated(sc: Scenario, assign: np.ndarray) -> np.ndarray:
    """θ_{m,n} for a dedicated assignment (paper eq. (10)).

    ``assign`` is a boolean/binary ``(M, N+1)`` participation mask (column 0
    should be 1).  Non-participating entries get ``inf`` so that ``1/θ = 0``.
    """
    th = np.full_like(sc.a, np.inf)
    th[:, 0] = 1.0 / sc.u[:, 0] + sc.a[:, 0]
    w = assign[:, 1:] > 0
    inv = 1.0 / sc.gamma[:, 1:] + 1.0 / sc.u[:, 1:] + sc.a[:, 1:]
    th[:, 1:] = np.where(w, inv, np.inf)
    return th


def theta_fractional(sc: Scenario, k: np.ndarray, b: np.ndarray) -> np.ndarray:
    """θ_{m,n} under fractional resource split (paper eq. (24))."""
    th = np.full_like(sc.a, np.inf)
    th[:, 0] = 1.0 / sc.u[:, 0] + sc.a[:, 0]
    kk, bb = k[:, 1:], b[:, 1:]
    act = (kk > 0) & (bb > 0)
    with np.errstate(divide="ignore"):
        val = (
            1.0 / np.where(act, bb * sc.gamma[:, 1:], 1.0)
            + 1.0 / np.where(act, kk * sc.u[:, 1:], 1.0)
            + sc.a[:, 1:] / np.where(act, kk, 1.0)
        )
    th[:, 1:] = np.where(act, val, np.inf)
    return th


def validate_plan(sc: Scenario, plan: Plan, *, fractional: bool,
                  atol: float = 1e-9) -> None:
    """Raise if a plan violates the paper's constraints (6c)-(6e)/(25c-d)."""
    k, b, l = plan.k, plan.b, plan.l
    if k.shape != (sc.M, sc.N + 1):
        raise ValueError("plan shape mismatch")
    if np.any(l < -atol):
        raise ValueError("negative load")
    if not np.allclose(k[:, 0], 1.0) or not np.allclose(b[:, 0], 1.0):
        raise ValueError("masters must be dedicated to themselves (k_{m,0}=1)")
    sums_k = k[:, 1:].sum(axis=0)
    sums_b = b[:, 1:].sum(axis=0)
    if np.any(sums_k > 1 + atol) or np.any(sums_b > 1 + atol):
        raise ValueError("per-worker resource constraint (6c)/(25c) violated")
    if not fractional:
        vals = np.unique(np.round(k[:, 1:], 12))
        if not np.all(np.isin(vals, (0.0, 1.0))):
            raise ValueError("dedicated plan requires binary k")
        if not np.allclose(k[:, 1:], b[:, 1:]):
            raise ValueError("dedicated plan requires b == k")
    # A node either gets everything (k,b,l > 0) or nothing (paper §IV-A).
    for m in range(sc.M):
        on = plan.l[m, 1:] > atol
        if np.any(on & ~((k[m, 1:] > 0) & (b[m, 1:] > 0))):
            raise ValueError("load assigned to a node with zero resources")


# ---------------------------------------------------------------------------
# Canonical scenarios from the paper's §V
# ---------------------------------------------------------------------------

def small_scale_scenario(rng: np.random.Generator | int = 0) -> Scenario:
    """M=2, N=5; a_{m,n} ∈ {0.2,0.25,0.3} ms, a_{m,0} ∈ {0.4,0.5} ms,
    u = 1/a, L = 1e4, γ = 2u (paper §V-A/V-B).  Times are in ms."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    M, N = 2, 5
    a = np.zeros((M, N + 1))
    a[:, 0] = rng.choice([0.4, 0.5], size=M)
    a[:, 1:] = rng.choice([0.2, 0.25, 0.3], size=(M, N))
    u = 1.0 / a
    gamma = 2.0 * u
    L = np.full(M, 1e4)
    return Scenario(a=a, u=u, gamma=gamma, L=L)


def large_scale_scenario(rng: np.random.Generator | int = 0,
                         M: int = 4, N: int = 50) -> Scenario:
    """M=4, N=50; a_{m,n} ~ U[0.05, 0.5] ms, a_{m,0} ∈ {0.4,0.5} ms,
    u = 1/a, L = 1e4, γ = 2u (paper §V-A/V-B)."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    a = np.zeros((M, N + 1))
    a[:, 0] = rng.choice([0.4, 0.5], size=M)
    a[:, 1:] = rng.uniform(0.05, 0.5, size=(M, N))
    u = 1.0 / a
    gamma = 2.0 * u
    L = np.full(M, 1e4)
    return Scenario(a=a, u=u, gamma=gamma, L=L)


# Fitted EC2 instance parameters from the paper's Fig. 7 (times in ms).
EC2_T2_MICRO = dict(a=1.36, u=4.976)
EC2_C5_LARGE = dict(a=0.97, u=19.29)


def ec2_scenario(rng: np.random.Generator | int = 0, M: int = 4, N: int = 50,
                 n_fast: int = 10, gamma_over_u: Optional[float] = None) -> Scenario:
    """Paper §V-C: 4 masters + 40 t2.micro + 10 c5.large workers; masters are
    t2.micro.  Computation-delay dominant unless ``gamma_over_u`` is given."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    a = np.zeros((M, N + 1))
    u = np.zeros((M, N + 1))
    a[:, 0], u[:, 0] = EC2_T2_MICRO["a"], EC2_T2_MICRO["u"]
    kinds = np.array([1] * n_fast + [0] * (N - n_fast))
    rng.shuffle(kinds)
    for n in range(N):
        spec = EC2_C5_LARGE if kinds[n] else EC2_T2_MICRO
        a[:, n + 1], u[:, n + 1] = spec["a"], spec["u"]
    if gamma_over_u is None:
        gamma = np.full_like(u, 1e9)  # computation-delay dominant
        gamma[:, 0] = 1e9
    else:
        gamma = gamma_over_u * u
    return Scenario(a=a, u=u, gamma=np.maximum(gamma, 1e-12), L=np.full(M, 1e4))
