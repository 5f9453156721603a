"""Cluster / worker-pool profiles and delay-distribution fitting (Fig. 7).

Includes:
* the paper's Amazon EC2 fits (t2.micro / c5.large, §V-C),
* synthetic TPU-pod-group profiles used by the framework's heterogeneous
  shard planner (DESIGN.md §2.3): pods are near-deterministic per-step with a
  small shifted-exponential tail from host jitter / DCN incast,
* ``fit_shifted_exponential`` — the method-of-moments/MLE hybrid the paper
  uses to fit measured delays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.problem import EC2_C5_LARGE, EC2_T2_MICRO, Scenario

__all__ = [
    "WorkerClass", "ClusterProfile", "fit_shifted_exponential",
    "sample_shifted_exponential", "ec2_cluster", "tpu_pod_cluster",
]


@dataclasses.dataclass(frozen=True)
class WorkerClass:
    """One hardware class: shifted-exponential compute, exponential comms."""
    name: str
    a: float          # compute shift per unit row (ms)
    u: float          # compute rate (1/ms)
    gamma: float      # comms rate at full bandwidth (1/ms); inf → negligible

    @property
    def unit_delay(self) -> float:
        comm = 0.0 if not np.isfinite(self.gamma) else 1.0 / self.gamma
        return comm + 1.0 / self.u + self.a


@dataclasses.dataclass(frozen=True)
class ClusterProfile:
    """A pool of workers with per-class membership."""
    classes: Tuple[WorkerClass, ...]
    members: Tuple[int, ...]           # index into classes, one per worker
    master_class: WorkerClass

    @property
    def N(self) -> int:
        return len(self.members)

    def scenario(self, M: int, L: float = 1e4) -> Scenario:
        """Materialize an (M, N+1) Scenario from the profile."""
        N = self.N
        a = np.zeros((M, N + 1))
        u = np.zeros((M, N + 1))
        g = np.full((M, N + 1), 1e9)
        a[:, 0], u[:, 0] = self.master_class.a, self.master_class.u
        for j, ci in enumerate(self.members):
            c = self.classes[ci]
            a[:, j + 1], u[:, j + 1] = c.a, c.u
            g[:, j + 1] = c.gamma if np.isfinite(c.gamma) else 1e9
        return Scenario(a=a, u=u, gamma=g, L=np.full(M, L))


def sample_shifted_exponential(rng: np.random.Generator, n: int,
                               a: float, u: float) -> np.ndarray:
    """n unit-row delays ~ a + Exp(u)."""
    return a + rng.exponential(1.0 / u, size=n)


def fit_shifted_exponential(samples: np.ndarray) -> Tuple[float, float]:
    """Fit (a, u) of a shifted exponential, as the paper does for Fig. 7.

    MLE of the shift is min(samples); the textbook bias-corrected rate
    follows from the mean excess:  û = (n-1)/n / mean(x - â).
    """
    x = np.asarray(samples, dtype=np.float64)
    n = x.size
    a_hat = float(np.min(x))
    excess = float(np.mean(x - a_hat))
    u_hat = (n - 1) / n / max(excess, 1e-300)
    return a_hat, float(u_hat)


def ec2_cluster(N: int = 50, n_fast: int = 10,
                rng: np.random.Generator | int = 0,
                gamma_over_u: float | None = None) -> ClusterProfile:
    """The paper's §V-C pool: (N - n_fast) t2.micro + n_fast c5.large."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    g = (lambda u: gamma_over_u * u) if gamma_over_u else (lambda u: np.inf)
    t2 = WorkerClass("t2.micro", EC2_T2_MICRO["a"], EC2_T2_MICRO["u"],
                     g(EC2_T2_MICRO["u"]))
    c5 = WorkerClass("c5.large", EC2_C5_LARGE["a"], EC2_C5_LARGE["u"],
                     g(EC2_C5_LARGE["u"]))
    members = np.array([1] * n_fast + [0] * (N - n_fast))
    rng.shuffle(members)
    return ClusterProfile(classes=(t2, c5), members=tuple(int(x) for x in members),
                          master_class=t2)


def tpu_pod_cluster(n_pods: int = 8, degraded: Tuple[int, ...] = (3,),
                    base_ms_per_unit: float = 0.05,
                    dcn_gbps: float = 25.0) -> ClusterProfile:
    """Synthetic multi-pod profile for the framework's hetero shard planner.

    Each "worker" is a pod-group; a healthy pod computes a unit shard in
    ``base_ms_per_unit`` with a tight exponential tail, a degraded pod is 2×
    slower with a fat tail (models a failing host dragging its pod).  The
    DCN link rate sets γ.
    """
    healthy = WorkerClass("pod-healthy", a=base_ms_per_unit,
                          u=20.0 / base_ms_per_unit, gamma=dcn_gbps)
    slow = WorkerClass("pod-degraded", a=2.0 * base_ms_per_unit,
                       u=2.0 / base_ms_per_unit, gamma=dcn_gbps / 2)
    members = tuple(1 if i in degraded else 0 for i in range(n_pods))
    return ClusterProfile(classes=(healthy, slow), members=members,
                          master_class=healthy)
