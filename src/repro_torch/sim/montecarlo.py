"""Vectorised Monte-Carlo estimation of task completion delay — the port
of ``repro.sim.montecarlo``.

For each realization, every active (master, node) pair draws
T = T_tr + T_cp from the paper's delay model; master m completes at the
earliest time its cumulative received coded rows reach L_m ("all-or-nothing"
per node, paper §II-C).  The uncoded benchmark instead needs *all* its
workers (no redundancy → max).

The overall system delay of one realization is max_m (completion of m);
the paper's Fig. 2-6/8 plot its mean and CDF.  ``backend="numpy"`` is the
reference's Generator stream, bit for bit; ``"torch"`` samples on the
card (``stream.backend.simulate_batch``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.problem import Plan, Scenario
from ..stream.backend import (check_backend, completion_times,
                              simulate_batch, simulate_chunks_np)

__all__ = ["SimResult", "simulate_plan"]


@dataclasses.dataclass
class SimResult:
    per_master_mean: np.ndarray          # (M,) mean completion delay
    overall_mean: float                  # mean of max_m completion
    overall_samples: Optional[np.ndarray]  # (trials,) if keep_samples
    per_master_samples: Optional[np.ndarray]  # (trials, M) if keep_samples

    def quantile(self, q: float) -> float:
        if self.overall_samples is None:
            raise ValueError("run with keep_samples=True")
        return float(np.quantile(self.overall_samples, q))

    def cdf(self, ts: np.ndarray) -> np.ndarray:
        if self.overall_samples is None:
            raise ValueError("run with keep_samples=True")
        return np.searchsorted(np.sort(self.overall_samples), ts) / self.overall_samples.size


def _completion_times(T: np.ndarray, loads: np.ndarray, need: float) -> np.ndarray:
    """Earliest t with Σ_{n: T_n <= t} l_n >= need, per realization row.

    T: (R, K) delays, loads: (K,).  Returns (R,) (inf if unreachable).
    Thin wrapper over the shared batched backend (``stream.backend``),
    kept for API compatibility."""
    return completion_times(T, loads, float(need))


def simulate_plan(sc: Scenario, plan: Plan, trials: int = 100_000,
                  rng: np.random.Generator | int = 0, *,
                  needs_all: Optional[bool] = None,
                  keep_samples: bool = False,
                  straggle_p: float = 0.0, straggle_factor: float = 8.0,
                  chunk: Optional[int] = None,
                  backend: str = "numpy", device=None) -> SimResult:
    """Monte-Carlo the completion delay of a plan.

    needs_all: force the uncoded "wait for every worker" rule; defaults to
    auto-detect from ``plan.method`` containing "uncoded".

    straggle_p / straggle_factor: per-(trial, node) probability that a node
    is in a degraded state (its whole delay × factor).  Models the
    heavy-tailed *measured* behaviour of burstable cloud instances
    (CPU-credit throttling) that the paper's fitted shifted exponential
    underestimates — the planner still plans with the fitted parameters,
    exactly as the paper's §V-C does with its measured traces.

    backend: "numpy" (authoritative, bit-stable Generator stream) or
    "torch" — ``stream.backend.simulate_batch`` on ``device`` (default
    ``cuda``), float32.  The torch path is seeded from ``rng`` but draws
    from a ``torch.Generator``, so its samples are reproducible yet not
    bit-equal to numpy's; means/CDFs agree to Monte-Carlo precision.

    chunk: realizations per batch.  Defaults per backend (20k host rows on
    numpy; 64k device rows on torch) and is honored on both.
    """
    check_backend(backend)
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    if needs_all is None:
        needs_all = "uncoded" in plan.method
    M = sc.M

    if backend != "numpy":
        comp = simulate_batch(plan.l, plan.k, plan.b, sc.a, sc.u, sc.gamma,
                              sc.L, trials, seed=rng, needs_all=needs_all,
                              straggle_p=straggle_p,
                              straggle_factor=straggle_factor,
                              backend=backend, chunk=chunk, device=device)
        overall = comp.max(axis=1)
        return SimResult(
            per_master_mean=comp.mean(axis=0),
            overall_mean=float(overall.mean()),
            overall_samples=overall if keep_samples else None,
            per_master_samples=comp if keep_samples else None,
        )

    sums = np.zeros(M)
    overall_sum = 0.0
    samples = [] if keep_samples else None
    pm_samples = [] if keep_samples else None

    # streaming aggregation over the shared Generator-based chunk sampler
    # (one implementation with simulate_batch's numpy fallback)
    for comp in simulate_chunks_np(rng, plan.l, plan.k, plan.b, sc.a, sc.u,
                                   sc.gamma, sc.L, trials,
                                   needs_all=needs_all, straggle_p=straggle_p,
                                   straggle_factor=straggle_factor,
                                   chunk=chunk or 20_000):
        sums += comp.sum(axis=0)
        overall = comp.max(axis=1)
        overall_sum += overall.sum()
        if keep_samples:
            samples.append(overall)
            pm_samples.append(comp)

    return SimResult(
        per_master_mean=sums / trials,
        overall_mean=overall_sum / trials,
        overall_samples=np.concatenate(samples) if keep_samples else None,
        per_master_samples=np.concatenate(pm_samples) if keep_samples else None,
    )
