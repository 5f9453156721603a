"""Online (re)planning for the streaming engine.

The static stack solves one batch: assignment (Alg. 1/2/4) → loads
(Thm. 1/2/3) → SCA enhancement (Alg. 3).  A streaming system must re-solve
as the pool drifts — workers leave, join, degrade — without paying the full
optimisation on every arrival.  ``OnlinePlanner`` wraps the static stack
with:

* **replan policies** — ``always`` (every arrival/churn event), ``periodic``
  (timer-driven), ``drift`` (re-solve when the per-master capacity vector
  V_m = Σ_n 1/θ_{m,n} moved more than a threshold), ``never``;
* **warm starting** — Algorithm 3 is seeded from the previous plan's loads
  (``sca_enhance_plan(warm_l=...)``), so a mildly-perturbed pool converges
  in a few SCA iterations instead of a cold solve;
* **a cheap closed-form fallback** — admission-time decisions (scaling a
  task's shares to what the pool has left) use the Theorem-1/3 closed form
  ``l* = t*/(2θ)`` directly; no iterative solve sits on the latency-critical
  path.

Pool changes are communicated as an ``online`` mask plus a per-worker
slowdown ``scale`` (1 = healthy); plans are always recomputed when the mask
changes (a plan placing load on a dead worker is never served).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Tuple

import numpy as np

from ..core.assignment import fractional_greedy, iterated_greedy, plan_from_assignment
from ..core.allocation import markov_loads
from ..core.benchmarks import uncoded_uniform
from ..core.problem import Plan, Scenario, theta_dedicated
from ..core.sca import kkt_residual, sca_enhance_master, sca_enhance_plan
from ..obs import current_tracer

__all__ = ["ReplanMode", "ReplanPolicy", "OnlinePlanner",
           "theta_row_fractional", "scaled_row_loads"]


class ReplanMode(str, enum.Enum):
    """Replan trigger policy.

    A ``str`` enum: members compare equal to their literal values, so both
    ``ReplanPolicy(mode=ReplanMode.DRIFT)`` and the historical
    ``ReplanPolicy(mode="drift")`` construct the same policy.

    INCREMENTAL re-plans at ``ALWAYS`` frequency (every pool change) but
    first attempts an O(affected-rows) *repair* of the incumbent plan —
    see ``OnlinePlanner`` — falling back to the full solve on worker joins
    or when the repaired plan's KKT residual drifts past ``repair_tol``.
    """
    ALWAYS = "always"
    PERIODIC = "periodic"
    DRIFT = "drift"
    NEVER = "never"
    INCREMENTAL = "incremental"


@dataclasses.dataclass
class ReplanPolicy:
    """When and how hard to re-optimise.

    mode:            a ``ReplanMode`` (or its string value).
    period:          timer interval for "periodic" (sim time units).
    drift_threshold: relative capacity change triggering a re-solve in
                     "drift" mode (max_m |V_m/V_m_prev - 1|).
    use_sca:         run Algorithm 3 on each re-solve (warm-started).
    sca_iters:       SCA iteration budget per re-solve.
    repair_tol:      "incremental" fallback tolerance: a repaired plan is
                     kept while kkt_residual(repaired) - kkt_residual(last
                     full solve) <= repair_tol.  Set to -1.0 to force the
                     fallback on every repair attempt (testing hook).
    suspect_after:   online straggler signal — once a worker has been the
                     *critical* delivery (tracer attribution: its shard
                     closed the covering prefix) this many times, the
                     planner treats it as slowed by ``suspect_penalty``
                     when solving (load shifts off the binding worker)
                     and counts a ``suspect_replans``.  0 disables.
    suspect_penalty: pessimism factor applied to a suspected worker's
                     effective speed inside the solve (planning belief
                     only — the simulated delays are untouched).
    """
    mode: ReplanMode = ReplanMode.INCREMENTAL
    period: float = 50.0
    drift_threshold: float = 0.15
    use_sca: bool = False
    sca_iters: int = 6
    repair_tol: float = 0.25
    suspect_after: int = 0
    suspect_penalty: float = 1.5

    def __post_init__(self):
        try:
            self.mode = ReplanMode(self.mode)
        except ValueError:
            raise ValueError(f"unknown replan mode {self.mode!r}") from None


def theta_row_fractional(a_row, u_row, g_row, k_row, b_row) -> np.ndarray:
    """θ_{m,·} of eq. (24) for a single master row (admission fast path)."""
    th = np.full_like(np.asarray(a_row, dtype=np.float64), np.inf)
    th[0] = 1.0 / u_row[0] + a_row[0]
    kk, bb = k_row[1:], b_row[1:]
    act = (kk > 0) & (bb > 0)
    with np.errstate(divide="ignore"):
        val = (1.0 / np.where(act, bb * g_row[1:], 1.0)
               + 1.0 / np.where(act, kk * u_row[1:], 1.0)
               + a_row[1:] / np.where(act, kk, 1.0))
    th[1:] = np.where(act, val, np.inf)
    return th


def scaled_row_loads(sc: Scenario, m: int, k_row: np.ndarray,
                     b_row: np.ndarray) -> Tuple[np.ndarray, float]:
    """Theorem-1/3 closed-form loads for one master at given shares.

    This is the latency-critical fallback: O(N) closed form, no iteration.
    Returns (l_row, t_pred)."""
    th = theta_row_fractional(sc.a[m], sc.u[m], sc.gamma[m], k_row, b_row)
    l, t = markov_loads(sc.L[m:m + 1], th[None, :])
    return l[0], float(t[0])


class OnlinePlanner:
    """Maintains the active Plan for the current pool state.

    ``policy`` picks the static planning stack:
      "dedicated"  — Alg. 1 iterated greedy + Thm-1 loads,
      "fractional" — Alg. 4 fractional greedy + Thm-3 loads,
      "uncoded"    — uniform uncoded benchmark (needs-all rule).
    """

    def __init__(self, sc: Scenario, *, policy: str = "fractional",
                 replan: Optional[ReplanPolicy] = None,
                 rng: np.random.Generator | int = 0):
        if policy not in ("dedicated", "fractional", "uncoded"):
            raise ValueError(f"unknown planning policy {policy!r}")
        self.base = sc
        self.policy = policy
        self.replan = replan or ReplanPolicy()
        self._seed = rng if isinstance(rng, int) else 0
        self._plan: Optional[Plan] = None
        self._key: Optional[bytes] = None
        self._capacity_at_plan: Optional[np.ndarray] = None
        self._online_at_plan: Optional[np.ndarray] = None
        self._scale_at_plan: Optional[np.ndarray] = None
        self._kkt_at_plan: Optional[float] = None
        self.replans = 0            # plan replacements (full solves + repairs)
        self.full_solves = 0
        self.repairs = 0
        self.repair_fallbacks = 0   # repairs rejected by the KKT criterion
        self.solve_wall: list = []  # seconds per full solve (perf_counter)
        self.repair_wall: list = []  # seconds per accepted repair
        self._subscribers: list = []
        # online suspect/straggler signal (critical-worker attribution)
        self.crit_counts: dict = {}        # worker -> critical attributions
        self.suspect_replans = 0           # plan replacements it caused
        self._suspect_scale: Optional[np.ndarray] = None
        self._suspect_pending = False

    # -- invalidation hooks --------------------------------------------------

    def subscribe(self, fn) -> None:
        """Register a callback fired whenever the active plan is *replaced*.

        Listener contract (stable; ``StepPlanCache`` and any future consumer
        may rely on it):

        * fires exactly once per plan replacement — a full re-solve *or* an
          accepted incremental repair while a previous plan existed;
        * fires *after* ``self.plan`` already points at the new plan, so a
          listener may inspect the fresh rows;
        * the first solve of a planner's life does not fire (no prior plan,
          hence no derived state to drop);
        * ``notify_pool_change`` additionally fires all listeners even when
          no replacement happens (membership changed but the policy absorbed
          it) — listeners must treat every callback as "drop derived state",
          not "a solve happened";
        * callbacks run synchronously, in subscription order, inside
          ``ensure_plan`` / ``notify_pool_change``; they must not call back
          into the planner.
        """
        self._subscribers.append(fn)

    def notify_pool_change(self) -> None:
        """Explicitly fire the subscribers (pool membership changed in a
        way the next ``ensure_plan`` may absorb without re-solving, e.g. a
        drift below threshold)."""
        for fn in self._subscribers:
            fn()

    # -- online suspect signal (critical-worker attribution) -----------------

    def note_critical(self, worker: int) -> None:
        """Feed one critical-delivery attribution (the tracer's per-task /
        per-step ``critical_worker``): the shard that closed the covering
        prefix came from ``worker``.  A repeatedly-critical worker is the
        binding constraint of the paper's min-max objective; once it has
        been critical ``ReplanPolicy.suspect_after`` times, the next
        ``ensure_plan`` treats it as ``suspect_penalty``× slower — a pure
        planning belief that shifts load off it — and the resulting plan
        replacement is counted in ``suspect_replans``."""
        w = int(worker)
        after = int(self.replan.suspect_after)
        if w <= 0 or after <= 0:
            return
        self.crit_counts[w] = self.crit_counts.get(w, 0) + 1
        if self.crit_counts[w] != after:
            return                       # fires once per worker per run
        if self._suspect_scale is None:
            self._suspect_scale = np.ones(self.base.N + 1)
        self._suspect_scale[w] = self.replan.suspect_penalty
        self._suspect_pending = True

    # -- pool state → effective scenario ------------------------------------

    def effective_scenario(self, online: np.ndarray,
                           scale: np.ndarray) -> Scenario:
        """Degradation-adjusted Scenario over the full node axis.

        ``scale[n] = f`` slows worker n by f: shift a×f, rates u/f and γ/f.
        Offline workers keep their parameters (exclusion happens in the
        restricted solve, not by parameter surgery)."""
        s = np.asarray(scale, dtype=np.float64)[None, :]
        return Scenario(a=self.base.a * s, u=self.base.u / s,
                        gamma=self.base.gamma / s, L=self.base.L)

    def capacity(self, online: np.ndarray, scale: np.ndarray) -> np.ndarray:
        """V_m = Σ_{n online} 1/θ_{m,n}: the drift statistic (1/t* scale)."""
        sc_eff = self.effective_scenario(online, scale)
        part = np.broadcast_to(online[None, :], (sc_eff.M, sc_eff.N + 1))
        th = theta_dedicated(sc_eff, part.astype(float))
        inv = np.where(np.isfinite(th), 1.0 / th, 0.0)
        return inv.sum(axis=1)

    # -- plan lifecycle ------------------------------------------------------

    @property
    def plan(self) -> Plan:
        if self._plan is None:
            raise RuntimeError("no plan yet — call ensure_plan first")
        return self._plan

    @property
    def needs_all(self) -> bool:
        return self.policy == "uncoded"

    def ensure_plan(self, online: np.ndarray, scale: np.ndarray, *,
                    force: bool = False, event: bool = False) -> Plan:
        """Return the active plan, re-solving per the replan policy.

        force: timer fired (periodic mode) or caller demands a re-solve.
        event: an arrival/churn happened ("always" mode re-solves on these).
        """
        online = np.asarray(online, dtype=bool)
        scale = np.asarray(scale, dtype=np.float64)
        if self._suspect_scale is not None:
            # the suspect belief changes the key too, so crossing the
            # threshold naturally invalidates the short-circuit below
            scale = scale * self._suspect_scale
        key = online.tobytes() + scale.tobytes()
        if self._plan is not None and key == self._key:
            return self._plan
        mode = self.replan.mode
        # Incremental: any pool-state change replans ("always" frequency),
        # but via O(affected-rows) repair when possible.  Full solve on
        # force, first plan, or repair rejection (joins / KKT fallback).
        if (mode == ReplanMode.INCREMENTAL and not force
                and self._plan is not None):
            t0 = time.perf_counter()
            repaired = self._repair(online, scale)
            if repaired is not None:
                if repaired is not self._plan:
                    self._adopt(repaired, online, scale, key,
                                full_solve=False)
                    self.repair_wall.append(time.perf_counter() - t0)
                else:
                    # Nothing moved: keep the incumbent bit-identical, just
                    # refresh the key so the next call short-circuits.
                    self._key = key
                return self._plan
        mask_changed = (self._key is None
                        or self._key[:online.nbytes] != online.tobytes())
        solve = (force or self._plan is None or mask_changed
                 or mode == ReplanMode.INCREMENTAL)
        if not solve:
            if mode == ReplanMode.ALWAYS and event:
                solve = True
            elif mode == ReplanMode.DRIFT:
                V = self.capacity(online, scale)
                drift = np.max(np.abs(V / np.maximum(
                    self._capacity_at_plan, 1e-300) - 1.0))
                solve = drift > self.replan.drift_threshold
        if solve:
            t0 = time.perf_counter()
            tr = current_tracer()
            if tr is None:
                new_plan = self._solve(online, scale)
            else:
                # cat "replan" (not the "plan" stage cat): a re-solve can
                # fire *inside* a serving step's plan stage, and stage
                # categories must tile the step without double counting.
                with tr.span("replan_solve", cat="replan",
                             args={"policy": self.policy,
                                   "mode": str(self.replan.mode.value),
                                   "replans": self.replans}):
                    new_plan = self._solve(online, scale)
            self._adopt(new_plan, online, scale, key, full_solve=True)
            self.solve_wall.append(time.perf_counter() - t0)
        return self._plan

    def _adopt(self, plan: Plan, online: np.ndarray, scale: np.ndarray,
               key: bytes, *, full_solve: bool) -> None:
        """Install ``plan`` as the active plan and fire the listeners."""
        had_plan = self._plan is not None
        self._plan = plan
        self._key = key
        self._online_at_plan = online.copy()
        self._scale_at_plan = scale.copy()
        self._capacity_at_plan = self.capacity(online, scale)
        if full_solve:
            self.full_solves += 1
            if self.policy != "uncoded":
                sc_eff = self.effective_scenario(online, scale)
                self._kkt_at_plan = kkt_residual(
                    sc_eff, plan.k, plan.b, plan.l, plan.t_per_master)
        else:
            self.repairs += 1
        self.replans += 1
        if self._suspect_pending:
            self.suspect_replans += 1
            self._suspect_pending = False
        if had_plan:
            for fn in self._subscribers:
                fn()

    # -- incremental repair ---------------------------------------------------

    def _repair(self, online: np.ndarray,
                scale: np.ndarray) -> Optional[Plan]:
        """Repair the incumbent plan for a perturbed pool, or ``None``.

        Only workers whose θ changed are touched (paper's per-worker θ
        structure: a worker's parameters enter other masters' rows only
        through the shares it already donated — which a leave zeroes and a
        degrade keeps).  The repair:

        * rejects **joins** (a new worker must be assigned shares — that is
          the full Algorithm 1/4 problem, not a row update);
        * zeroes departed workers' share/load columns;
        * recomputes the Theorem-1/3 closed-form load row (optionally
          SCA-polished) for every master holding shares on a moved worker;
        * falls back (returns ``None``) when the repaired plan's
          ``kkt_residual`` exceeds the residual recorded at the last full
          solve by more than ``ReplanPolicy.repair_tol`` — anchoring to the
          full-solve baseline lets single cheap repairs through while
          ratcheting accumulated drift back to a real solve.

        Returns the incumbent itself (``is``-identical) when nothing moved.
        """
        if self.policy == "uncoded":
            return None     # uniform re-solve is already O(M·N)
        old_online, old_scale = self._online_at_plan, self._scale_at_plan
        if old_online is None or old_scale is None:
            return None
        if bool(np.any(online & ~old_online)):
            return None     # join: requires a fresh assignment
        if online[0] != old_online[0] or scale[0] != old_scale[0]:
            return None     # local processors never churn; be safe if they do
        moved = (online != old_online) | (scale != old_scale)
        moved[0] = False
        if not bool(np.any(moved)):
            return self._plan
        inc = self._plan
        k = inc.k.copy(); b = inc.b.copy(); l = inc.l.copy()
        t = inc.t_per_master.copy()
        affected = np.nonzero(
            ((inc.k[:, moved] > 0) | (inc.l[:, moved] > 0)).any(axis=1))[0]
        gone = moved & ~online
        k[:, gone] = 0.0; b[:, gone] = 0.0; l[:, gone] = 0.0
        sc_eff = self.effective_scenario(online, scale)
        for m in affected:
            l_row, t_m = scaled_row_loads(sc_eff, int(m), k[m], b[m])
            if self.replan.use_sca:
                l_row, t_m = sca_enhance_master(
                    sc_eff, int(m), k, b, l_row, t_m,
                    max_iters=self.replan.sca_iters)
            l[m] = l_row
            t[m] = t_m
        if affected.size and self._kkt_at_plan is not None:
            r_new = kkt_residual(sc_eff, k, b, l, t)
            if r_new - self._kkt_at_plan > self.replan.repair_tol:
                self.repair_fallbacks += 1
                return None
        method = inc.method
        if not method.endswith("+repair"):
            method = method + "+repair"
        return Plan(k=k, b=b, l=l, t_per_master=t, method=method)

    # -- the restricted static solve ----------------------------------------

    def _solve(self, online: np.ndarray, scale: np.ndarray) -> Plan:
        sc_eff = self.effective_scenario(online, scale)
        cols = np.concatenate([[0], np.nonzero(online[1:])[0] + 1])
        if cols.size == 1:
            return self._local_only_plan(sc_eff)
        # ascontiguousarray: fancy indexing on axis 1 yields Fortran-ordered
        # copies, and axis=-1 reductions walk F-ordered memory in a different
        # order than C rows — a 1-ulp divergence between the solver's loads
        # and the repair path's row recomputation (scaled_row_loads works on
        # C rows).  Forcing C order keeps repair ≡ re-solve bit-identical.
        sub = Scenario(a=np.ascontiguousarray(sc_eff.a[:, cols]),
                       u=np.ascontiguousarray(sc_eff.u[:, cols]),
                       gamma=np.ascontiguousarray(sc_eff.gamma[:, cols]),
                       L=sc_eff.L)
        if self.policy == "uncoded":
            sub_plan = uncoded_uniform(sub)
        elif self.policy == "dedicated":
            k = iterated_greedy(sub, rng=self._seed)
            sub_plan = plan_from_assignment(sub, k, method="stream-dedicated")
        else:
            k = iterated_greedy(sub, rng=self._seed)
            sub_plan = fractional_greedy(sub, init=k, rng=self._seed)
        if self.replan.use_sca and self.policy != "uncoded":
            warm = None
            if self._plan is not None:
                warm = self._plan.l[:, cols]
            sub_plan = sca_enhance_plan(sub, sub_plan,
                                        max_iters=self.replan.sca_iters,
                                        warm_l=warm)
        return self._expand(sub_plan, cols)

    def _local_only_plan(self, sc_eff: Scenario) -> Plan:
        """Every shared worker is offline: each master computes alone.

        A single node needs no redundancy — load exactly L_m locally.  The
        uncoded benchmark has no local-compute path, so it cannot serve
        (t = inf; arrivals queue until a worker rejoins)."""
        M, W = self.base.M, self.base.N + 1
        k = np.zeros((M, W))
        k[:, 0] = 1.0
        l = np.zeros((M, W))
        if self.policy == "uncoded":
            t = np.full(M, np.inf)
        else:
            l[:, 0] = sc_eff.L
            theta0 = 1.0 / sc_eff.u[:, 0] + sc_eff.a[:, 0]
            t = sc_eff.L * theta0
        return Plan(k=k, b=k.copy(), l=l, t_per_master=t,
                    method=f"stream-{self.policy}-local-only")

    def _expand(self, sub_plan: Plan, cols: np.ndarray) -> Plan:
        M, W = self.base.M, self.base.N + 1
        k = np.zeros((M, W)); b = np.zeros((M, W)); l = np.zeros((M, W))
        k[:, cols] = sub_plan.k
        b[:, cols] = sub_plan.b
        l[:, cols] = sub_plan.l
        return Plan(k=k, b=b, l=l, t_per_master=sub_plan.t_per_master.copy(),
                    method=sub_plan.method)
