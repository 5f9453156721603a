"""Structured metrics of the streaming engine.

Per-task records plus pool-level aggregates, all in simulation time units
(the paper's scenarios are milliseconds):

* **sojourn**        t_complete − t_arrive  (what a user of the system sees)
* **queue_wait**     t_admit − t_arrive     (admission backpressure)
* **service**        t_complete − t_admit   (coded completion delay — the
                     quantity the paper's Theorems bound)
* **wasted_rows**    coded rows dispatched but cancelled at completion
                     (Σl − rows delivered by t_complete): the price of
                     redundancy, cf. the deadline policy's waste counter
* **overshoot_rows** delivered − L_m: rows received but not needed
* **utilization**    per-worker ∫ k_inflight dt / horizon — how much of each
                     worker's computing power the stream actually held

``summary()`` flattens everything into one dict of floats (JSON-ready);
``to_records()`` returns the raw per-task dicts for trace analysis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

__all__ = ["TaskRecord", "StreamMetrics"]


@dataclasses.dataclass
class TaskRecord:
    tid: int
    master: int
    t_arrive: float
    t_admit: float = math.nan
    t_complete: float = math.nan
    fraction: float = 1.0          # admitted share scale (1 = full plan shares)
    rows_total: float = 0.0        # Σ l dispatched
    rows_needed: float = 0.0       # L_m
    rows_delivered: float = 0.0    # delivered by completion
    retries: int = 0               # re-dispatches after losing too many workers
    deadline: float = math.inf     # absolute completion deadline (inf = none)
    speculated: bool = False       # a twin dispatch raced the original
    decode_ok: Optional[bool] = None
    max_err: float = math.nan

    @property
    def sojourn(self) -> float:
        return self.t_complete - self.t_arrive

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_arrive

    @property
    def service(self) -> float:
        return self.t_complete - self.t_admit

    @property
    def wasted_rows(self) -> float:
        return max(self.rows_total - self.rows_delivered, 0.0)

    @property
    def overshoot_rows(self) -> float:
        return max(self.rows_delivered - self.rows_needed, 0.0)

    @property
    def deadline_miss(self) -> bool:
        """Finite deadline not met (never-completed counts as a miss)."""
        return math.isfinite(self.deadline) and \
            not (self.t_complete <= self.deadline)

    def to_dict(self) -> Dict[str, float]:
        return {
            "tid": self.tid, "master": self.master,
            "t_arrive": self.t_arrive, "t_admit": self.t_admit,
            "t_complete": self.t_complete, "sojourn": self.sojourn,
            "queue_wait": self.queue_wait, "service": self.service,
            "fraction": self.fraction, "rows_total": self.rows_total,
            "rows_needed": self.rows_needed,
            "rows_delivered": self.rows_delivered,
            "wasted_rows": self.wasted_rows,
            "overshoot_rows": self.overshoot_rows,
            "retries": self.retries,
            "deadline": self.deadline,
            "deadline_miss": self.deadline_miss,
            "speculated": self.speculated,
            "decode_ok": self.decode_ok, "max_err": self.max_err,
        }


class StreamMetrics:
    """Accumulates task records and worker share-time integrals.

    ``keep_records=False`` switches to compact accumulation: completed
    tasks fold into scalar columns (sojourn / queue wait / waste / master
    / deadline counters) instead of retaining ``TaskRecord`` objects —
    ``summary()`` is unchanged, ``to_records()`` becomes unavailable.
    Required at fleet scale: 1e6 retained records cost ~1 GB.  Unserved
    tasks keep their records either way (there are few, and censoring
    needs their deadlines).
    """

    def __init__(self, M: int, N: int, keep_records: bool = True):
        self.M, self.N = int(M), int(N)
        self.keep_records = bool(keep_records)
        self.completed: List[TaskRecord] = []
        self.unserved_tasks: List[TaskRecord] = []   # never completed
        self.rejected = 0
        self.unserved = 0          # still queued when the run ended
        self.replans = 0
        self.speculations = 0      # twin dispatches raced against stragglers
        self.busy_k = np.zeros(N + 1)      # ∫ k dt per worker column
        self.busy_b = np.zeros(N + 1)
        self.t_end = 0.0
        self._n_completed = 0
        # compact columns (populated only when keep_records=False)
        self._c_master: List[int] = []
        self._c_sojourn: List[float] = []
        self._c_queue_wait: List[float] = []
        self._c_wasted: List[float] = []
        self._c_needed: List[float] = []
        self._dl_total = 0
        self._dl_miss = 0

    # -- accumulation --------------------------------------------------------

    def record_task(self, rec: TaskRecord) -> None:
        self._n_completed += 1
        if np.isfinite(rec.t_complete):
            self.t_end = max(self.t_end, rec.t_complete)
        if self.keep_records:
            self.completed.append(rec)
            return
        self._c_master.append(rec.master)
        self._c_sojourn.append(rec.sojourn)
        self._c_queue_wait.append(rec.queue_wait)
        self._c_wasted.append(rec.wasted_rows)
        self._c_needed.append(rec.rows_needed)
        if math.isfinite(rec.deadline):
            self._dl_total += 1
            self._dl_miss += int(rec.deadline_miss)

    def record_tasks_many(self, recs: List[TaskRecord],
                          t_completes: np.ndarray,
                          rows_delivered: np.ndarray) -> None:
        """Batched :meth:`record_task` for B completions finalised together.

        Writes ``t_complete`` / ``rows_delivered`` onto the records and
        folds them in with array ops.  Every derived column is the same
        IEEE expression elementwise, so the values equal B sequential
        :meth:`record_task` calls exactly (the compact lists come out in
        the caller's batch order — a permutation never visible through the
        order-invariant summary statistics)."""
        tc = np.asarray(t_completes, dtype=np.float64)
        rd = np.asarray(rows_delivered, dtype=np.float64)
        self._n_completed += len(recs)
        fin = tc[np.isfinite(tc)]
        if fin.size:
            self.t_end = max(self.t_end, float(fin.max()))
        if self.keep_records:
            for i, rec in enumerate(recs):
                rec.t_complete = float(tc[i])
                rec.rows_delivered = float(rd[i])
                self.completed.append(rec)
            return
        t_arrive = np.asarray([r.t_arrive for r in recs])
        t_admit = np.asarray([r.t_admit for r in recs])
        rows_total = np.asarray([r.rows_total for r in recs])
        dl = np.asarray([r.deadline for r in recs])
        for i, rec in enumerate(recs):
            rec.t_complete = float(tc[i])
            rec.rows_delivered = float(rd[i])
        self._c_master.extend(r.master for r in recs)
        self._c_sojourn.extend((tc - t_arrive).tolist())
        self._c_queue_wait.extend((t_admit - t_arrive).tolist())
        self._c_wasted.extend(np.maximum(rows_total - rd, 0.0).tolist())
        self._c_needed.extend(r.rows_needed for r in recs)
        fin_dl = np.isfinite(dl)
        self._dl_total += int(fin_dl.sum())
        self._dl_miss += int((fin_dl & ~(tc <= dl)).sum())

    def record_unserved(self, rec: TaskRecord,
                        censor_after: float = math.inf) -> None:
        """A task the run ended without serving — its expired deadline must
        count as a miss, or a starving policy would look deadline-perfect.

        ``censor_after``: observation horizon of a truncated run (engine
        ``until=``).  A deadline beyond it is *censored* — the simulation
        stopped before the verdict — and is excluded from the miss
        statistic rather than counted against the policy."""
        if math.isfinite(rec.deadline) and rec.deadline > censor_after:
            return
        self.unserved_tasks.append(rec)

    def record_share_interval(self, k_row: np.ndarray, b_row: np.ndarray,
                              dt: float) -> None:
        self.busy_k += k_row * dt
        self.busy_b += b_row * dt

    def record_share_interval_many(self, k_rows: np.ndarray,
                                   b_rows: np.ndarray,
                                   dts: np.ndarray) -> None:
        """Fold (B, N+1) share rows held for (B,) durations into the busy-
        time integrals in one pass (sum-associativity aside, B sequential
        :meth:`record_share_interval` calls)."""
        self.busy_k += (k_rows * dts[:, None]).sum(axis=0)
        self.busy_b += (b_rows * dts[:, None]).sum(axis=0)

    # -- views ---------------------------------------------------------------

    _COMPACT_COLS = {"sojourn": "_c_sojourn", "queue_wait": "_c_queue_wait",
                     "wasted_rows": "_c_wasted", "rows_needed": "_c_needed"}

    def _arr(self, attr: str, master: Optional[int] = None) -> np.ndarray:
        if not self.keep_records:
            a = np.asarray(getattr(self, self._COMPACT_COLS[attr]),
                           dtype=np.float64)
            if master is not None:
                a = a[np.asarray(self._c_master, dtype=np.int64) == master]
            return a
        recs = self.completed if master is None else [
            r for r in self.completed if r.master == master]
        return np.array([getattr(r, attr) for r in recs], dtype=np.float64)

    def sojourns(self, master: Optional[int] = None) -> np.ndarray:
        return self._arr("sojourn", master)

    def utilization(self) -> np.ndarray:
        """Mean in-flight computing-power share per worker (cols 1..N).

        With no observed horizon (nothing completed, ``t_end == 0``) the
        integral has no denominator — report zeros instead of the 1e300-
        scale garbage a tiny epsilon horizon would produce (shares can be
        recorded at a cutoff even when no task ever finished)."""
        if self.t_end <= 0.0:
            return np.zeros(self.N)
        return self.busy_k[1:] / self.t_end

    def to_records(self) -> List[Dict[str, float]]:
        if not self.keep_records:
            raise RuntimeError(
                "per-task records were not retained "
                "(BackendConfig.keep_records=False)")
        return [r.to_dict() for r in self.completed]

    def summary(self) -> Dict[str, float]:
        """One flat dict of floats.  NaN-safe by construction: statistics
        over partially-populated pools (tasks whose ``t_admit`` /
        ``t_complete`` are still NaN, or an entirely empty run) are computed
        over the *finite* samples only, and a key with no finite sample is
        omitted rather than emitted as NaN — downstream JSON/gating code
        never sees a NaN."""
        s = self.sojourns()
        q = self._arr("queue_wait")
        w = self._arr("wasted_rows")
        need = self._arr("rows_needed")
        ok = [r.decode_ok for r in self.completed if r.decode_ok is not None]
        out: Dict[str, float] = {
            "tasks_completed": float(self._n_completed),
            "tasks_rejected": float(self.rejected),
            "tasks_unserved": float(self.unserved),
            "replans": float(self.replans),
            "speculations": float(self.speculations),
            "horizon": float(self.t_end),
            "utilization_mean": float(self.utilization().mean()),
            "utilization_max": float(self.utilization().max()),
        }
        with_dl = [r for r in self.completed + self.unserved_tasks
                   if math.isfinite(r.deadline)]
        dl_total = len(with_dl) + self._dl_total
        if dl_total:
            dl_miss = sum(r.deadline_miss for r in with_dl) + self._dl_miss
            out["deadline_miss_rate"] = float(dl_miss / dl_total)
        if s.size:
            fin = s[np.isfinite(s)]
            fq = q[np.isfinite(q)]
            fw = w[np.isfinite(w)]
            out["throughput_per_time"] = \
                (self._n_completed / self.t_end) if self.t_end > 0 else 0.0
            out.update({
                "sojourn_mean": float(fin.mean()) if fin.size else math.inf,
                "sojourn_p50": float(np.quantile(fin, 0.50)) if fin.size else math.inf,
                "sojourn_p95": float(np.quantile(fin, 0.95)) if fin.size else math.inf,
                "sojourn_p99": float(np.quantile(fin, 0.99)) if fin.size else math.inf,
            })
            if fq.size:
                out["queue_wait_mean"] = float(fq.mean())
                out["queue_wait_p99"] = float(np.quantile(fq, 0.99))
            if fw.size:
                out["wasted_rows_per_task"] = float(fw.mean())
                need_sum = need[np.isfinite(need)].sum()
                out["wasted_fraction"] = float(
                    fw.sum() / max(need_sum, 1e-300))
        if ok:
            out["decode_ok_rate"] = float(np.mean([bool(v) for v in ok]))
        return out
