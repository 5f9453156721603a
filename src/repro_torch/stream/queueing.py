"""Per-worker share tracking and pluggable admission control.

The paper's constraints (6c)/(25c) bound the *column sums* of the
computing-power and bandwidth fractions: Σ_m k_{m,n} ≤ 1 and
Σ_m b_{m,n} ≤ 1 for every shared worker n.  A static plan satisfies them
across masters; a streaming system must additionally satisfy them across
*concurrent in-flight tasks*.  ``SharePool`` is that ledger: tasks acquire
(k, b) rows on admission and release them on completion, and the engine
queues (backpressure) whatever does not fit.

Admission supports proportional down-scaling (fractional policies only): if
a task wants shares k_req but only f·k_req fits, it can run with f·k_req —
its loads are re-derived from the Theorem-3 closed form at the scaled
shares, trading a longer predicted completion for no queueing delay.

Which waiting task gets the next free shares is a pluggable
:class:`AdmissionPolicy`:

* ``fifo`` — arrival order with head-of-line blocking (the original
  behaviour; a newcomer may not slip past a waiting queue head);
* ``edf``  — earliest-deadline-first: candidates are ordered by task
  deadline (ties by arrival), the deadline-aware rule of Amiri & Gündüz
  (2018) for straggling workers;
* ``fair`` — per-master FIFO queues served round-robin (least-admitted
  master first, no cross-master head-of-line blocking) with **max-min fair
  share scaling**: a master's admitted column shares are capped at its
  water-filled max-min fair fraction of each contended worker, so one hot
  master cannot starve the rest even when it arrives first.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..obs import current_tracer

__all__ = [
    "AdmissionConfig", "SharePool", "WaitQueue",
    "AdmissionPolicy", "FIFOAdmission", "EDFAdmission", "FairShareAdmission",
    "make_admission_policy", "maxmin_share", "scale_shares",
    "fair_demand_rows",
]

_ATOL = 1e-9


@dataclasses.dataclass
class AdmissionConfig:
    """Admission / backpressure policy of the streaming engine.

    min_fraction: smallest acceptable down-scaling of the desired shares;
                  below it the task waits instead of running starved.
    allow_scaling: fractional policies may shrink shares; dedicated and
                  uncoded plans are all-or-nothing (whole workers).
    max_queue:    backpressure bound — arrivals beyond it are *rejected*
                  (counted, not simulated).  None = unbounded queue.
    policy:       waiting-task ordering: "fifo" | "edf" | "fair"
                  (see :func:`make_admission_policy`).
    speculate_factor: if set, an in-flight task whose re-timed completion
                  slips beyond ``factor ×`` its originally predicted service
                  time is speculatively re-dispatched on the spare pool
                  *before* a ``leave`` event proves the first attempt lost;
                  whichever attempt covers L first wins, the other is
                  cancelled.  None disables speculation.
    """
    min_fraction: float = 0.25
    allow_scaling: bool = True
    max_queue: Optional[int] = None
    policy: str = "fifo"
    speculate_factor: Optional[float] = None


class SharePool:
    """Ledger of in-flight (k, b) column sums over the N shared workers.

    Column 0 (the master's local processor) is never pooled: each master is
    always fully dedicated to itself (paper §II-A), so only columns 1..N are
    tracked.  Offline workers admit no new shares.
    """

    def __init__(self, N: int):
        self.N = int(N)
        self.k_used = np.zeros(N + 1)
        self.b_used = np.zeros(N + 1)
        self.online = np.ones(N + 1, dtype=bool)

    # -- capacity queries ---------------------------------------------------

    def available_k(self) -> np.ndarray:
        out = np.where(self.online, 1.0 - self.k_used, 0.0)
        out[0] = 1.0
        return np.maximum(out, 0.0)

    def available_b(self) -> np.ndarray:
        out = np.where(self.online, 1.0 - self.b_used, 0.0)
        out[0] = 1.0
        return np.maximum(out, 0.0)

    def feasible_fraction(self, k_req: np.ndarray, b_req: np.ndarray) -> float:
        """Largest f ∈ [0, 1] with f·k_req ≤ avail_k and f·b_req ≤ avail_b.

        Requests on offline workers force f = 0 (the caller should mask them
        out first if partial service is acceptable)."""
        need = (k_req[1:] > _ATOL) | (b_req[1:] > _ATOL)
        if not need.any():
            return 1.0
        ak, ab = self.available_k()[1:], self.available_b()[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            fk = np.where(k_req[1:] > _ATOL, ak / np.maximum(k_req[1:], _ATOL), np.inf)
            fb = np.where(b_req[1:] > _ATOL, ab / np.maximum(b_req[1:], _ATOL), np.inf)
        f = float(np.min(np.where(need, np.minimum(fk, fb), np.inf)))
        return float(np.clip(f, 0.0, 1.0))

    def has_headroom(self, k_req: np.ndarray, b_req: np.ndarray) -> bool:
        """Division-free check that implies ``feasible_fraction(...) == 1.0``.

        Conservative: it compares availability to the request elementwise,
        so within one ulp of the boundary it may say False where the
        division in :meth:`feasible_fraction` rounds up to exactly 1 —
        callers on a fast path then fall back to the exact computation.
        True always implies f ≥ 1 (each per-column quotient is ≥ 1 when
        availability ≥ request)."""
        kr, br = k_req[1:], b_req[1:]
        on = self.online[1:]
        ok = (((1.0 - self.k_used[1:] >= kr) & on) | (kr <= _ATOL)) \
            & (((1.0 - self.b_used[1:] >= br) & on) | (br <= _ATOL))
        return bool(ok.all())

    # -- mutation -----------------------------------------------------------

    def acquire(self, k_row: np.ndarray, b_row: np.ndarray) -> None:
        if np.any(self.k_used[1:] + k_row[1:] > 1.0 + 1e-6) or \
           np.any(self.b_used[1:] + b_row[1:] > 1.0 + 1e-6):
            raise ValueError("share acquisition violates column-sum <= 1")
        self.k_used[1:] += k_row[1:]
        self.b_used[1:] += b_row[1:]
        tr = current_tracer()
        if tr is not None:
            tr.gauge("pool_k_used", float(self.k_used[1:].sum()))

    def acquire_unchecked(self, k_row: np.ndarray, b_row: np.ndarray) -> None:
        """:meth:`acquire` minus the column-sum validation — for callers
        that have just proven :meth:`has_headroom` (availability ≥ request
        on every column implies the post-acquire sums stay ≤ 1)."""
        self.k_used[1:] += k_row[1:]
        self.b_used[1:] += b_row[1:]
        tr = current_tracer()
        if tr is not None:
            tr.gauge("pool_k_used", float(self.k_used[1:].sum()))

    def release(self, k_row: np.ndarray, b_row: np.ndarray) -> None:
        self.k_used[1:] = np.maximum(self.k_used[1:] - k_row[1:], 0.0)
        self.b_used[1:] = np.maximum(self.b_used[1:] - b_row[1:], 0.0)
        tr = current_tracer()
        if tr is not None:
            tr.gauge("pool_k_used", float(self.k_used[1:].sum()))

    def set_online(self, worker: int, online: bool) -> None:
        self.online[worker] = online


# ---------------------------------------------------------------------------
# Shared admission math
# ---------------------------------------------------------------------------

def scale_shares(pool: "SharePool", plan_k_row: np.ndarray,
                 plan_b_row: np.ndarray, online: np.ndarray, *,
                 allow_scaling: bool, floor: float,
                 fair_fn=None, spare_only: bool = False):
    """Mask one master's plan row to the online workers and scale it to
    what the pool (and the fairness cap) grants.

    This is *the* share-admission rule, used by both the streaming engine's
    dispatch and the serving bridge's step admission so the simulator and
    the real server cannot drift:

    * offline workers are masked out (column 0, the master's own
      processor, always stays);
    * ``spare_only`` additionally masks columns with no spare capacity
      (speculative twins race on leftovers while the original attempt
      keeps its own columns);
    * with ``allow_scaling``, the row is shrunk to the pool's feasible
      fraction, capped by ``fair_fn(k_req, b_req)`` when given, and
      rejected below ``floor``; without it, admission is all-or-nothing.

    Returns ``(k_row, b_row, f)`` with ``k_row[0] = b_row[0] = 1``, or
    ``None`` when the request does not fit.
    """
    k_req = np.where(online, plan_k_row, 0.0)
    b_req = np.where(online, plan_b_row, 0.0)
    k_req[0], b_req[0] = plan_k_row[0], plan_b_row[0]
    if spare_only:
        spare = (pool.available_k() > 1e-6) & (pool.available_b() > 1e-6)
        spare[0] = True
        k_req = np.where(spare, k_req, 0.0)
        b_req = np.where(spare, b_req, 0.0)
    f = pool.feasible_fraction(k_req, b_req)
    if allow_scaling:
        if fair_fn is not None:
            f = min(f, fair_fn(k_req, b_req))
        if f < floor:
            return None
        f = min(f, 1.0)
    elif f < 1.0 - 1e-9:
        return None
    else:
        f = 1.0
    k_row = f * k_req
    b_row = f * b_req
    k_row[0] = b_row[0] = 1.0            # the master's own processor
    return k_row, b_row, f


def fair_demand_rows(requester: int, plan_k: np.ndarray, online: np.ndarray,
                     waiting_masters: Set[int],
                     held_rows: Dict[int, np.ndarray]):
    """Assemble the (held, demands) inputs of ``fair_fraction``.

    ``held_rows`` maps each master to the sum of its currently-held k rows
    (in-flight tasks / running steps).  Masters that are merely *waiting*
    (queued work, no shares yet) demand their plan row on the online
    workers.  Shared by the streaming engine and the serving bridge so the
    fair-entitlement accounting cannot drift between them.

    Returns ``(held, demands)``: the requester's held row and the other
    claimants' demand rows."""
    width = plan_k.shape[1]
    held = held_rows.get(requester, np.zeros(width))
    others: Dict[int, np.ndarray] = {}
    for m2, row in held_rows.items():
        if m2 != requester:
            others[m2] = row.copy()
    for m2 in waiting_masters:
        if m2 == requester:
            continue
        row = np.where(online, plan_k[m2], 0.0)
        others[m2] = others.get(m2, np.zeros(width)) + row
    return held, list(others.values())


# ---------------------------------------------------------------------------
# Max-min fair water-filling
# ---------------------------------------------------------------------------

def maxmin_share(capacity: float, want: float,
                 others: Sequence[float]) -> float:
    """Max-min fair allocation to a claimant demanding ``want`` against
    ``others``' demands under a shared ``capacity`` (water-filling).

    Claimants below the fair line keep their full demand and release the
    rest; the remainder is split evenly among the still-unsatisfied.  The
    returned value is what the ``want`` claimant is entitled to."""
    demands = sorted(float(d) for d in others)
    cap = float(capacity)
    n = len(demands) + 1
    for d in demands:
        fair = cap / n
        if d <= fair + _ATOL:
            cap -= d
            n -= 1
        else:
            return min(want, cap / n)
    return min(want, cap)


# ---------------------------------------------------------------------------
# Pluggable admission policies
# ---------------------------------------------------------------------------

class AdmissionPolicy:
    """Ordering (and optional share-scaling) policy over waiting tasks.

    The engine ``offer``s each task with its master and deadline, asks for
    ``candidates()`` — task ids in the order admission should be attempted —
    and ``remove``s a task once admitted.  Two class flags shape the drain
    loop:

    * ``head_of_line``: a blocked candidate blocks everything behind it
      (strict global ordering).  ``False`` lets later candidates bypass a
      blocked one (per-master fairness).
    * ``reorders``: candidate order differs from arrival order, so a
      newcomer may outrank already-waiting tasks and the engine re-drains
      after enqueueing it.

    ``fair_fraction`` lets a policy cap a task's share scaling below what
    the pool has free; the default caps nothing.
    """

    name = "base"
    head_of_line = True
    reorders = False
    uses_fairness = False

    def __init__(self, max_queue: Optional[int] = None):
        self.max_queue = max_queue
        self.rejected = 0
        self._seq = itertools.count()
        # tid -> (master, deadline, seq)
        self._entries: Dict[int, Tuple[int, float, int]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, tid: int) -> bool:
        return tid in self._entries

    def offer(self, tid: int, *, master: int = 0,
              deadline: float = math.inf, force: bool = False) -> bool:
        """Enqueue; False (rejected) when the backpressure bound is hit.
        ``force`` bypasses the bound (re-queued in-flight work is never
        silently dropped)."""
        if not force and self.max_queue is not None \
                and len(self._entries) >= self.max_queue:
            self.rejected += 1
            tr = current_tracer()
            if tr is not None:
                tr.count("admission_rejected")
            return False
        self._entries[tid] = (int(master), float(deadline), next(self._seq))
        return True

    def remove(self, tid: int) -> None:
        del self._entries[tid]

    def note_admitted(self, master: int) -> None:
        """Called by the engine on *every* successful admission — including
        direct ones that never queued — so fairness counters see the true
        per-master grant history, not just the contended subset."""

    def waiting_masters(self) -> Set[int]:
        return {m for (m, _, _) in self._entries.values()}

    def candidates(self) -> List[int]:  # pragma: no cover - interface
        raise NotImplementedError

    def head(self) -> Optional[int]:
        """First candidate only — the hot path for head-of-line policies
        (the drain loop never looks past a blocked head), kept cheaper
        than materialising the full ``candidates()`` order."""
        cands = self.candidates()
        return cands[0] if cands else None

    def fair_fraction(self, master: int, k_req: np.ndarray,
                      b_req: np.ndarray, *, held: np.ndarray,
                      demands: Sequence[np.ndarray]) -> float:
        return 1.0


class FIFOAdmission(AdmissionPolicy):
    """Arrival order, head-of-line blocking — the original engine policy."""

    name = "fifo"

    def candidates(self) -> List[int]:
        # dict preserves insertion order == seq order: no sort needed
        return list(self._entries)

    def head(self) -> Optional[int]:
        return next(iter(self._entries), None)


class WaitQueue(FIFOAdmission):
    """Back-compat FIFO facade (``peek``/``take``) over FIFOAdmission —
    one queue implementation, two APIs."""

    def peek(self) -> Optional[int]:
        return self.head()

    def take(self) -> int:
        tid = self.head()
        self.remove(tid)
        return tid


class EDFAdmission(AdmissionPolicy):
    """Earliest-deadline-first: candidates ordered by (deadline, arrival).

    Tasks without deadlines (inf) sort last, in arrival order — with no
    deadlines anywhere this degenerates to FIFO.  The head lookup is a
    lazy-deletion heap, so the per-admission cost stays O(log Q) instead
    of re-sorting the whole backlog."""

    name = "edf"
    reorders = True

    def __init__(self, max_queue: Optional[int] = None):
        super().__init__(max_queue)
        self._heap: List[Tuple[float, int, int]] = []   # (deadline, seq, tid)

    def offer(self, tid: int, *, master: int = 0,
              deadline: float = math.inf, force: bool = False) -> bool:
        if not super().offer(tid, master=master, deadline=deadline,
                             force=force):
            return False
        _, dl, seq = self._entries[tid]
        heapq.heappush(self._heap, (dl, seq, tid))
        return True

    def head(self) -> Optional[int]:
        while self._heap:
            _, seq, tid = self._heap[0]
            entry = self._entries.get(tid)
            if entry is not None and entry[2] == seq:
                return tid
            heapq.heappop(self._heap)            # stale (admitted/re-offered)
        return None

    def candidates(self) -> List[int]:
        return sorted(self._entries,
                      key=lambda t: (self._entries[t][1],
                                     self._entries[t][2]))


class FairShareAdmission(AdmissionPolicy):
    """Per-master FIFO queues, round-robin across masters, max-min shares.

    Candidate order interleaves the per-master queue heads, least-admitted
    master first, so a burst from one master cannot head-of-line block the
    others.  ``fair_fraction`` additionally caps the admitted share scaling
    at the water-filled max-min fair entitlement per contended worker
    column, still subject to the pool's column-sum ≤ 1 ledger."""

    name = "fair"
    head_of_line = False
    reorders = True
    uses_fairness = True

    def __init__(self, max_queue: Optional[int] = None):
        super().__init__(max_queue)
        self._admitted: Dict[int, int] = {}

    def note_admitted(self, master: int) -> None:
        self._admitted[master] = self._admitted.get(master, 0) + 1

    def candidates(self) -> List[int]:
        by_master: Dict[int, List[int]] = {}
        for tid, (m, _, seq) in self._entries.items():
            by_master.setdefault(m, []).append(tid)   # insertion == seq order
        masters = sorted(by_master,
                         key=lambda m: (self._admitted.get(m, 0), m))
        out: List[int] = []
        depth = 0
        while True:
            row = [by_master[m][depth] for m in masters
                   if depth < len(by_master[m])]
            if not row:
                return out
            out.extend(row)
            depth += 1

    def fair_fraction(self, master: int, k_req: np.ndarray,
                      b_req: np.ndarray, *, held: np.ndarray,
                      demands: Sequence[np.ndarray]) -> float:
        """Largest f with held + f·k_req within the max-min fair share of
        every contended worker column (column 0, the master's own
        processor, is never contended)."""
        if not demands:
            return 1.0
        f = 1.0
        for n in np.nonzero(k_req[1:] > _ATOL)[0] + 1:
            dem = [float(d[n]) for d in demands if d[n] > _ATOL]
            if not dem:
                continue
            cap = maxmin_share(1.0, float(held[n] + k_req[n]), dem)
            allowed = max(cap - float(held[n]), 0.0)
            f = min(f, allowed / float(k_req[n]))
        return max(f, 0.0)


_POLICIES = {
    "fifo": FIFOAdmission,
    "edf": EDFAdmission,
    "fair": FairShareAdmission,
}


def make_admission_policy(name: str,
                          max_queue: Optional[int] = None) -> AdmissionPolicy:
    """Build the named waiting-task policy ("fifo" | "edf" | "fair")."""
    try:
        cls = _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown admission policy {name!r}; "
                         f"known: {sorted(_POLICIES)}") from None
    return cls(max_queue)
