"""Discrete-event core of the streaming scheduler.

A heap-based event loop with a strict total order (time, then insertion
sequence) so that same-seed runs replay identically, plus the arrival /
churn processes that feed it:

* ``PoissonProcess`` — per-master memoryless task arrivals.
* ``TraceProcess``  — replay recorded arrival instants.
* ``WorkerEvent``   — worker churn: ``leave`` / ``join`` / ``degrade`` /
  ``restore`` at a given time, with a slowdown ``factor`` for degradation.

Event kinds are plain strings; payloads are opaque to the loop.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ARRIVAL", "COMPLETION", "CHURN", "REPLAN",
    "Event", "EventLoop",
    "ArrivalProcess", "PoissonProcess", "TraceProcess",
    "WorkerEvent",
]

ARRIVAL = "arrival"
COMPLETION = "completion"
CHURN = "churn"
REPLAN = "replan"


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int
    kind: str
    payload: Any = None


class EventLoop:
    """Min-heap of events keyed by (time, seq).

    ``seq`` is a global insertion counter: ties in time resolve in push
    order, which makes the whole simulation a pure function of its seeds.
    """

    def __init__(self):
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def push(self, time: float, kind: str, payload: Any = None) -> Event:
        if time < self.now - 1e-12:
            raise ValueError(f"event at t={time} is in the past (now={self.now})")
        ev = Event(float(time), next(self._seq), kind, payload)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        time, _, ev = heapq.heappop(self._heap)
        self.now = time
        return ev

    def peek_time(self) -> float:
        return self._heap[0][0] if self._heap else np.inf

    def peek_key(self) -> Tuple[float, int]:
        """(time, seq) of the head event without popping; (inf, -1) empty."""
        if not self._heap:
            return (np.inf, -1)
        t, s, _ = self._heap[0]
        return (t, s)

    def peek_kind(self) -> Optional[str]:
        return self._heap[0][2].kind if self._heap else None

    def head(self) -> Optional[Event]:
        """The head event without popping (None when empty)."""
        return self._heap[0][2] if self._heap else None

    def pop_run(self, max_events: int, max_time: float = np.inf,
                kinds: Optional[Tuple[str, ...]] = None) -> List[Event]:
        """Pop up to ``max_events`` consecutive events of the head's kind —
        or, with ``kinds``, of any kind in that set (a *mixed* run).

        The run stops at the first event of another kind (or whose time
        exceeds ``max_time``) — events come off the heap in exactly the
        (time, seq) order ``pop`` would yield, so a caller that processes
        the run items left to right (and re-queues any suffix it cannot
        handle via :meth:`requeue`) observes the identical total order.
        ``now`` advances to the last popped event's time; callers stepping
        through the run item by item may assign ``now`` per item (it only
        moves forward).
        """
        run: List[Event] = []
        if not self._heap:
            return run
        allowed = kinds if kinds is not None else (self._heap[0][2].kind,)
        while self._heap and len(run) < max_events:
            t, _, ev = self._heap[0]
            if ev.kind not in allowed or t > max_time:
                break
            heapq.heappop(self._heap)
            self.now = t
            run.append(ev)
        return run

    def requeue(self, events: Iterable[Event]) -> None:
        """Push already-popped events back, keeping their original seq.

        Used by batched processors that popped a run optimistically and then
        discovered a generated event (e.g. a completion) lands *inside* the
        run: the unprocessed suffix goes back with its (time, seq) keys
        intact, so the total order is exactly the per-event one.  ``now``
        rolls back to the earliest requeued event (the caller has not
        processed anything at or past it).
        """
        for ev in events:
            heapq.heappush(self._heap, (ev.time, ev.seq, ev))
            if ev.time < self.now:
                self.now = ev.time

    def __len__(self) -> int:
        return len(self._heap)

    def empty(self) -> bool:
        return not self._heap


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

class ArrivalProcess:
    """One task source bound to a master; yields successive arrival times.

    ``deadline_slack`` optionally attaches a completion deadline to every
    arrival: ``deadline = t_arrive + slack × t_pred`` with ``t_pred`` the
    plan-predicted completion of the master at arrival time (so "slack 2"
    means *twice the unloaded service time* regardless of master speed).
    ``None`` (default) means no deadline (inf) — deadline-aware admission
    policies then degenerate to FIFO.
    """

    master: int
    deadline_slack: Optional[float] = None

    def next_after(self, t: float) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def deadline_for(self, t: float, t_pred: float) -> float:
        """Absolute deadline of the arrival at ``t`` (inf = none)."""
        if self.deadline_slack is None or not np.isfinite(t_pred):
            return np.inf
        return t + self.deadline_slack * t_pred


class PoissonProcess(ArrivalProcess):
    """Poisson arrivals of rate ``rate`` (tasks per unit time) at ``master``.

    Each process owns an independent Generator seeded from (seed, master) so
    the arrival sequence is independent of event interleaving.
    """

    def __init__(self, master: int, rate: float, seed: int = 0,
                 deadline_slack: Optional[float] = None):
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.master = int(master)
        self.rate = float(rate)
        self.deadline_slack = deadline_slack
        self.rng = np.random.default_rng((int(seed), int(master), 0xA221))

    def next_after(self, t: float) -> float:
        return t + self.rng.exponential(1.0 / self.rate)


class TraceProcess(ArrivalProcess):
    """Replays a fixed sequence of arrival instants (trace-driven mode).

    ``deadlines`` optionally gives an *absolute* deadline per traced
    arrival (aligned with ``times`` after sorting); otherwise
    ``deadline_slack`` applies as in :class:`ArrivalProcess`.
    """

    def __init__(self, master: int, times: Sequence[float],
                 deadlines: Optional[Sequence[float]] = None,
                 deadline_slack: Optional[float] = None):
        self.master = int(master)
        self.deadline_slack = deadline_slack
        order = np.argsort(np.asarray([float(t) for t in times]),
                           kind="stable")
        self.times = [float(times[i]) for i in order]
        self.deadlines = None
        if deadlines is not None:
            if len(deadlines) != len(self.times):
                raise ValueError("deadlines must align with times")
            self.deadlines = [float(deadlines[i]) for i in order]
        self._i = 0

    def next_after(self, t: float) -> float:
        while self._i < len(self.times) and self.times[self._i] < t - 1e-12:
            self._i += 1
        if self._i >= len(self.times):
            return np.inf
        out = self.times[self._i]
        self._i += 1
        return out

    def deadline_for(self, t: float, t_pred: float) -> float:
        if self.deadlines is not None:
            # the arrival being handled is the one next_after last yielded
            return self.deadlines[max(self._i - 1, 0)]
        return super().deadline_for(t, t_pred)


# ---------------------------------------------------------------------------
# Worker churn
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerEvent:
    """A scheduled change to worker ``worker`` (1-based column) at ``time``.

    kind:
      ``leave``    worker goes offline *gracefully* (scheduled departure);
                   undelivered in-flight rows are lost (redundancy or
                   re-dispatch covers them).
      ``crash``    worker dies mid-task: same delivery loss as ``leave``
                   but unscheduled — typically produced by a fault
                   schedule (:mod:`repro.faults`), paired with a later
                   backoff ``join`` for recovery, and counted separately.
      ``join``     worker (re)joins the pool for new tasks.
      ``degrade``  worker slows down by ``factor`` (a×f, u/f, γ/f), applied
                   to new tasks and to the *remaining* time of in-flight
                   deliveries.
      ``restore``  degradation factor reset to 1.
    """
    time: float
    worker: int
    kind: str
    factor: float = 2.0

    def __post_init__(self):
        if self.kind not in ("leave", "crash", "join", "degrade", "restore"):
            raise ValueError(f"unknown churn kind {self.kind!r}")
        if self.kind == "degrade" and self.factor <= 0:
            raise ValueError("degrade factor must be > 0")
