"""``StreamingExecutor`` — the event-driven runtime over the paper's planner;
the port of ``repro.stream.engine``.

Everything but the verification numerics is the reference's host numpy,
unchanged.  With ``backend="torch"`` the verification products run
through the hand-written ``coded_matvec`` and ``mds_encode`` kernels and
the decode on the card, in float64, held to the numpy path's 1e-6
tolerance.

Where ``repro_torch.runtime.coded_exec.CodedExecutor`` executes *one*
static batch with a per-master Python loop, this engine serves a
*stream*: per-master arrival processes feed a discrete-event loop; each
arriving task acquires fractional (k, b) shares from the live worker pool
(column sums of concurrent in-flight tasks stay ≤ 1, paper (6c)/(25c)),
gets Theorem-1/3 closed-form loads at its admitted shares, and completes
at the earliest prefix of worker deliveries covering L_m coded rows.
Worker churn (leave / join / degrade / restore) retimes in-flight
deliveries and triggers online replanning per the configured
:class:`~repro_torch.stream.replan.ReplanPolicy`.

All per-task math routes through :mod:`repro_torch.stream.backend` — the
same batched sort+cumsum completion rule the Monte-Carlo simulator uses,
block-amortised exponential sampling, and (in verification mode) one
batched MDS encode + batched decode per master instead of a per-task
Python pipeline.

A run is a pure function of its seeds: event ties break by insertion order,
arrival processes own per-master generators, and delay randomness is
consumed from a pre-sampled block — same-seed replays produce identical
metrics, which the tier-1 tests assert.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import mds
from ..core.problem import Scenario
from ..device import resolve_device
from ..faults import FaultConfig, corrupt_products
from ..obs import Tracer, use_tracer
from . import backend as bk
from .barrier import churn_finish_update
from .config import StreamConfig
from .events import (ARRIVAL, CHURN, COMPLETION, REPLAN, ArrivalProcess,
                     Event, EventLoop, PoissonProcess, WorkerEvent)
from .metrics import StreamMetrics, TaskRecord
from .queueing import (AdmissionConfig, SharePool, fair_demand_rows,
                       make_admission_policy, scale_shares)
from .replan import OnlinePlanner, ReplanPolicy, scaled_row_loads

__all__ = ["StreamingExecutor", "poisson_sources"]


def poisson_sources(sc: Scenario, utilization: float = 0.5,
                    seed: int = 0) -> List[PoissonProcess]:
    """One Poisson source per master, sized to a target utilization.

    Rate_m = utilization / t*_m with t*_m the Theorem-1 predicted completion
    of the full pool split evenly — a convenient default that loads the
    system without saturating it."""
    from ..core.assignment import plan_from_assignment, simple_greedy
    plan = plan_from_assignment(sc, simple_greedy(sc))
    rates = utilization / np.maximum(plan.t_per_master, 1e-300)
    return [PoissonProcess(m, float(rates[m]), seed=seed)
            for m in range(sc.M)]


@dataclasses.dataclass
class _InFlight:
    tid: int
    master: int
    k_row: np.ndarray
    b_row: np.ndarray
    l_row: np.ndarray
    finish: np.ndarray            # absolute per-node delivery times
    need: float
    t_admit: float
    completion: float
    version: int = 0
    service_pred: float = 0.0     # predicted service time at dispatch
    speculative: bool = False     # a racing twin of an existing dispatch
    fraction: float = 1.0         # admitted share scale (1 = full plan row)


class StreamingExecutor:
    """Serves per-master task streams through the coded pipeline.

    Parameters
    ----------
    sc:        base Scenario (M masters, N shared workers).
    sources:   arrival processes (defaults to ``poisson_sources(sc)``).
    config:    a frozen :class:`~repro_torch.stream.config.StreamConfig` — the
               canonical construction surface.  It bundles the planning
               ``policy`` ("fractional" | "dedicated" | "uncoded"), the
               :class:`ReplanPolicy`, the :class:`AdmissionConfig`
               (share-scaling / backpressure / waiting-order; deadlines
               come from the arrival processes and feed EDF ordering and
               ``deadline_miss_rate``), a
               :class:`~repro_torch.stream.config.BackendConfig` (numerics
               backend, verification, straggler injection, the event-batch
               size of the vectorised loop, record retention) and the
               ``rng`` master seed.
    churn:     scheduled :class:`WorkerEvent`s (join/leave/degrade/restore).
    device:    where the ``"torch"`` verification runs (default ``cuda``;
               raises without a card — the CPU runs the kernels' plain
               versions only when named).
    tracer:    optional :class:`repro_torch.obs.Tracer`.  Records sim-time spans
               (queue wait / service per master lane, per-worker shard
               deliveries with critical-delivery attribution, churn
               instants) and wall-time spans (the run itself, replan
               solves, verification products/decodes) side by side.  A
               disabled tracer costs nothing: it is normalised to None.
               Tracing forces the reference per-event drain (the span
               streams are defined per event).

    The historical kwarg surface (``policy=``, ``replan=``, ``admission=``,
    ``numerics=``, ``verify_cols=``, ``rng=``, ``backend=``,
    ``straggle_p=``, ``straggle_factor=``) still works and is folded into a
    ``StreamConfig`` internally, but emits a ``DeprecationWarning``;
    passing both ``config`` and legacy kwargs is a ``TypeError``.

    One executor = one run.  Build a fresh instance to replay.
    """

    def __init__(self, sc: Scenario,
                 sources: Optional[Sequence[ArrivalProcess]] = None,
                 config: Optional[StreamConfig] = None, *,
                 churn: Sequence[WorkerEvent] = (),
                 tracer: Optional[Tracer] = None,
                 faults: Optional[FaultConfig] = None,
                 device=None,
                 **legacy):
        if legacy:
            if config is not None:
                raise TypeError(
                    "pass either config=StreamConfig(...) or the legacy "
                    f"kwargs, not both: {sorted(legacy)}")
            warnings.warn(
                "StreamingExecutor's per-feature kwargs (policy=, replan=, "
                "admission=, numerics=, verify_cols=, rng=, backend=, "
                "straggle_p=, straggle_factor=) are deprecated; pass "
                "config=StreamConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            config = StreamConfig.from_legacy_kwargs(**legacy)
        elif config is None:
            config = StreamConfig()
        bcfg = config.backend
        backend = bcfg.backend
        bk.check_backend(backend)
        self.device = resolve_device(device)
        self.config = config
        self.sc = sc
        policy = config.policy
        self.sources = list(sources) if sources is not None else \
            poisson_sources(sc, seed=config.rng)
        self.admission = config.admission or AdmissionConfig(
            allow_scaling=(policy == "fractional"))
        if policy != "fractional":
            self.admission = dataclasses.replace(self.admission,
                                                 allow_scaling=False)
        self.churn = sorted(churn, key=lambda e: e.time)
        self.numerics = bcfg.numerics
        self.verify_cols = int(bcfg.verify_cols)
        self.seed = int(config.rng)
        self.backend = backend
        self.straggle_p = float(bcfg.straggle_p)
        self.straggle_factor = float(bcfg.straggle_factor)
        self._event_batch = int(bcfg.event_batch)
        self._keep_records = bool(bcfg.keep_records)
        # Disabled tracers normalise to None so the off path is exactly the
        # no-tracer path (the < 2% disabled-overhead contract).
        self.tracer = tracer if (tracer is not None
                                 and tracer.enabled) else None
        # fault injection: draws come from stateless hash-seeded
        # generators (repro_torch.faults), never the delay block — a zero-rate
        # schedule leaves every delay bit identical to faults=None
        self.faults = faults
        self._fault_sched = faults.schedule() \
            if faults is not None and faults.active else None
        self._dispatch_seq = itertools.count()
        self._corrupt_marks: Dict[int, Tuple[int, str]] = {}
        self.fault_stats = {"crashes": 0, "drops": 0, "stales": 0,
                            "duplicates": 0, "corruptions": 0,
                            "corruptions_applied": 0, "detected": 0,
                            "false_flags": 0}

        self.planner = OnlinePlanner(sc, policy=policy,
                                     replan=config.replan, rng=self.seed)
        self.loop = EventLoop()
        self.pool = SharePool(sc.N)
        self.queue = make_admission_policy(self.admission.policy,
                                           self.admission.max_queue)
        self.metrics = StreamMetrics(sc.M, sc.N,
                                     keep_records=self._keep_records)

        self.scale = np.ones(sc.N + 1)
        self._sc_eff = sc
        self._exp = bk.ExponentialBlock(
            np.random.default_rng((self.seed, 0xD31A)), sc.N + 1,
            uniform_rows=1 if self.straggle_p > 0 else 0)
        self.tasks: Dict[int, TaskRecord] = {}
        self.inflight: Dict[int, _InFlight] = {}
        self.twins: Dict[int, _InFlight] = {}   # speculative racing dispatches
        self._verify_buf: List[_InFlight] = []
        self._next_tid = 0
        self._emitted = 0
        self._ran = False
        self.events_processed = 0
        # (plan, sc_eff)-keyed per-master full-share admission rows for the
        # vectorised arrival drain; cleared whenever either identity changes.
        self._row_cache: Dict = {}
        # Monotone completion-event versions: a stale COMPLETION (pushed
        # before churn retimed or re-dispatched its task) must never match.
        self._version_seq = itertools.count()

    @property
    def online(self) -> np.ndarray:
        """Worker-online mask — single source of truth is the share pool."""
        return self.pool.online

    # ------------------------------------------------------------------ run

    def run(self, max_tasks: int = 1000, until: float = np.inf) -> StreamMetrics:
        """Simulate ``max_tasks`` arrivals (drained to completion) or until
        sim time ``until``, whichever first.  Returns the metrics.

        If a :class:`~repro_torch.obs.Tracer` was passed, it is installed as the
        process-global tracer for the duration of the run (deep call sites
        — replan solves, backend decodes — record through it)."""
        if self._ran:
            raise RuntimeError("StreamingExecutor is single-shot; build a "
                               "fresh instance to replay")
        self._ran = True
        self.max_tasks = int(max_tasks)
        if self.tracer is None:
            return self._run_loop(until)
        with use_tracer(self.tracer) as tr:
            with tr.span("stream_run", cat="run",
                         args={"backend": self.backend,
                               "max_tasks": self.max_tasks}):
                return self._run_loop(until)

    def _run_loop(self, until: float) -> StreamMetrics:
        for i, src in enumerate(self.sources):
            t0 = src.next_after(0.0)
            if np.isfinite(t0):
                self.loop.push(t0, ARRIVAL, i)
        for ev in self.churn:
            self.loop.push(ev.time, CHURN, ev)
        if self._fault_sched is not None and self.faults.crash_rate > 0:
            horizon = until
            if not np.isfinite(horizon):
                # arrival-driven runs have no wall clock: bound the chaos
                # window by the expected span of max_tasks arrivals
                rate = sum(getattr(s, "rate", 0.0) for s in self.sources)
                horizon = 4.0 * self.max_tasks / rate if rate > 0 else 0.0
            plan = self.planner.ensure_plan(self.online, self.scale)
            mean_iv = float(np.mean(plan.t_per_master))
            for ev in self._fault_sched.crash_events(
                    range(1, self.sc.N + 1), horizon, mean_iv):
                self.loop.push(ev.time, CHURN, ev)
        pol = self.planner.replan
        if pol.mode == "periodic":
            self.loop.push(pol.period, REPLAN, None)

        # Tracing pins the reference per-event drain: the span/instant
        # streams are defined per event, and the batched fast paths skip
        # exactly the call sites that emit them.
        batched = self._event_batch > 1 and self.tracer is None
        while not self.loop.empty():
            if self.loop.peek_time() > until:
                break
            if batched:
                kind = self.loop.peek_kind()
                if kind == ARRIVAL or kind == COMPLETION:
                    self._drain_run(until)
                    continue
            ev = self.loop.pop()
            self.events_processed += 1
            if ev.kind == ARRIVAL:
                self._on_arrival(ev.payload, ev.time)
            elif ev.kind == COMPLETION:
                self._on_completion(ev.payload, ev.time)
            elif ev.kind == CHURN:
                self._on_churn(ev.payload, ev.time)
            elif ev.kind == REPLAN:
                self.planner.ensure_plan(self.online, self.scale, force=True)
                # Reschedule only while something else can still happen: a
                # pending arrival/completion/churn event (at most one REPLAN
                # exists and it was just popped) or an in-flight task.  A
                # bare unservable queue must not keep the loop alive forever.
                if self.inflight or self.twins or len(self.loop):
                    self.loop.push(ev.time + pol.period, REPLAN, None)

        if self.numerics == "verify":
            self._run_verification()
        self.metrics.replans = self.planner.replans
        self.metrics.rejected = self.queue.rejected
        self.metrics.unserved = len(self.queue) + len(self.inflight)
        # an `until` cutoff censors deadlines that had not yet expired when
        # observation stopped; a naturally-drained run leaves no censoring
        # (nothing more can ever happen, so an unserved deadline is a miss)
        censor = until if np.isfinite(until) else np.inf
        for tid in self.queue.candidates():
            self.metrics.record_unserved(self.tasks[tid], censor_after=censor)
        # stranded in-flight work is unserved too, and its held shares are
        # accounted up to the cutoff
        t_stop = until if np.isfinite(until) else self.loop.now
        for fl in self._attempts():
            self.metrics.record_share_interval(
                fl.k_row, fl.b_row, max(t_stop - fl.t_admit, 0.0))
        for tid in self.inflight:
            self.metrics.record_unserved(self.tasks[tid], censor_after=censor)
        return self.metrics

    # ------------------------------------------------------------- handlers

    def _on_arrival(self, src_idx: int, t: float) -> None:
        if self._emitted >= self.max_tasks:
            return
        src = self.sources[src_idx]
        tid = self._next_tid
        self._next_tid += 1
        self._emitted += 1
        rec = TaskRecord(tid=tid, master=src.master, t_arrive=t,
                         rows_needed=float(self.sc.L[src.master]))
        self.tasks[tid] = rec
        if self.tracer is not None:
            self.tracer.instant(f"arrive:t{tid}", t, cat="arrival",
                                track=f"sim:m{src.master}",
                                args={"task": tid, "master": src.master})
        plan = self.planner.ensure_plan(self.online, self.scale, event=True)
        rec.deadline = float(src.deadline_for(
            t, float(plan.t_per_master[src.master])))
        if self._emitted < self.max_tasks:
            t_next = src.next_after(t)
            if np.isfinite(t_next):
                self.loop.push(t_next, ARRIVAL, src_idx)
        # Fairness: earlier-queued tasks get first claim on the pool — a
        # newcomer may not slip past a waiting candidate the policy ranks
        # ahead of it.
        self._drain_queue(t)
        if len(self.queue) == 0 and self._try_admit(tid, t):
            return
        if not self.queue.offer(tid, master=rec.master, deadline=rec.deadline):
            del self.tasks[tid]              # backpressure: rejected outright
            return
        if self.queue.reorders and len(self.queue) > 1:
            # deadline/fairness policies may rank the newcomer ahead of the
            # previously-blocked head — give it one admission attempt now
            self._drain_queue(t)

    def _on_completion(self, payload: Tuple[int, int], t: float) -> None:
        tid, version = payload
        fl = self.inflight.get(tid)
        tw = self.twins.get(tid)
        if fl is not None and fl.version == version:
            win, lose = fl, tw
        elif tw is not None and tw.version == version:
            win, lose = tw, fl
        else:
            return                            # stale (churn retimed the task)
        if lose is not None:                  # cancel the slower racing twin
            self.pool.release(lose.k_row, lose.b_row)
            self.metrics.record_share_interval(lose.k_row, lose.b_row,
                                               t - lose.t_admit)
        self.twins.pop(tid, None)
        self.inflight[tid] = win
        self._finalize(win, t)
        self._drain_queue(t)

    def _attempts(self) -> List[_InFlight]:
        return list(self.inflight.values()) + list(self.twins.values())

    def _alive(self, fl: _InFlight) -> bool:
        return self.inflight.get(fl.tid) is fl or self.twins.get(fl.tid) is fl

    def _on_churn(self, ev: WorkerEvent, t: float) -> None:
        w = ev.worker
        undo = self.scale[w]
        if self.tracer is not None:
            self.tracer.instant(f"churn:{ev.kind}:w{w}", t, cat="churn",
                                track=f"sim:worker{w}",
                                args={"worker": w, "kind": ev.kind,
                                      "factor": ev.factor})
        if ev.kind == "leave" or ev.kind == "crash":
            self.pool.set_online(w, False)
            if ev.kind == "crash":
                self.fault_stats["crashes"] += 1
        elif ev.kind == "join":
            self.pool.set_online(w, True)
        elif ev.kind == "degrade":
            self.scale[w] *= ev.factor
        elif ev.kind == "restore":
            self.scale[w] = 1.0
        # the effective scenario must reflect THIS event before any retime:
        # re-dispatches and speculative twins triggered below sample their
        # delays from it
        self._sc_eff = self.planner.effective_scenario(self.online, self.scale)
        # pool membership/speed changed: consumers holding plan-derived
        # state (the serving bridge's step-plan cache subscribes through
        # the planner) must drop it even when the replan policy decides
        # the drift is too small to re-solve
        self.planner.notify_pool_change()
        if ev.kind in ("leave", "crash", "degrade", "restore"):
            for fl in self._attempts():
                if self._alive(fl) and churn_finish_update(
                        fl.finish, fl.l_row, w, ev.kind, t,
                        factor=ev.factor, undo=undo):
                    if self.tracer is not None:
                        self.tracer.count("churn_retimes", t=t, track="sim")
                    self._retime(fl, t)
        self.planner.ensure_plan(self.online, self.scale, event=True)
        self._drain_queue(t)

    # ----------------------------------------------------- vectorised drains
    #
    # The batched loop (BackendConfig.event_batch > 1) pops *mixed runs* of
    # arrival + completion events instead of one heap entry at a time — at
    # steady state the two kinds alternate, so homogeneous runs would be
    # near-singletons — and pushes their math through the batched backend
    # primitives.  Correctness contract: every *ledger* mutation (SharePool
    # acquire/release) happens in the exact (time, seq) order the per-event
    # loop would produce; the pure math (delay sampling, delivered-row
    # counts, completion times) and the metric finalisation defer to one
    # batched call per run.  Observable divergences: (a) generated events
    # get different seq numbers (matters only on exact time ties — measure
    # zero under continuous arrival/delay distributions), (b) ledger /
    # busy-time accumulators are summed with array ops (float associativity
    # at the ulp level), and (c) completions finalise in run order, so a
    # deferred completion landing inside the run's span records *after* the
    # run's own completions — the metrics lists are a permutation of the
    # per-event ones and every summary statistic is order-invariant.
    # Anything the fast path cannot handle exactly — a backlogged queue,
    # racing twins, fairness or partial-fraction admission, verification
    # numerics (whose probe RNG pairs with buffer order) — drops to the
    # unchanged per-event handlers.

    def _drain_run(self, until: float) -> None:
        fast = (len(self.queue) == 0 and not self.twins
                and self.tracer is None
                and self._fault_sched is None
                and self.numerics != "verify"
                and not self.planner.needs_all
                and not self.queue.uses_fairness
                and self.admission.min_fraction <= 1.0)
        if not fast:
            ev = self.loop.pop()
            self.events_processed += 1
            if ev.kind == ARRIVAL:
                self._on_arrival(ev.payload, ev.time)
            else:
                self._on_completion(ev.payload, ev.time)
            return
        # Lazy walk: peek-then-pop one head event at a time, so arrivals
        # pushed mid-walk (a processed arrival schedules its source's next
        # one) join the same window in true heap order — nothing is popped
        # optimistically, so nothing ever needs re-queueing.
        loop = self.loop
        pend: List[Tuple] = []      # admitted arrivals awaiting delay math
        done: List[Tuple] = []      # live completions awaiting finalise
        n = 0
        while n < self._event_batch:
            ev = loop.head()
            if ev is None or ev.time > until or \
                    (ev.kind != ARRIVAL and ev.kind != COMPLETION):
                break
            if ev.kind == COMPLETION:
                loop.pop()
                tid, version = ev.payload
                fl = self.inflight.get(tid)
                if fl is not None and fl.version == version:
                    # release in walk order: later arrivals' headroom
                    # checks must see these shares, exactly as per-event
                    self.pool.release(fl.k_row, fl.b_row)
                    done.append((fl, ev.time))
                n += 1
                continue
            if self._emitted >= self.max_tasks:
                loop.pop()
                n += 1
                continue
            src = self.sources[ev.payload]
            m = src.master
            row = self._fast_row(m)
            if row is None or not self.pool.has_headroom(row[0], row[1]):
                # uncoverable row, or shares that would need scaling: the
                # reference handler decides queue-vs-scale-vs-reject.  With
                # no progress yet it must run *now* (stalling without
                # popping would respin this method forever); otherwise end
                # the window first so the flushed completions below land on
                # the heap ahead of it.
                if n == 0:
                    loop.pop()
                    self.events_processed += 1
                    self._on_arrival(ev.payload, ev.time)
                    return
                break
            loop.pop()
            t = ev.time
            k_row, b_row, l_row, t_pred, l_sum = row
            tid = self._next_tid
            self._next_tid += 1
            self._emitted += 1
            rec = TaskRecord(tid=tid, master=m, t_arrive=t,
                             rows_needed=float(self.sc.L[m]))
            self.tasks[tid] = rec
            rec.deadline = float(src.deadline_for(t, t_pred))
            if self._emitted < self.max_tasks:
                t_next = src.next_after(t)
                if np.isfinite(t_next):
                    loop.push(t_next, ARRIVAL, ev.payload)
            # The ledger mutates per item (sequential, bitwise the
            # per-event order); only the delay/completion math defers.
            # Unchecked: has_headroom above already proved the acquire
            # cannot violate the column-sum invariant.
            self.pool.acquire_unchecked(k_row, b_row)
            rec.rows_total += l_sum
            rec.t_admit = t
            rec.fraction = 1.0
            self.queue.note_admitted(m)
            pend.append((tid, m, t, k_row, b_row, l_row))
            n += 1
        self.events_processed += n
        self._flush_completions(done)
        self._flush_pending(pend)

    def _flush_completions(self, done: List[Tuple]) -> None:
        """Finalise a run's live completions in one batched pass.

        Their shares were already released item-by-item during the walk
        (ledger order is part of the exactness contract); what remains —
        delivered-row counts, busy-time accounting, task records — is pure
        math over per-task state frozen at release time, batched here."""
        if not done:
            return
        F = np.stack([fl.finish for fl, _ in done])
        Lr = np.stack([fl.l_row for fl, _ in done])
        ts = np.asarray([t for _, t in done])
        delivered = bk.delivered_by(F, Lr, ts)
        Kr = np.stack([fl.k_row for fl, _ in done])
        Br = np.stack([fl.b_row for fl, _ in done])
        self.metrics.record_share_interval_many(
            Kr, Br, ts - np.asarray([fl.t_admit for fl, _ in done]))
        self.metrics.record_tasks_many(
            [self.tasks[fl.tid] for fl, _ in done], ts, delivered)
        for fl, _ in done:
            del self.inflight[fl.tid]
            if not self._keep_records:
                del self.tasks[fl.tid]

    def _fast_row(self, m: int):
        """Cached full-share admission row of master ``m``, or None.

        Returns ``(k_row, b_row, l_row, t_pred, l_sum)`` — bitwise what
        ``scale_shares`` + ``scaled_row_loads`` produce at f = 1 — valid
        while neither the active plan nor the effective scenario object has
        been replaced (both are swapped wholesale on churn/replan, never
        mutated).  None when the row's loads cannot *strictly* cover L_m
        (the guarantee that makes a dispatch's completion finite without
        evaluating it)."""
        plan = self.planner._plan
        if plan is None:
            plan = self.planner.ensure_plan(self.online, self.scale,
                                            event=True)
        cache = self._row_cache
        ctx = cache.get("_ctx")
        if ctx is None or ctx[0] is not plan or ctx[1] is not self._sc_eff:
            cache.clear()
            cache["_ctx"] = (plan, self._sc_eff)
        row = cache.get(m)
        if row is None:
            k_row = np.where(self.online, plan.k[m], 0.0)
            b_row = np.where(self.online, plan.b[m], 0.0)
            k_row[0] = b_row[0] = 1.0
            l_row, _ = scaled_row_loads(self._sc_eff, m, k_row, b_row)
            l_sum = float(l_row.sum())
            ok = l_sum >= float(self.sc.L[m]) + 1e-9
            row = (k_row, b_row, l_row, float(plan.t_per_master[m]), l_sum,
                   ok)
            cache[m] = row
        return row[:5] if row[5] else None

    def _flush_pending(self, pend: List[Tuple]) -> None:
        """Sample delays + completion times for a run's admitted arrivals in
        one batched backend call each, then push their completion events.

        Deferral is sound because every pending task was admitted at full
        shares with strict coverage: its dispatch cannot fail, consumes
        exactly one delay draw (in admission order — ``draw_n`` is defined
        as n successive draws), and its completion event cannot influence
        any arrival accepted later in the same run (an empty queue means a
        completion only releases shares, and the fast path admits without
        needing them)."""
        if not pend:
            return
        B = len(pend)
        E = self._exp.draw_n(B)
        ms = np.asarray([p[1] for p in pend])
        Kr = np.stack([p[3] for p in pend])
        Br = np.stack([p[4] for p in pend])
        Lr = np.stack([p[5] for p in pend])
        d = bk.sample_delays(E[:, 0], E[:, 1], Lr, Kr, Br,
                             self._sc_eff.a[ms], self._sc_eff.u[ms],
                             self._sc_eff.gamma[ms],
                             straggle_p=self.straggle_p,
                             straggle_factor=self.straggle_factor,
                             straggle_u=E[:, 2] if self.straggle_p > 0
                             else None)
        ts = np.asarray([p[2] for p in pend])
        finish = np.where(Lr > 0, ts[:, None] + d, np.inf)
        need = self.sc.L[ms]
        comp = bk.completion_times(finish, Lr, need, needs_all=False,
                                   backend="numpy")
        deferred: List[Event] = []
        for i, (tid, m, t, k_row, b_row, l_row) in enumerate(pend):
            fl = _InFlight(tid=tid, master=int(m), k_row=k_row, b_row=b_row,
                           l_row=l_row, finish=finish[i],
                           need=float(need[i]), t_admit=t,
                           completion=float(comp[i]),
                           version=next(self._version_seq),
                           service_pred=float(comp[i]) - t, fraction=1.0)
            self.inflight[tid] = fl
            deferred.append(Event(float(comp[i]), next(self.loop._seq),
                                  COMPLETION, (tid, fl.version)))
        # requeue, not push: a completion earlier than the run's last
        # arrival is legitimately "in the past" of loop.now by design.
        self.loop.requeue(deferred)

    # ------------------------------------------------------------ admission

    def _fair_cap(self, m: int, k_req: np.ndarray,
                  b_req: np.ndarray) -> float:
        """Max-min fair share cap for master ``m`` (fair policy only).

        Claimants are masters with in-flight shares or waiting tasks; a
        waiting master's demand is its current plan row on the online
        workers."""
        held_rows: Dict[int, np.ndarray] = {}
        for fl in self._attempts():
            acc = held_rows.setdefault(fl.master, np.zeros_like(k_req))
            acc += fl.k_row
        held, demands = fair_demand_rows(
            m, self.planner.plan.k, self.online,
            self.queue.waiting_masters(), held_rows)
        return self.queue.fair_fraction(m, k_req, b_req, held=held,
                                        demands=demands)

    def _dispatch(self, tid: int, t: float,
                  min_fraction: Optional[float] = None
                  ) -> Optional[_InFlight]:
        """Admit ``tid``'s work onto the pool: scale shares to what fits
        (and to the fair-share cap), derive Thm-1/3 loads, sample delivery
        times, and acquire the ledger.  Returns the attempt, or None if the
        task cannot run now (insufficient shares / cannot cover L_m).

        ``min_fraction`` overrides the admission floor and additionally
        masks the request to workers with *spare* shares (speculative twins
        race on whatever capacity the pool has left — their original
        attempt still holds its own columns)."""
        rec = self.tasks[tid]
        m = rec.master
        plan = self.planner.ensure_plan(self.online, self.scale)
        fair_fn = (lambda kq, bq: self._fair_cap(m, kq, bq)) \
            if self.queue.uses_fairness else None
        scaled = scale_shares(
            self.pool, plan.k[m], plan.b[m], self.online,
            allow_scaling=self.admission.allow_scaling,
            floor=self.admission.min_fraction if min_fraction is None
            else min_fraction,
            fair_fn=fair_fn, spare_only=min_fraction is not None)
        if scaled is None:
            return None
        k_row, b_row, f = scaled

        if self.planner.needs_all:
            # uncoded: equal re-split over the plan's surviving workers
            l_row = np.zeros_like(k_row)
            w = np.nonzero(k_row[1:] > 0)[0] + 1
            if w.size == 0:
                return None
            l_row[w] = self.sc.L[m] / w.size
        else:
            l_row, _ = scaled_row_loads(self._sc_eff, m, k_row, b_row)
        if l_row.sum() < self.sc.L[m] - 1e-6 and not self.planner.needs_all:
            return None                      # cannot cover L_m: wait

        e = self._exp.draw()
        d = bk.sample_delays(e[0], e[1], l_row, k_row, b_row,
                             self._sc_eff.a[m], self._sc_eff.u[m],
                             self._sc_eff.gamma[m],
                             straggle_p=self.straggle_p,
                             straggle_factor=self.straggle_factor,
                             straggle_u=e[2] if self.straggle_p > 0 else None)
        finish = np.where(l_row > 0, t + d, np.inf)
        if self._fault_sched is not None:
            disp = next(self._dispatch_seq)
            loaded = np.nonzero(l_row[1:] > 0)[0] + 1
            for w, kind in self._fault_sched.faults_at(disp, loaded).items():
                if kind == "drop" or kind == "crash":
                    # a crash drawn at dispatch granularity loses this
                    # shard; the worker-level death/readmission process is
                    # the pre-generated crash churn stream in _run_loop
                    finish[w] = np.inf
                    self.fault_stats[
                        "crashes" if kind == "crash" else "drops"] += 1
                elif kind == "stale":
                    finish[w] = t + (finish[w] - t) * self.faults.stale_factor
                    self.fault_stats["stales"] += 1
                elif kind == "duplicate":
                    # the receiver keys deliveries by (task, worker): a
                    # replayed shard overwrites itself — counted, inert
                    self.fault_stats["duplicates"] += 1
                else:                                # corruption kinds
                    self._corrupt_marks[tid] = (int(w), kind)
                    self.fault_stats["corruptions"] += 1
        comp = float(bk.completion_times(
            finish[None], l_row[None], np.array([self.sc.L[m]]),
            needs_all=self.planner.needs_all, backend="numpy")[0])
        if not np.isfinite(comp):
            return None

        self.pool.acquire(k_row, b_row)
        rec.rows_total += float(l_row.sum())
        fl = _InFlight(tid=tid, master=m, k_row=k_row, b_row=b_row,
                       l_row=l_row, finish=finish, need=float(self.sc.L[m]),
                       t_admit=t, completion=comp,
                       version=next(self._version_seq),
                       service_pred=comp - t, fraction=f)
        self.loop.push(comp, COMPLETION, (tid, fl.version))
        return fl

    def _try_admit(self, tid: int, t: float) -> bool:
        fl = self._dispatch(tid, t)
        if fl is None:
            return False
        rec = self.tasks[tid]
        rec.t_admit = t
        rec.fraction = fl.fraction
        self.inflight[tid] = fl
        self.queue.note_admitted(rec.master)
        if self.tracer is not None and t > rec.t_arrive:
            self.tracer.add_span(f"queue:t{tid}", rec.t_arrive, t,
                                 cat="queue", track=f"sim:m{rec.master}",
                                 args={"task": tid})
        return True

    def _maybe_speculate(self, fl: _InFlight, t: float) -> None:
        """Race a twin dispatch against a straggling in-flight task.

        Triggered when churn re-timing pushed the predicted completion past
        ``speculate_factor ×`` the service time predicted at dispatch —
        *before* a ``leave`` event proves the original attempt lost.  The
        twin runs on whatever shares the pool has spare; first attempt to
        cover L_m wins and the loser is cancelled (its rows are the waste
        this insurance costs)."""
        sf = self.admission.speculate_factor
        if sf is None or fl.speculative or fl.tid in self.twins:
            return
        if self.inflight.get(fl.tid) is not fl:
            return
        if (fl.completion - fl.t_admit) <= sf * fl.service_pred:
            return
        tw = self._dispatch(fl.tid, t, min_fraction=1e-3)
        if tw is not None:
            tw.speculative = True
            self.twins[fl.tid] = tw
            self.tasks[fl.tid].speculated = True
            self.metrics.speculations += 1

    def _drain_queue(self, t: float) -> None:
        self._drain_queue_inner(t)
        if self.tracer is not None:
            self.tracer.gauge("queue_depth", len(self.queue), t=t,
                              track="sim")

    def _drain_queue_inner(self, t: float) -> None:
        while len(self.queue):
            if self.queue.head_of_line:
                # only the head can go: O(1)/O(log Q), no full reorder
                tid = self.queue.head()
                if tid is None or not self._try_admit(tid, t):
                    return                    # head-of-line blocking
                self.queue.remove(tid)
                continue
            admitted = False
            for tid in self.queue.candidates():
                if self._try_admit(tid, t):
                    self.queue.remove(tid)
                    admitted = True
                    break
            if not admitted:
                return

    # ----------------------------------------------------------- completion

    def _retime(self, fl: _InFlight, t: float) -> None:
        comp = float(bk.completion_times(
            fl.finish[None], fl.l_row[None], np.array([fl.need]),
            needs_all=self.planner.needs_all, backend="numpy")[0])
        if comp == fl.completion:
            return
        fl.version = next(self._version_seq)
        if np.isfinite(comp):
            fl.completion = comp
            self.loop.push(max(comp, t), COMPLETION, (fl.tid, fl.version))
            self._maybe_speculate(fl, t)
        else:
            self._drop_attempt(fl, t)

    def _drop_attempt(self, fl: _InFlight, t: float) -> None:
        """An attempt lost too many deliveries to ever cover L: release its
        shares; keep the surviving twin, or re-dispatch from scratch."""
        self.pool.release(fl.k_row, fl.b_row)
        self.metrics.record_share_interval(fl.k_row, fl.b_row, t - fl.t_admit)
        if self.twins.get(fl.tid) is fl:
            del self.twins[fl.tid]            # twin lost; original continues
            return
        del self.inflight[fl.tid]
        tw = self.twins.pop(fl.tid, None)
        if tw is not None:
            self.inflight[fl.tid] = tw        # promote the surviving twin
            # it is the task's primary attempt now — a later straggle may
            # legitimately speculate a fresh twin against it
            tw.speculative = False
            return
        rec = self.tasks[fl.tid]
        rec.retries += 1
        if not self._try_admit(fl.tid, t):
            # already-admitted work re-queues past the backpressure
            # bound — it must not be silently dropped mid-service
            self.queue.offer(fl.tid, master=rec.master,
                             deadline=rec.deadline, force=True)

    def _finalize(self, fl: _InFlight, t: float) -> None:
        rec = self.tasks[fl.tid]
        rec.t_complete = t
        rec.rows_delivered = float(bk.delivered_by(
            fl.finish[None], fl.l_row[None], np.array([t]))[0])
        if self.tracer is not None:
            self._trace_task(fl, rec, t)
        self.pool.release(fl.k_row, fl.b_row)
        self.metrics.record_share_interval(fl.k_row, fl.b_row, t - fl.t_admit)
        self.metrics.record_task(rec)
        del self.inflight[fl.tid]
        if self.numerics == "verify" and not self.planner.needs_all:
            self._verify_buf.append(fl)
        elif not self._keep_records:
            del self.tasks[fl.tid]

    def _trace_task(self, fl: _InFlight, rec: TaskRecord, t: float) -> None:
        """Sim-time spans for a completed attempt: the service interval on
        the master's lane, one delivery span per contributing worker on the
        worker's lane.  The *critical* delivery (finish == completion) is
        the covering-prefix row that closed the task — the paper's slowest-
        task objective, made visible per task."""
        tr = self.tracer
        tr.add_span(f"service:t{fl.tid}", fl.t_admit, t, cat="task",
                    track=f"sim:m{fl.master}",
                    args={"task": fl.tid, "fraction": fl.fraction,
                          "retries": rec.retries,
                          "speculative": fl.speculative})
        eps = 1e-9 * max(1.0, abs(t))
        for n in np.nonzero(fl.l_row > 0)[0]:
            fin = float(fl.finish[n])
            if not np.isfinite(fin):
                continue
            tr.add_span(f"t{fl.tid}/w{int(n)}", fl.t_admit, fin,
                        cat="delivery", track=f"sim:worker{int(n)}",
                        args={"worker": int(n), "task": fl.tid,
                              "rows": float(fl.l_row[n]),
                              "delivered": bool(fin <= t + eps),
                              "critical": bool(abs(fin - t) <= eps)})

    # --------------------------------------------------- batched verification

    def _verify_products(self, G: np.ndarray, A: np.ndarray, x: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-task true products Z_b = A_b x_b and coded results G @ Z_b.

        numpy: two einsums.  torch: the kernel path on ``device`` in
        float64 — ``coded_matvec`` for the per-task products (one launch
        for the stack) and ``mds_encode`` for the generator application,
        which copies the identity prefix of the systematic generator
        through and multiplies only its parity rows.  Returns (Z (B, L),
        y_full (B, L̃)) as host arrays."""
        if self.backend == "numpy":
            Z = np.einsum("bls,bs->bl", A, x)
            return Z, Z @ G.T
        from ..kernels import ops
        dev = self.device
        Z = ops.coded_matvec_batch(bk.as_f64(A, dev), bk.as_f64(x, dev))
        y_full = ops.mds_encode(bk.as_f64(G, dev), Z.T).T
        return Z.cpu().numpy(), y_full.cpu().numpy()

    def _run_verification(self) -> None:
        """Execute the completed tasks' numerics in per-master batches.

        One generator, one batched encode and one batched exactly-L decode
        per master — instead of ``CodedExecutor``'s per-task pipeline.  The
        decode takes the systematic-prefix fast path (a scatter, no solve)
        whenever a task's prefix contains only identity rows."""
        verify_tol = 1e-6
        by_master: Dict[int, List[_InFlight]] = {}
        for fl in self._verify_buf:
            by_master.setdefault(fl.master, []).append(fl)
        for m, fls in by_master.items():
            L = int(round(float(self.sc.L[m])))
            li = [mds.integer_loads(fl.l_row, 0) for fl in fls]
            Lt = max(max(int(x.sum()) for x in li), L)
            vrng = np.random.default_rng((self.seed, 0x7E51, m))
            G = mds.make_generator(L, Lt, kind="systematic", rng=vrng,
                                   dtype=np.float64)
            B, S = len(fls), self.verify_cols
            A = vrng.normal(size=(B, L, S))
            x = vrng.normal(size=(B, S))
            tr = self.tracer
            # cat "verify", not the stage cats: the wrapped calls (kernel
            # products, decode_batch) emit their own kernel/plan/decode
            # spans, and stage categories must not double count nested work
            ctx = tr.span(f"verify:m{m}:products", cat="verify",
                          args={"tasks": B, "backend": self.backend}) \
                if tr is not None else contextlib.nullcontext()
            with ctx:
                Z, y_full = self._verify_products(G, A, x)  # (B, L), (B, Lt)
            detect = self.faults is not None and self.faults.detect
            cap = int(self.faults.surplus_rows) if detect else 0
            rows = np.empty((B, L), dtype=np.int64)
            valid = np.ones(B, dtype=bool)
            # per-task delivered rows beyond the prefix + row→worker
            # attribution: the fault detector's parity-check budget
            extras: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for i, (fl, lint) in enumerate(zip(fls, li)):
                active = np.nonzero(lint > 0)[0]
                slices = mds.split_loads(int(lint[active].sum()), lint[active])
                order = np.argsort(np.where(np.isfinite(fl.finish[active]),
                                            fl.finish[active], np.inf),
                                   kind="stable")
                got: List[np.ndarray] = []
                gotw: List[np.ndarray] = []
                acc = 0
                for j in order:
                    if not np.isfinite(fl.finish[active[j]]) or \
                            fl.finish[active[j]] > fl.completion + 1e-9:
                        continue
                    got.append(slices[j])
                    gotw.append(np.full(slices[j].size, active[j],
                                        dtype=np.int64))
                    acc += slices[j].size
                    if acc >= L + cap:
                        break
                if acc < L:
                    valid[i] = False
                    continue
                allr = np.concatenate(got)[:L + cap]
                rows[i] = allr[:L]
                if self.faults is not None:
                    extras[i] = (allr, np.concatenate(gotw)[:L + cap])
            idx = np.nonzero(valid)[0]
            if idx.size:
                y_rows = np.take_along_axis(y_full[idx], rows[idx], axis=1)
                if self._corrupt_marks:
                    for pos, i in enumerate(idx):
                        mark = self._corrupt_marks.get(fls[i].tid)
                        if mark is None:
                            continue
                        w, kind = mark
                        msk = extras[i][1][:L] == w
                        if msk.any():
                            y_rows[pos, msk] = corrupt_products(
                                y_rows[pos, msk], kind,
                                eps=self.faults.corrupt_eps)
                ctx = tr.span(f"verify:m{m}:decode", cat="verify",
                              args={"tasks": int(idx.size)}) \
                    if tr is not None else contextlib.nullcontext()
                with ctx:
                    y_hat = bk.decode_batch(G, rows[idx], y_rows,
                                            backend=self.backend,
                                            device=self.device)
                truth = Z[idx]
                err = np.abs(y_hat - truth).max(axis=1)
                tol = verify_tol * (1.0 + np.abs(truth).max(axis=1))
                for j, i in enumerate(idx):
                    rec = self.tasks[fls[i].tid]
                    rec.max_err = float(err[j])
                    rec.decode_ok = bool(err[j] <= tol[j])
                if detect:
                    self._detect_corruptions(G, fls, idx, extras, y_full,
                                             y_hat, L)
            for i in np.nonzero(~valid)[0]:
                self.tasks[fls[i].tid].decode_ok = False

    def _detect_corruptions(self, G: np.ndarray, fls: List[_InFlight],
                            idx: np.ndarray, extras: Dict, y_full: np.ndarray,
                            y_hat: np.ndarray, L: int) -> None:
        """Residual-check each task's surplus deliveries against its decode.

        A corrupted delivery either fed the decode (honest surplus rows
        then disagree with the skewed x̂) or sits in the surplus itself
        (its own residual blows up) — either way the task flags without
        ever consulting the ground truth.  Tasks whose marked worker
        delivered nothing in the covering window injected nothing; a flag
        there (or on an unmarked task) counts as a false positive."""
        tolr = float(self.faults.residual_tol)
        for pos, i in enumerate(idx):
            allr, allw = extras[i]
            sr, sw = allr[L:], allw[L:]
            if sr.size == 0:
                continue
            mark = self._corrupt_marks.get(fls[i].tid)
            y_sur = y_full[i, sr].copy()
            applied = False
            if mark is not None:
                w, kind = mark
                applied = bool((allw == w).any())
                msk = sw == w
                if msk.any():
                    y_sur[msk] = corrupt_products(
                        y_sur[msk], kind, eps=self.faults.corrupt_eps)
            resid = np.abs(y_sur - G[sr] @ y_hat[pos]) / (1.0 + np.abs(y_sur))
            flagged = bool((resid > tolr).any())
            if mark is not None and applied:
                self.fault_stats["corruptions_applied"] += 1
                if flagged:
                    self.fault_stats["detected"] += 1
            elif flagged:
                self.fault_stats["false_flags"] += 1
