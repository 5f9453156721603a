"""Churn re-timing of in-flight coded tasks, and multi-task step barriers.

Two consumers share this module so their delivery semantics cannot drift:

* the :class:`~repro.stream.engine.StreamingExecutor` re-times each
  in-flight task's per-node delivery vector when a worker leaves, degrades
  or restores (``churn_finish_update`` is the single implementation of that
  arithmetic, factored out of the engine's ``_on_churn``);
* the coded serving bridge (:mod:`repro.serve_coded`), whose one "step" is
  now *several* concurrent coded tasks — one per trunk matmul per the
  configured coding scope — joined by a :class:`StepBarrier`: the step
  completes when every member task's earliest covering prefix has landed,
  and churn re-times every member through the same
  ``churn_finish_update`` path the engine uses.

Semantics (identical to the engine's historical in-line behaviour):

* ``leave``    — undelivered rows on that worker are lost (delivery → ∞);
* ``crash``    — identical delivery arithmetic to ``leave`` (a shard is
  delivered whole or not at all, so an unscheduled death loses exactly the
  pending deliveries); the *scheduling* difference — quarantine, backoff
  readmission, twin promotion — lives in the engine/bridge churn handlers;
* ``degrade``  — the *remaining* time of undelivered rows stretches by the
  event factor (work already under way is slowed, not restarted);
* ``restore``  — the remaining time shrinks by the accumulated slowdown
  being cleared (``undo``);
* ``join``     — no effect on in-flight deliveries (new capacity only
  helps future dispatches).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from . import backend as bk

__all__ = ["churn_finish_update", "BarrierTask", "StepBarrier"]


def churn_finish_update(finish: np.ndarray, loads: np.ndarray, worker: int,
                        kind: str, t: float, *, factor: float = 1.0,
                        undo: float = 1.0) -> bool:
    """Apply one churn event to an absolute delivery vector, in place.

    ``finish``/``loads`` are (N+1,) per-node arrays (column 0 = the
    master's local processor, which churn never touches by construction —
    worker events carry n ≥ 1).  Only *pending* deliveries move: a shard
    that already landed (``finish <= t``) is history.  Returns True when
    the vector changed (the caller should re-derive the completion time).
    """
    w = int(worker)
    if loads[w] <= 0 or finish[w] <= t:
        return False
    if kind == "leave" or kind == "crash":
        if not np.isfinite(finish[w]):
            return False
        finish[w] = np.inf
        return True
    if not np.isfinite(finish[w]):
        return False
    if kind == "degrade":
        finish[w] = t + (finish[w] - t) * factor
        return True
    if kind == "restore":
        if undo <= 0:
            return False
        finish[w] = t + (finish[w] - t) / undo
        return True
    return False                                  # "join": in-flight unmoved


@dataclasses.dataclass
class BarrierTask:
    """One coded matmul of a serving dispatch, delivery-timed per node.

    name:   log label ("head", "blk1.wq", ...).
    l_int:  (N+1,) integer shard sizes dispatched per node.
    finish: (N+1,) absolute delivery times (inf = never arrives).
    need:   rows whose earliest covering prefix completes this task
            (the coded matrix's own L, not the plan scenario's).
    assign: optional (N+1,) expected-delay sort key fixing which node
            holds which contiguous coded-row range (None = node order);
            dispatch-time information only — see
            ``CodedLinear.prefix_plan``.
    """
    name: str
    l_int: np.ndarray
    finish: np.ndarray
    need: float
    completion: float = np.inf
    assign: "np.ndarray | None" = None


class StepBarrier:
    """Completion barrier over the coded tasks of one serving dispatch.

    All member tasks are dispatched together (the workers hold the encoded
    weight shards; the step's activations stream to them as one admission),
    and the step's result is usable only when *every* task has decoded —
    so the barrier completes at the max of the per-task earliest-prefix
    completion times.  ``retime`` runs the engine's churn arithmetic over
    every member and re-derives the completions in one batched
    ``completion_times`` call.
    """

    def __init__(self, tasks: Sequence[BarrierTask], *,
                 F: "np.ndarray | None" = None,
                 l: "np.ndarray | None" = None,
                 need: "np.ndarray | None" = None):
        if not tasks:
            raise ValueError("a StepBarrier needs at least one task")
        self.tasks: List[BarrierTask] = list(tasks)
        if F is None:
            self.recompute()
            return
        # fast path for the serving dispatch: the caller already holds the
        # stacked (T, N+1) finish/load arrays the member tasks view into,
        # so skip recompute()'s per-task re-stacking
        comp = bk.completion_times(F, l, need)
        for task, c in zip(self.tasks, comp):
            task.completion = float(c)

    @property
    def completion(self) -> float:
        """Absolute step completion: max over member tasks (inf when any
        member can no longer cover its rows)."""
        return max(task.completion for task in self.tasks)

    def recompute(self) -> float:
        F = np.stack([task.finish for task in self.tasks])
        l = np.stack([task.l_int.astype(np.float64) for task in self.tasks])
        need = np.array([task.need for task in self.tasks])
        comp = bk.completion_times(F, l, need)
        for task, c in zip(self.tasks, comp):
            task.completion = float(c)
        return self.completion

    def retime(self, worker: int, kind: str, t: float, *,
               factor: float = 1.0, undo: float = 1.0) -> bool:
        """Apply a churn event to every member's pending deliveries.

        Returns True when any delivery moved (completions were re-derived
        and the caller must reschedule its step event)."""
        changed = [churn_finish_update(task.finish, task.l_int, worker, kind,
                                       t, factor=factor, undo=undo)
                   for task in self.tasks]
        if any(changed):
            self.recompute()
            return True
        return False

    def delivery_orders(self) -> List[np.ndarray]:
        """Stable delivery-order argsort of every member task's *active*
        nodes, in one batched call — the planning input of the batched
        shard-execution engine (each array indexes that task's active-node
        subarray, exactly what ``CodedLinear.prefix_plan`` consumes).

        All member tasks of one dispatch normally share the plan row's
        active set (``coded_row_shards`` keeps the zero pattern), so the
        common case is a single stacked argsort; heterogeneous active sets
        fall back to per-task sorts.
        """
        F = np.stack([task.finish for task in self.tasks])
        act = np.stack([task.l_int > 0 for task in self.tasks])
        if (act == act[0]).all():
            sub = F[:, act[0]]
            sub = np.where(np.isfinite(sub), sub, np.inf)
            return list(np.argsort(sub, axis=1, kind="stable"))
        return [np.argsort(np.where(np.isfinite(f[a]), f[a], np.inf),
                           kind="stable")
                for f, a in zip(F, act)]

    def covering_selections(self) -> List[tuple]:
        """Every member task's delivered covering prefix, one stacked pass.

        For each task: which active nodes delivered within its completion
        window (delivery order), and the contiguous coded-row range each
        holds under the task's ``assign`` layout.  This is the selection
        half of ``CodedLinear.prefix_plan`` — orders, coverage cumsums and
        row-range edges computed for the whole barrier as stacked array
        ops instead of ~15 per-matmul Python passes.

        Returns ``[(workers, starts, stops), ...]`` per task, where
        ``workers`` are node columns in delivery order and
        ``[starts[i], stops[i])`` is the coded-row range worker i holds.
        Raises RuntimeError when any task's deliveries do not cover its
        ``need`` rows by its completion (same contract as
        ``prefix_plan``).
        """
        act = np.stack([task.l_int > 0 for task in self.tasks])
        homogeneous = bool((act == act[0]).all())
        if not homogeneous:
            return [self._covering_one(task) for task in self.tasks]
        A = np.nonzero(act[0])[0]
        F = np.stack([task.finish for task in self.tasks])[:, A]
        l_act = np.stack([task.l_int for task in self.tasks])[:, A]
        need = np.array([task.need for task in self.tasks])
        comp = np.array([task.completion for task in self.tasks])
        f_inf = np.where(np.isfinite(F), F, np.inf)
        orders = np.argsort(f_inf, axis=1, kind="stable")
        f_ord = np.take_along_axis(f_inf, orders, axis=1)
        l_ord = np.take_along_axis(l_act, orders, axis=1)
        ok = np.isfinite(f_ord) & (f_ord <= comp[:, None] + 1e-9)
        cum = np.cumsum(np.where(ok, l_ord, 0), axis=1)
        stop = (cum < need[:, None]).sum(axis=1)
        if (stop >= cum.shape[1]).any() or \
                (cum[np.arange(len(self.tasks)), np.minimum(
                    stop, cum.shape[1] - 1)] < need).any():
            raise RuntimeError("deliveries do not cover L by t_complete")
        # row-range edges under each task's assign layout (all-None =
        # node order; all tasks of one dispatch share the layout source)
        if all(task.assign is None for task in self.tasks):
            starts_all = np.concatenate(
                [np.zeros((len(self.tasks), 1), dtype=np.int64),
                 np.cumsum(l_act, axis=1)[:, :-1]], axis=1)
        else:
            asg = np.stack([task.assign for task in self.tasks])[:, A]
            aorder = np.argsort(asg, axis=1, kind="stable")
            l_sorted = np.take_along_axis(l_act, aorder, axis=1)
            starts_sorted = np.concatenate(
                [np.zeros((len(self.tasks), 1), dtype=np.int64),
                 np.cumsum(l_sorted, axis=1)[:, :-1]], axis=1)
            starts_all = np.empty_like(starts_sorted)
            np.put_along_axis(starts_all, aorder, starts_sorted, axis=1)
        out = []
        for i in range(len(self.tasks)):
            sel = np.nonzero(ok[i, :stop[i] + 1])[0]
            picked = orders[i, sel]
            starts = starts_all[i, picked]
            out.append((A[picked], starts, starts + l_act[i, picked]))
        return out

    def _covering_one(self, task: BarrierTask) -> tuple:
        """Scalar fallback mirroring ``prefix_plan``'s selection math."""
        l_int = np.asarray(task.l_int, dtype=np.int64)
        active = np.nonzero(l_int > 0)[0]
        l_act = l_int[active]
        if task.assign is None:
            starts_act = np.concatenate(
                [[0], np.cumsum(l_act)[:-1]]).astype(np.int64)
        else:
            aorder = np.argsort(task.assign[active], kind="stable")
            starts_act = np.empty(active.size, dtype=np.int64)
            starts_act[aorder] = np.concatenate(
                [[0], np.cumsum(l_act[aorder])[:-1]])
        f_act = task.finish[active]
        order = np.argsort(np.where(np.isfinite(f_act), f_act, np.inf),
                           kind="stable")
        f_ord = f_act[order]
        ok = np.isfinite(f_ord) & (f_ord <= task.completion + 1e-9)
        cum = np.cumsum(np.where(ok, l_act[order], 0))
        stop = int(np.searchsorted(cum, task.need))
        if stop >= cum.size or cum[stop] < task.need:
            raise RuntimeError("deliveries do not cover L by t_complete")
        sel = np.nonzero(ok[:stop + 1])[0]
        picked = order[sel]
        starts = starts_act[picked]
        return active[picked], starts, starts + l_act[picked]

    def rows_dispatched(self) -> int:
        return int(sum(int(task.l_int.sum()) for task in self.tasks))

    def rows_delivered_by(self, t: float) -> float:
        F = np.stack([task.finish for task in self.tasks])
        l = np.stack([task.l_int.astype(np.float64) for task in self.tasks])
        return float(bk.delivered_by(F, l, np.full(len(self.tasks), t)).sum())
