"""Persistent step-plan cache: amortise per-step planning across a serve.

At steady state every serving step of a given dispatch width ``m`` asks
the exact same questions: the planner's row is unchanged, so the scaled
shares, the integer shard splits per matmul, the expected-delay row
assignment, the covering-prefix structures, the ragged-shard packing and
the stacked decode factorizations are all pure functions of
``(scenario, plan row, m)``.  Only the *realized* delays differ step to
step — and those are exact under MDS coding for any covering prefix, so
reusing the frozen structures changes no decoded value.

:class:`StepPlanCache` keys frozen :class:`StepPlan` entries by
``(scenario-context bytes, m, k_row, b_row)`` and stamps each with the
cache *epoch*.  Churn and drift replans bump the epoch and clear the
table (``invalidate``), so an in-flight step that dispatched before the
event detects its entry is stale (:meth:`is_current`) and rebuilds its
execution structures from the retimed barrier instead of trusting the
frozen ones.

The tracer counters ``plan_cache_hits`` / ``plan_cache_misses`` /
``plan_cache_invalidations`` make the steady state observable: a
churn-free serve must be all hits after the first step per width.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import current_tracer

__all__ = ["StepPlan", "StepPlanCache"]


@dataclasses.dataclass
class StepPlan:
    """Frozen per-(plan row, m) planning state for a barrier step.

    ``l_ints``/``assign`` are computed at first use (the cache miss) and
    never mutated afterwards — barrier tasks hold row *views* into them.
    ``plans``/``stages`` are filled lazily by whichever execution engine
    runs first and reused by every later step while the entry is current.

    Parity metadata: each frozen ``PrefixPlan`` carries the packed
    threefry counters (``parity_ctrs`` — row index | redraw << 24) of its
    parity rows, stamped at plan time.  That is the *complete* seed
    schedule virtual-parity execution needs — replaying a frozen plan
    re-derives identical parity rows from the counters alone, with no
    encoded-row cache and no dependence on the layer's growth history
    (the counter derivation is what makes these entries safely
    freezable).  :meth:`parity_ctrs` collects them per task.
    """
    keys: List[str]
    l_ints: np.ndarray                 # (T, N+1) int64 shard splits
    assign: np.ndarray                 # (T, N+1) expected-delay row ranks
    epoch: int
    plans: Optional[Dict[str, Any]] = None      # name -> PrefixPlan
    stages: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)                   # stage key -> PackedStage

    def parity_ctrs(self) -> Dict[str, np.ndarray]:
        """Per-task packed parity-row counters frozen into this entry
        (tasks whose covering prefix used no parity rows are omitted)."""
        if not self.plans:
            return {}
        return {name: p.parity_ctrs for name, p in self.plans.items()
                if getattr(p, "parity_ctrs", None) is not None}


class StepPlanCache:
    """LRU table of :class:`StepPlan` entries, epoch-invalidated.

    The key folds in a caller-provided *context* (the effective-scenario
    bytes): a degrade event changes the closed-form loads without
    necessarily changing the plan row, and a later serve on the same
    bridge resets the scenario — both must miss rather than resurrect a
    stale split.
    """

    def __init__(self, maxsize: int = 32):
        self.maxsize = int(maxsize)
        self._entries: "OrderedDict[bytes, StepPlan]" = OrderedDict()
        self._ctx: bytes = b""
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.invalidations_by_reason: Dict[str, int] = {}

    def set_context(self, ctx: bytes) -> None:
        """Fold scenario-dependent bytes into every subsequent key."""
        self._ctx = bytes(ctx)

    def _key(self, m: int, k_row: np.ndarray, b_row: np.ndarray) -> bytes:
        return (self._ctx + m.to_bytes(4, "little")
                + k_row.tobytes() + b_row.tobytes())

    def lookup(self, m: int, k_row: np.ndarray,
               b_row: np.ndarray) -> Optional[StepPlan]:
        entry = self._entries.get(self._key(m, k_row, b_row))
        tr = current_tracer()
        if entry is None:
            self.misses += 1
            if tr is not None:
                tr.count("plan_cache_misses")
            return None
        self.hits += 1
        if tr is not None:
            tr.count("plan_cache_hits")
        self._entries.move_to_end(self._key(m, k_row, b_row))
        return entry

    def store(self, m: int, k_row: np.ndarray, b_row: np.ndarray,
              entry: StepPlan) -> StepPlan:
        self._entries[self._key(m, k_row, b_row)] = entry
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return entry

    def invalidate(self, reason: str = "") -> None:
        """Drop every entry and bump the epoch (stale-entry detection)."""
        self._entries.clear()
        self.epoch += 1
        self.invalidations += 1
        r = reason or "manual"
        self.invalidations_by_reason[r] = \
            self.invalidations_by_reason.get(r, 0) + 1
        tr = current_tracer()
        if tr is not None:
            tr.count("plan_cache_invalidations")
            tr.instant(f"plan_cache_invalidate:{reason or 'manual'}",
                       cat="plan")

    def is_current(self, entry: Optional[StepPlan]) -> bool:
        return entry is not None and entry.epoch == self.epoch
