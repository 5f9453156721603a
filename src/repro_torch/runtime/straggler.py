"""Non-coded straggler-mitigation baselines the paper compares against:
replication / backup tasks ([7], [8]) and deadline-based cancellation
([13]'s cancellation idea).  Used by tests and the ablation benchmark to
show where coding wins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["DeadlinePolicy", "BackupTaskPolicy"]


@dataclasses.dataclass
class DeadlinePolicy:
    """Launch the task everywhere; cancel once the needed rows arrived (the
    paper's 'cancellation' reference behaviour).  Wasted work = rows still
    running at completion."""
    def completion(self, delays: np.ndarray, loads: np.ndarray,
                   need: float) -> Tuple[float, float]:
        order = np.argsort(delays)
        acc = np.cumsum(loads[order])
        i = int(np.searchsorted(acc, need - 1e-9))
        if i >= len(order):
            return np.inf, 0.0
        t = delays[order[i]]
        wasted = float(loads[order[i + 1:]].sum())
        return float(t), wasted


@dataclasses.dataclass
class BackupTaskPolicy:
    """Redundancy-d replication: each unit task replicated on d workers,
    completion = d-th fastest replica per unit (matches [7]'s model at the
    granularity of whole shards)."""
    d: int = 2

    def completion(self, delays: np.ndarray) -> float:
        """delays: (n_tasks, d) replica delays → overall completion."""
        per_task = delays.min(axis=1)
        return float(per_task.max())
