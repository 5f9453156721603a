"""Heterogeneous shard planning — the paper's Theorem 1 applied to device
groups (DESIGN.md §2.3).

A TPU fleet is rarely uniform: mixed generations across pods, degraded
hosts, or DCN-distant pod groups.  Given per-group throughput profiles
(exactly the paper's (a, u, γ) triples at pod granularity), the planner:

* ``hetero_split`` — unequal data-parallel shard sizes ∝ 1/θ (Theorem 1),
  rounded to whole examples while preserving the global batch;
* ``replan_on_failure`` — elastic re-plan over the surviving groups (the
  paper's load re-allocation when Ω changes);
* ``coded_batch_plan`` — with MDS-coded gradient aggregation enabled, adds
  the Theorem-1 redundancy so the step completes from any prefix of groups
  whose loads sum to the required batch (straggler tolerance without
  re-execution).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.allocation import markov_loads
from ..sim.cluster import ClusterProfile

__all__ = ["hetero_split", "replan_on_failure", "coded_batch_plan",
           "coded_row_shards", "rescaled_row_shards"]


def _theta_of_profile(profile: ClusterProfile) -> np.ndarray:
    return np.array([profile.classes[c].unit_delay for c in profile.members])


def _largest_remainder_round(loads: np.ndarray, total: int) -> np.ndarray:
    """Round non-negative loads to integers summing to ``total``."""
    scaled = loads / loads.sum() * total
    base = np.floor(scaled).astype(int)
    rem = total - base.sum()
    order = np.argsort(-(scaled - base))
    base[order[:rem]] += 1
    return base


def coded_row_shards(l_row: np.ndarray, L: int) -> np.ndarray:
    """Integer per-node coded-row shard sizes from a fractional load row.

    This is the heterogeneous split applied to one master's Theorem-1/3
    load allocation ``l_row`` (node axis, column 0 = local): every positive
    load is ceiled (the paper drops integrality in (7c); rounding up only
    grows the redundancy, so recovery from any prefix covering ``L`` stays
    safe), and if share down-scaling left the rounded total below ``L`` the
    deficit is topped up by largest remainder over the participating nodes.
    """
    l_row = np.asarray(l_row, dtype=np.float64)
    shards = np.where(l_row > 0, np.ceil(l_row - 1e-9), 0.0).astype(np.int64)
    deficit = int(L) - int(shards.sum())
    if deficit > 0:
        active = np.nonzero(shards > 0)[0]
        if active.size == 0:
            raise ValueError("no participating nodes to cover L")
        top_up = _largest_remainder_round(l_row[active], deficit)
        shards[active] += top_up
    return shards


def rescaled_row_shards(l_row: np.ndarray, L_plan: float,
                        L_mat: int) -> np.ndarray:
    """Shard an ``L_mat``-row coded matrix by a load row planned for
    ``L_plan`` rows.

    The serving planner solves one Scenario (L = the padded vocabulary,
    the output head's row count), but per-layer coding distributes many
    weight matrices of different heights (d_ff, d_model, n_heads×d_head).
    The Theorem-1/3 load row fixes the per-worker *proportions* and the
    redundancy ratio — both scale-free (Kim et al. 2019's heterogeneous
    allocation is per unit row) — so a matrix of ``L_mat`` rows reuses the
    row scaled by ``L_mat / L_plan`` and integerised the usual way.
    """
    l_row = np.asarray(l_row, dtype=np.float64)
    if L_plan <= 0:
        raise ValueError("L_plan must be positive")
    return coded_row_shards(l_row * (float(L_mat) / float(L_plan)),
                            int(L_mat))


def hetero_split(profile: ClusterProfile, global_batch: int) -> np.ndarray:
    """Per-group batch shard sizes ∝ 1/θ (Theorem 1 without redundancy)."""
    theta = _theta_of_profile(profile)
    inv = 1.0 / theta
    return _largest_remainder_round(inv, global_batch)


def coded_batch_plan(profile: ClusterProfile, global_batch: int,
                     ) -> Tuple[np.ndarray, float]:
    """Theorem-1 loads *with* redundancy for coded gradient aggregation.

    Returns (integer per-group loads summing to ≈2×global_batch, predicted
    completion t* in the profile's time unit).  Any subset of groups whose
    loads reach ``global_batch`` reconstructs the full-batch gradient
    (k-of-n MDS property)."""
    theta = _theta_of_profile(profile)[None, :]   # single "master"
    l, t = markov_loads(np.array([float(global_batch)]), theta)
    total = int(round(l.sum()))
    return _largest_remainder_round(l[0], total), float(t[0])


def replan_on_failure(profile: ClusterProfile, global_batch: int,
                      failed: Sequence[int]) -> Tuple[ClusterProfile, np.ndarray]:
    """Drop failed groups, re-solve the split over survivors."""
    keep = [i for i in range(profile.N) if i not in set(failed)]
    if not keep:
        raise RuntimeError("no surviving worker groups")
    new_profile = dataclasses.replace(
        profile, members=tuple(profile.members[i] for i in keep))
    return new_profile, hetero_split(new_profile, global_batch)
