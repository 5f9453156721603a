"""Exporters: Chrome/Perfetto trace JSON, flat records, BENCH-schema summary.

Chrome ``trace_event`` mapping (the JSON Array Format with a top-level
object, which Perfetto loads directly):

* every span is a complete event ``ph:"X"`` with ``ts``/``dur`` in
  microseconds;
* the two time domains become two *processes*: pid 1 = wall clock
  (``ts = seconds × 1e6``), pid 2 = sim time (``ts = sim-ms × 1e3``), so
  the sim timeline is readable in the same UI without pretending the two
  clocks are comparable;
* tracks (``"wall"``, ``"sim:worker3"``) become named threads via ``"M"``
  metadata events;
* counters are ``ph:"C"`` events on their domain's pid.

The exported object also carries ``repro_summary`` (the :func:`summary`
rollup) and ``repro_meta`` — Perfetto ignores unknown top-level keys, and
``repro.obs.validate`` / CI read them back.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from .tracer import STAGE_CATS, Span, Tracer

__all__ = ["to_chrome_trace", "to_records", "summary", "write_trace"]

_PIDS = {"wall": 1, "sim": 2}
_PID_NAMES = {1: "wall-clock (s)", 2: "sim-time (ms)"}
# µs per unit of the domain's native clock (wall: s, sim: ms).
_TS_SCALE = {1: 1e6, 2: 1e3}


def _split_track(track: str) -> Tuple[int, str]:
    domain, _, lane = track.partition(":")
    return _PIDS.get(domain, 1), lane or "main"


class _TidMap:
    """Stable thread ids per (pid, lane), in first-appearance order."""

    def __init__(self) -> None:
        self._tids: Dict[Tuple[int, str], int] = {}

    def tid(self, pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in self._tids:
            self._tids[key] = 1 + sum(1 for p, _ in self._tids if p == pid)
        return self._tids[key]

    def metadata(self) -> List[Dict[str, Any]]:
        ev: List[Dict[str, Any]] = []
        for pid in sorted(set(p for p, _ in self._tids)):
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0,
                       "args": {"name": _PID_NAMES.get(pid, f"pid{pid}")}})
        for (pid, lane), tid in self._tids.items():
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "ts": 0, "args": {"name": lane}})
        return ev


def to_chrome_trace(tr: Tracer) -> Dict[str, Any]:
    tids = _TidMap()
    events: List[Dict[str, Any]] = []
    for sp in tr.spans:
        pid, lane = _split_track(sp.track)
        scale = _TS_SCALE[pid]
        ev: Dict[str, Any] = {
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": sp.t0 * scale, "dur": sp.dur * scale,
            "pid": pid, "tid": tids.tid(pid, lane),
        }
        if sp.args:
            ev["args"] = sp.args
        events.append(ev)
    for sp in tr.instants:
        pid, lane = _split_track(sp.track)
        ev = {"name": sp.name, "cat": sp.cat, "ph": "i", "s": "t",
              "ts": sp.t0 * _TS_SCALE[pid], "pid": pid,
              "tid": tids.tid(pid, lane)}
        if sp.args:
            ev["args"] = sp.args
        events.append(ev)
    for track, name, t, value in tr.counter_samples:
        pid, lane = _split_track(track)
        events.append({"name": name, "cat": "counter", "ph": "C",
                       "ts": t * _TS_SCALE[pid], "pid": pid,
                       "tid": tids.tid(pid, lane), "args": {name: value}})
    return {
        "traceEvents": tids.metadata() + events,
        "displayTimeUnit": "ms",
        "repro_meta": dict(tr.meta),
        "repro_summary": summary(tr),
    }


def to_records(tr: Tracer) -> List[Dict[str, Any]]:
    """Flat rows (one per span/instant) for ``pandas.DataFrame(records)``."""
    rows: List[Dict[str, Any]] = []
    for kind, pool in (("span", tr.spans), ("instant", tr.instants)):
        for sp in pool:
            row: Dict[str, Any] = {
                "kind": kind, "seq": sp.seq, "name": sp.name, "cat": sp.cat,
                "track": sp.track, "t0": sp.t0, "t1": sp.t1, "dur": sp.dur,
            }
            for k, v in (sp.args or {}).items():
                row[f"arg_{k}"] = v
            rows.append(row)
    rows.sort(key=lambda r: r["seq"])
    return rows


def _is_wall(sp: Span) -> bool:
    return _split_track(sp.track)[0] == 1


def summary(tr: Tracer, top_k: int = 5) -> Dict[str, Any]:
    """Roll spans into the BENCH schema.

    * ``per_stage_wall`` — wall seconds per leaf stage category
      (plan / pack / kernel / decode / glue);
    * ``step_wall_total`` / ``stage_coverage`` — parent "step" span total and
      the fraction of it the leaf stages account for (the acceptance
      criterion wants ≥ 0.9);
    * ``stragglers`` — top-k slowest sim-time delivery spans as
      (worker, task) attribution rows.
    """
    per_stage = {cat: 0.0 for cat in STAGE_CATS}
    step_total = 0.0
    deliveries: List[Span] = []
    for sp in tr.spans:
        if _is_wall(sp):
            if sp.cat in per_stage:
                per_stage[sp.cat] += sp.dur
            elif sp.cat == "step":
                step_total += sp.dur
        elif sp.cat == "delivery":
            deliveries.append(sp)
    stage_sum = sum(per_stage.values())
    deliveries.sort(key=lambda s: (-s.dur, s.seq))
    stragglers = []
    for sp in deliveries[:top_k]:
        a = sp.args or {}
        stragglers.append({
            "worker": a.get("worker"), "task": a.get("task"),
            "sim_duration": sp.dur, "t_finish": sp.t1,
            "critical": bool(a.get("critical", False)),
        })
    # gauges report last level in counters; surface the observed max as
    # `{name}_peak` so gauges that return to zero (pool shares after the
    # final release) still carry signal in the rollup
    counters = dict(tr.counters)
    counters.update({f"{k}_peak": v for k, v in tr.gauge_peaks.items()})
    return {
        "per_stage_wall": per_stage,
        "step_wall_total": step_total,
        "stage_wall_total": stage_sum,
        "stage_coverage": (stage_sum / step_total) if step_total > 0 else None,
        "counters": counters,
        "stragglers": stragglers,
        "span_count": len(tr.spans),
    }


def write_trace(tr: Tracer, path: str) -> str:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(tr), fh)
    return path
