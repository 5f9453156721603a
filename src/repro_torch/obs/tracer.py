"""Zero-dependency span tracer for the streaming / serving stack.

The paper's objective is the delay of the *slowest* task; aggregates
(``StreamMetrics.summary()``, ``ServeReport``) say how slow, not *why*.
``Tracer`` records the why: spans (named intervals with a category and a
track), instants, and counters, in **two time domains side by side**:

* ``wall`` tracks — seconds from ``time.perf_counter``, relative to the
  tracer's epoch.  Real planning / packing / kernel / decode cost.
* ``sim`` tracks — the engine's simulated time units (milliseconds in the
  default delay model).  Queue waits, per-worker shard deliveries, barrier
  completions.

Tracks are strings ``"wall"``, ``"sim"``, or ``"<domain>:<lane>"``
(``"sim:worker3"``) — lanes become Chrome-trace threads inside the domain's
process, so Perfetto shows the two clocks as two process groups.

Overhead contract: a *disabled* tracer (``enabled=False``) must be
indistinguishable from no tracer.  Instrumented code normalises
``tracer if tracer is not None and tracer.enabled else None`` once at entry
and guards every record with ``if tr is not None`` — the disabled path is
exactly the no-tracer path (one predicate at entry).  Deep call sites
(kernels, backend solves) consult the process-global :func:`current_tracer`,
which is ``None`` unless a caller installed an enabled tracer via
:func:`use_tracer` — again one global read + ``is None`` check when off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "current_tracer", "use_tracer", "STAGE_CATS",
]

# Leaf stage categories whose wall durations are expected to tile a serving
# step ("step" spans are their parents; coverage = sum(stages)/sum(steps)).
STAGE_CATS = ("plan", "pack", "kernel", "decode", "glue")


@dataclasses.dataclass
class Span:
    """One named interval.  ``t0``/``t1`` are in the track's time domain
    (wall: seconds since tracer epoch; sim: simulated time units)."""
    seq: int
    name: str
    cat: str
    track: str
    t0: float
    t1: float
    args: Optional[Dict[str, Any]] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Collects spans / instants / counters; exports Chrome traces,
    flat records and a BENCH-schema summary (see ``repro.obs.export``)."""

    def __init__(self, *, enabled: bool = True, jax_profiler: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.enabled = bool(enabled)
        # Annotate jitted regions with jax.profiler.TraceAnnotation so a
        # concurrently-captured device profile lines up with our spans.
        self.jax_profiler = bool(jax_profiler)
        self.meta: Dict[str, Any] = dict(meta or {})
        self.epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.instants: List[Span] = []          # t1 == t0
        self.counters: Dict[str, float] = {}    # running totals
        self.gauge_peaks: Dict[str, float] = {}  # max level per gauge
        self.counter_samples: List[Tuple[str, str, float, float]] = []
        self._seq = 0

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Wall seconds since this tracer's epoch."""
        return time.perf_counter() - self.epoch

    # -- recording -----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def add_span(self, name: str, t0: float, t1: float, *, cat: str = "misc",
                 track: str = "sim",
                 args: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Record an interval with explicit endpoints (sim-time spans, or
        wall spans measured externally).  Non-finite endpoints are dropped —
        a lost delivery (finish = inf) has no extent to draw."""
        if not self.enabled:
            return None
        if not (t0 == t0 and t1 == t1 and t0 != float("inf")
                and t1 != float("inf") and t0 != float("-inf")
                and t1 != float("-inf")):
            return None
        if t1 < t0:
            t0, t1 = t1, t0
        sp = Span(self._next_seq(), name, cat, track, t0, t1, args)
        self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "misc", track: str = "wall",
             args: Optional[Dict[str, Any]] = None) -> Iterator[Dict[str, Any]]:
        """Wall-clock span context.  Yields the (mutable) args dict so the
        body can attach results discovered mid-span."""
        if not self.enabled:
            yield {}
            return
        a: Dict[str, Any] = dict(args) if args else {}
        t0 = self.now()
        try:
            yield a
        finally:
            t1 = self.now()
            self.spans.append(Span(self._next_seq(), name, cat, track,
                                   t0, t1, a or None))

    def instant(self, name: str, t: Optional[float] = None, *,
                cat: str = "event", track: str = "wall",
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        tt = self.now() if t is None else float(t)
        if tt != tt or tt in (float("inf"), float("-inf")):
            return
        self.instants.append(Span(self._next_seq(), name, cat, track,
                                  tt, tt, args))

    def count(self, name: str, delta: float = 1, *,
              t: Optional[float] = None, track: str = "wall") -> None:
        """Increment a running counter and record a sample of the new total
        (rendered as a Chrome ``"C"`` counter track)."""
        if not self.enabled:
            return
        total = self.counters.get(name, 0.0) + delta
        self.counters[name] = total
        tt = self.now() if t is None else float(t)
        if tt == tt and tt not in (float("inf"), float("-inf")):
            self.counter_samples.append((track, name, tt, total))

    def gauge(self, name: str, value: float, *,
              t: Optional[float] = None, track: str = "wall") -> None:
        """Record an instantaneous level (queue depth, pool shares).

        ``counters[name]`` holds the *last* level (the historical
        semantics); ``gauge_peaks[name]`` tracks the max — the summary
        surfaces it as ``{name}_peak`` so a gauge that naturally returns
        to zero (pool shares after the final release) is still visible
        in the rollup."""
        if not self.enabled:
            return
        self.counters[name] = float(value)
        prev = self.gauge_peaks.get(name)
        if prev is None or value > prev:
            self.gauge_peaks[name] = float(value)
        tt = self.now() if t is None else float(t)
        if tt == tt and tt not in (float("inf"), float("-inf")):
            self.counter_samples.append((track, name, tt, float(value)))

    # -- export (implemented in repro.obs.export) ----------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        from .export import to_chrome_trace
        return to_chrome_trace(self)

    def to_records(self) -> List[Dict[str, Any]]:
        from .export import to_records
        return to_records(self)

    def summary(self, top_k: int = 5) -> Dict[str, Any]:
        from .export import summary
        return summary(self, top_k=top_k)

    def write(self, path: str) -> str:
        from .export import write_trace
        return write_trace(self, path)


# -- process-global tracer (deep call sites: kernels, backend solves) --------

_ACTIVE: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    """The installed *enabled* tracer, or None.  Deep hot paths guard on
    ``tr = current_tracer(); if tr is not None: ...`` — one global read."""
    return _ACTIVE


@contextlib.contextmanager
def use_tracer(tracer: Optional[Tracer]) -> Iterator[Optional[Tracer]]:
    """Install ``tracer`` as the process-global tracer for the block.
    Disabled tracers normalise to None so the off path stays no-op."""
    global _ACTIVE
    tr = tracer if (tracer is not None and tracer.enabled) else None
    prev = _ACTIVE
    _ACTIVE = tr
    try:
        yield tr
    finally:
        _ACTIVE = prev
