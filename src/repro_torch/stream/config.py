"""Unified construction surface for the streaming subsystem.

``StreamingExecutor`` historically grew one keyword argument per feature
(admission, replan, backend, numerics, straggler injection, ...).  The
canonical construction path is now a single frozen :class:`StreamConfig`
composed of the three policy objects that already existed —
``AdmissionConfig`` (who gets in), ``ReplanPolicy`` (when to re-optimise)
— plus a new :class:`BackendConfig` bundling the numerics/runtime knobs:

    from repro.stream import StreamConfig, StreamingExecutor
    ex = StreamingExecutor(sc, config=StreamConfig(policy="fractional"))

The legacy kwargs still work (``StreamingExecutor(sc, policy=...,
backend=...)``) but emit a ``DeprecationWarning``; passing both ``config``
and a legacy kwarg is an error.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .queueing import AdmissionConfig
from .replan import ReplanPolicy

__all__ = ["BackendConfig", "StreamConfig"]

_PLAN_POLICIES = ("dedicated", "fractional", "uncoded")
_NUMERICS = ("none", "verify")
_BACKENDS = ("numpy", "jax", "pallas")


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Numerics/runtime knobs of the streaming engine.

    backend:          array backend for batched completion/decode numerics
                      ("numpy" | "jax" | "pallas").
    numerics:         "none" (timing only) or "verify" (encode/decode a
                      real matrix for ``verify_cols`` columns per task).
    verify_cols:      columns checked per task when numerics="verify".
    straggle_p:       per-(task, worker) probability of a heavy-tail
                      delivery (delay × straggle_factor).
    straggle_factor:  the heavy-tail multiplier.
    event_batch:      max events drained per heap inspection in the
                      vectorised loop; 1 reproduces the historical
                      one-pop-at-a-time loop exactly (it *is* that loop).
    keep_records:     keep per-task ``TaskRecord`` objects (needed by
                      ``to_records``/verification).  False switches
                      ``StreamMetrics`` to compact scalar arrays — required
                      at fleet scale (1e6 records ≈ 1 GB of dataclasses).
    """
    backend: str = "numpy"
    numerics: str = "none"
    verify_cols: int = 4
    straggle_p: float = 0.0
    straggle_factor: float = 8.0
    event_batch: int = 64
    keep_records: bool = True

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.numerics not in _NUMERICS:
            raise ValueError(f"unknown numerics mode {self.numerics!r}")
        if self.event_batch < 1:
            raise ValueError("event_batch must be >= 1")
        if self.numerics == "verify" and not self.keep_records:
            raise ValueError("numerics='verify' requires keep_records=True")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Everything ``StreamingExecutor`` needs beyond the scenario + sources.

    policy:     planning stack ("dedicated" | "fractional" | "uncoded").
    replan:     :class:`~repro.stream.replan.ReplanPolicy` (None = default,
                i.e. incremental repair on every pool change).
    admission:  :class:`~repro.stream.queueing.AdmissionConfig`.
    backend:    :class:`BackendConfig`.
    rng:        integer seed for the planner + delay streams.
    """
    policy: str = "fractional"
    replan: Optional[ReplanPolicy] = None
    admission: Optional[AdmissionConfig] = None
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    rng: int = 0

    def __post_init__(self):
        if self.policy not in _PLAN_POLICIES:
            raise ValueError(f"unknown planning policy {self.policy!r}")

    # -- legacy kwargs bridge -------------------------------------------------

    _LEGACY_KEYS = ("policy", "replan", "admission", "numerics",
                    "verify_cols", "rng", "backend", "straggle_p",
                    "straggle_factor")

    @classmethod
    def from_legacy_kwargs(cls, **kw) -> "StreamConfig":
        """Build a config from ``StreamingExecutor``'s historical kwargs."""
        unknown = set(kw) - set(cls._LEGACY_KEYS)
        if unknown:
            raise TypeError(
                f"unexpected keyword argument(s) {sorted(unknown)}")
        backend = BackendConfig(
            backend=kw.get("backend", "numpy"),
            numerics=kw.get("numerics", "none"),
            verify_cols=kw.get("verify_cols", 4),
            straggle_p=kw.get("straggle_p", 0.0),
            straggle_factor=kw.get("straggle_factor", 8.0))
        return cls(policy=kw.get("policy", "fractional"),
                   replan=kw.get("replan"),
                   admission=kw.get("admission"),
                   backend=backend,
                   rng=kw.get("rng", 0))
