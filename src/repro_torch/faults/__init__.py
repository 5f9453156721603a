"""``repro.faults`` — deterministic fault injection + quarantine ledger.

The paper's redundancy argument is usually read as straggler tolerance:
any L of the L̃ coded rows reconstruct the product.  The same surplus is
an *integrity* budget — decode x̂ from a covering prefix of L delivered
rows, and every extra delivered row r is a parity check

    resid_r = y_r − G[r] · x̂            (≈ 0 for an honest worker)

whose violation localises the faulty worker.  This module supplies the
chaos half of that story; the detection/recovery half lives in
:func:`repro.stream.backend.verify_decode` and the serving bridge.

Determinism.  Fault draws must not perturb the simulator's delay
randomness (the fault-free-schedule serve must stay bit-identical to a
``faults=None`` serve), so every draw comes from its own hash-seeded
generator keyed on ``(seed, salt, dispatch, worker)`` — stateless,
order-independent, replayable.  ``FaultSchedule`` resolves a
:class:`FaultConfig` into per-(dispatch, worker) fault kinds; the
injectors (bridge / engine) apply them at the timing or product layer.

Fault taxonomy
--------------

==============  ==========================================================
kind            effect at injection site
==============  ==========================================================
``crash``       worker dies mid-task: undelivered shards lost, worker
                offline until backoff readmission (vs. a *graceful*
                ``leave``, which is scheduled and permanent)
``drop``        one dispatch's shard delivery is lost in transit
                (worker stays up; timing-only, data never corrupted)
``duplicate``   shard delivered twice; receiver-side dedupe ignores the
                copy (counted, numerically inert)
``stale``       delivery delayed by ``stale_factor`` × the remaining
                transit time — correct bytes, reordered arrival
``bit_flip``    Byzantine: one mantissa bit of every returned product
                value flips (large relative error)
``scaled``      Byzantine: returned products scaled by ``1 + eps``
                (small relative error — the adversarial detection case)
``sign_flip``   Byzantine: returned products negated
==============  ==========================================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS", "DELIVERY_FAULTS", "CORRUPTION_FAULTS",
    "FaultEvent", "FaultConfig", "FaultSchedule", "QuarantineLedger",
    "corrupt_products", "parse_fault_spec",
]

DELIVERY_FAULTS = ("crash", "drop", "duplicate", "stale")
CORRUPTION_FAULTS = ("bit_flip", "scaled", "sign_flip")
FAULT_KINDS = DELIVERY_FAULTS + CORRUPTION_FAULTS

_SALT = 0xFA017


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One explicit injection: worker ``worker`` misbehaves as ``kind``
    on dispatch number ``dispatch`` (the injector's monotone counter)."""
    dispatch: int
    worker: int
    kind: str

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {sorted(FAULT_KINDS)}")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded chaos policy + the detect/quarantine/retry knobs.

    Rates are per-(dispatch, worker) Bernoulli probabilities, resolved
    deterministically by :class:`FaultSchedule`; an explicit ``trace`` of
    :class:`FaultEvent`\\ s is injected unconditionally on top.

    ``corrupt_eps`` drives the ``scaled`` kind (relative perturbation).
    ``surplus_rows`` is how many delivered-beyond-the-prefix rows the
    detector residual-checks per task; ``residual_tol`` is the relative
    residual above which a row is flagged (it must sit above the float32
    encode noise of the jax tail — see the bridge's verify tolerances).
    ``retry_budget`` bounds per-step re-dispatches after an
    unrecoverable detection; past it the step degrades to an LS decode
    on the verified row subset instead of silently wrong logits.
    Quarantine readmission backs off exponentially:
    ``backoff_base × backoff_factor**(offenses − 1)`` sim-time units.
    """
    seed: int = 0
    crash_rate: float = 0.0
    drop_rate: float = 0.0
    duplicate_rate: float = 0.0
    stale_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_kind: str = "bit_flip"
    corrupt_eps: float = 1e-3
    stale_factor: float = 4.0
    trace: Tuple[FaultEvent, ...] = ()
    detect: bool = True
    surplus_rows: int = 8
    residual_tol: float = 1e-4
    retry_budget: int = 2
    backoff_base: float = 2000.0
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.corrupt_kind not in CORRUPTION_FAULTS:
            raise ValueError(f"corrupt_kind must be one of "
                             f"{CORRUPTION_FAULTS}, got {self.corrupt_kind!r}")
        for name in ("crash_rate", "drop_rate", "duplicate_rate",
                     "stale_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    @property
    def active(self) -> bool:
        """Whether any injection can ever fire (detection may still run)."""
        return bool(self.trace) or any(
            getattr(self, f"{k}_rate") > 0
            for k in ("crash", "drop", "duplicate", "stale", "corrupt"))

    def schedule(self) -> "FaultSchedule":
        return FaultSchedule(self)


class FaultSchedule:
    """Resolved, stateless fault draws for a :class:`FaultConfig`.

    ``faults_at(dispatch, workers)`` maps each worker to at most one
    fault kind for that dispatch.  Draws are independent per
    (dispatch, worker) and never consume shared RNG state, so two runs
    with the same config agree regardless of event interleaving, and a
    zero-rate schedule is observationally identical to no schedule.
    Precedence when several rates fire on one draw:
    crash > corruption > drop > stale > duplicate.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self._trace: Dict[Tuple[int, int], str] = {
            (ev.dispatch, ev.worker): ev.kind for ev in config.trace}
        # (kind, rate) checks in precedence order, zero rates pre-dropped
        self._checks: List[Tuple[str, float]] = [
            (k, r) for k, r in (
                ("crash", config.crash_rate),
                (config.corrupt_kind, config.corrupt_rate),
                ("drop", config.drop_rate),
                ("stale", config.stale_rate),
                ("duplicate", config.duplicate_rate),
            ) if r > 0.0]

    def fault_at(self, dispatch: int, worker: int) -> Optional[str]:
        kind = self._trace.get((int(dispatch), int(worker)))
        if kind is not None:
            return kind
        if not self._checks:
            return None
        u = np.random.default_rng(
            (self.config.seed, _SALT, int(dispatch), int(worker))
        ).random(len(self._checks))
        for i, (kind, rate) in enumerate(self._checks):
            if u[i] < rate:
                return kind
        return None

    def faults_at(self, dispatch: int,
                  workers: Iterable[int]) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for w in workers:
            kind = self.fault_at(dispatch, w)
            if kind is not None:
                out[int(w)] = kind
        return out

    def crash_events(self, workers: Sequence[int], horizon: float,
                     mean_interval: float):
        """Pre-generated crash :class:`~repro.stream.events.WorkerEvent`\\ s
        for the streaming engine: per worker, a hash-seeded Poisson clock
        of rate ``crash_rate / mean_interval`` over ``[0, horizon)``.
        Each crash carries its backoff readmission as a paired ``join``
        so the engine's churn loop replays recovery deterministically."""
        from ..stream.events import WorkerEvent
        cfg = self.config
        out: List[WorkerEvent] = []
        if cfg.crash_rate <= 0 or not math.isfinite(horizon):
            return out
        rate = cfg.crash_rate / max(mean_interval, 1e-300)
        for w in workers:
            rng = np.random.default_rng((cfg.seed, _SALT, 0xC4A5, int(w)))
            t, offenses = 0.0, 0
            while True:
                t += rng.exponential(1.0 / rate)
                if t >= horizon:
                    break
                offenses += 1
                back = cfg.backoff_base * cfg.backoff_factor ** (offenses - 1)
                out.append(WorkerEvent(time=t, worker=int(w), kind="crash"))
                out.append(WorkerEvent(time=t + back, worker=int(w),
                                       kind="join"))
                t += back
        out.sort(key=lambda e: e.time)
        return out


def corrupt_products(y: np.ndarray, kind: str, *,
                     eps: float = 1e-3) -> np.ndarray:
    """Apply a Byzantine corruption to a worker's returned products.

    Deterministic and elementwise — the same rows corrupt the same way
    wherever they are recomputed (the localisation sweep re-derives a
    suspect's products and must see identical bytes).
    """
    y = np.asarray(y)
    if kind == "bit_flip":
        u = y.view(np.uint64) if y.dtype == np.float64 else y
        if y.dtype == np.float64:
            out = (u ^ np.uint64(1 << 51)).view(np.float64)
        else:                                   # pragma: no cover - float32
            out = (y.view(np.uint32) ^ np.uint32(1 << 22)).view(np.float32)
        return out.copy()
    if kind == "scaled":
        return y * (1.0 + eps)
    if kind == "sign_flip":
        return -y
    raise ValueError(f"unknown corruption kind {kind!r}")


class QuarantineLedger:
    """Flagged-worker ledger with exponential-backoff readmission.

    A detection flags a worker: it is quarantined (the caller masks it
    from the share pool exactly like a ``leave``) until
    ``t + backoff_base × backoff_factor**(offenses−1)``; repeat
    offenders back off geometrically.  ``note_critical`` accumulates
    the tracer's critical-worker attribution as a *suspect score* —
    detection's localisation sweep tries high-suspicion workers first,
    so a straggling-and-corrupt worker is confirmed in one decode.
    """

    def __init__(self, *, backoff_base: float = 2000.0,
                 backoff_factor: float = 2.0):
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.offenses: Dict[int, int] = {}
        self.readmit_at: Dict[int, float] = {}
        self.suspect: Dict[int, float] = {}
        self.quarantines = 0
        self.readmissions = 0

    def flag(self, worker: int, t: float) -> float:
        """Quarantine ``worker`` at sim time ``t``; returns the
        readmission time."""
        w = int(worker)
        self.offenses[w] = self.offenses.get(w, 0) + 1
        back = self.backoff_base * \
            self.backoff_factor ** (self.offenses[w] - 1)
        self.readmit_at[w] = t + back
        self.suspect[w] = self.suspect.get(w, 0.0) + 1.0
        self.quarantines += 1
        return self.readmit_at[w]

    def readmit(self, worker: int) -> None:
        self.readmit_at.pop(int(worker), None)
        self.readmissions += 1

    def is_quarantined(self, worker: int, t: float) -> bool:
        until = self.readmit_at.get(int(worker))
        return until is not None and t < until

    def quarantined(self, t: float) -> List[int]:
        return sorted(w for w, until in self.readmit_at.items()
                      if t < until)

    def note_critical(self, worker: int, weight: float = 0.1) -> None:
        """Straggler-attribution prior: a repeatedly-critical worker is
        suspicious before it is ever caught corrupting."""
        w = int(worker)
        if w > 0:
            self.suspect[w] = self.suspect.get(w, 0.0) + float(weight)

    def suspects_first(self, workers: Iterable[int]) -> List[int]:
        """Candidate ordering for the localisation sweep: most-suspect
        first, ties by worker id (deterministic)."""
        return sorted((int(w) for w in workers),
                      key=lambda w: (-self.suspect.get(w, 0.0), w))


def parse_fault_spec(spec: str) -> FaultConfig:
    """Build a :class:`FaultConfig` from a CLI spec string.

    ``"corrupt=0.3,kind=sign_flip,seed=3"`` →
    ``FaultConfig(corrupt_rate=0.3, corrupt_kind="sign_flip", seed=3)``.
    Keys: crash / drop / duplicate / stale / corrupt (rates), kind,
    seed, surplus, retries, tol, backoff.  An empty spec ("" or
    "none") means a zero-rate config with detection on — the
    fault-free-schedule identity case.
    """
    cfg: Dict[str, object] = {}
    spec = (spec or "").strip()
    if spec and spec != "none":
        for part in spec.split(","):
            key, _, val = part.partition("=")
            key = key.strip()
            val = val.strip()
            if key in ("crash", "drop", "duplicate", "stale", "corrupt"):
                cfg[f"{key}_rate"] = float(val)
            elif key == "kind":
                cfg["corrupt_kind"] = val
            elif key == "seed":
                cfg["seed"] = int(val)
            elif key == "surplus":
                cfg["surplus_rows"] = int(val)
            elif key == "retries":
                cfg["retry_budget"] = int(val)
            elif key == "tol":
                cfg["residual_tol"] = float(val)
            elif key == "backoff":
                cfg["backoff_base"] = float(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r} in {spec!r}")
    return FaultConfig(**cfg)
