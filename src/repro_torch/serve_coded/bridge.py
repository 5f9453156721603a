"""The coded serving bridge: StreamingExecutor planning as the live
admission/batching policy of the real inference server — the port of
``repro.serve_coded.bridge``.

The scheduling, planning, fault layer and reporting are the reference's;
the model runs as torch on ``device`` (default ``cuda``) and the coded
numerics run on ``backend="numpy"`` (float64 host, the exact reference) or
``"torch"`` (the port's kernels + float64 ``torch.linalg`` decode).  Every
coding scope is served: ``"head"`` runs the torch model's trunk on
``device``; ``"ffn"`` and ``"trunk"`` replay the trunk in float64 on the
host (:class:`~repro_torch.serve_coded.trunk.HostTrunk`) with its matmuls
routed through the coded layers — on the card with ``backend="torch"``
and ``device_products``.

``launch/serve.py`` runs prefill → continuous-batched decode;
``repro_torch.stream`` plans coded matrix products over shared heterogeneous
workers.  This module welds them together: every token batch the server
generates is a set of the paper's coded tasks, scheduled by the *same*
machinery the streaming engine uses —

* the :class:`~repro_torch.stream.replan.OnlinePlanner` supplies the (k, b, l)
  plan for the current pool (churn-aware, SCA-warm-started);
* the :class:`~repro_torch.stream.queueing.SharePool` ledger holds the paper's
  column-sum ≤ 1 constraint across masters' concurrent steps;
* a pluggable :class:`~repro_torch.stream.queueing.AdmissionPolicy`
  ("fifo" | "edf" | "fair") decides which waiting requests join a batch
  when slots free up, and (fair policy) caps a step's admitted shares at
  the max-min fair entitlement;
* :func:`repro_torch.parallel.hetero.coded_row_shards` /
  ``rescaled_row_shards`` turn the fractional plan row into integer
  per-worker shard sizes for each coded weight matrix;
* a :class:`~repro_torch.serve_coded.coded_linear.CodedLinear` per in-scope
  matmul physically executes each arrived shard's product and decodes the
  exact output from the earliest prefix covering its L rows.

**Coding scope.**  ``coding_scope="head"`` (the historical bridge) runs
the jitted trunk locally and codes only the output-head product.
``"ffn"`` re-executes the trunk on the host (:class:`HostTrunk`) and
additionally codes every FFN up/gate/down projection; ``"trunk"`` codes
the attention q/k/v/o projections too — the paper's assumption that the
*entire* matmul workload of a master is MDS-encoded across the shared
workers.  One serving step is then a *multi-task dispatch*: all in-scope
matmuls share one admission (one (k, b) acquisition, one queue cycle) and
complete through a :class:`~repro_torch.stream.barrier.StepBarrier` at the max
of the per-task earliest-prefix times.

**Batched dispatch.**  ``steps_per_dispatch`` generates up to that many
sequential decode tokens per admission: the per-matmul row shards (the
workers' encoded weights) are shipped once and the extra token columns
ride the same deliveries, amortizing encode/queue overhead — the paper's
task is A·x per column; the row allocation (what the delay model loads)
is column-count-free.

**Churn.**  Worker leave/degrade/restore re-times every in-flight step's
per-layer tasks through the stream engine's own re-timing arithmetic
(:func:`~repro_torch.stream.barrier.churn_finish_update`), re-scheduling the
step's completion event under a fresh version (stale completions are
dropped, as in the engine).  A step that can no longer cover some
matrix's rows re-dispatches its *timing* on the post-churn plan — the
already-decoded tokens are provably unchanged (MDS decode is exact for
any covering prefix), only when they land moves.

Time model: request arrivals, worker delays and deadlines live in
*simulation* milliseconds (sampled from the paper's shifted-exponential /
exponential model via the stream backend); the model forwards and shard
matmuls are real computations timed separately in wall-clock seconds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import itertools
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..faults import FaultConfig, QuarantineLedger, corrupt_products
from ..obs import STAGE_CATS, Tracer, current_tracer, use_tracer
from ..parallel.hetero import coded_row_shards, rescaled_row_shards
from ..sim.cluster import ClusterProfile, ec2_cluster
from ..stream import backend as bk
from ..stream.barrier import BarrierTask, StepBarrier
from ..stream.events import WorkerEvent
from ..stream.metrics import StreamMetrics, TaskRecord
from ..stream.queueing import (AdmissionConfig, SharePool, fair_demand_rows,
                               make_admission_policy, scale_shares)
from ..stream.config import StreamConfig
from ..stream.replan import OnlinePlanner, ReplanPolicy, scaled_row_loads
from .coded_linear import CodedLMHead
from .coded_linear import (DECODE_ENGINE, CodedLinear, prefix_plan_batch,
                           shard_products, surplus_plan)
from .packing import (DeviceRowsDecode, PackedShards, PackedStage,
                      ShardProblem, device_verify_residuals)
from .plan_cache import StepPlan, StepPlanCache
from .requests import ServeRequest
from .trunk import HostTrunk, trunk_matmul_keys

__all__ = ["CodedServingBridge", "ServeReport", "default_pool",
           "CODING_SCOPES", "EXECUTION_MODES"]

_ARRIVE, _CHURN, _STEP, _RETRY = "arrive", "churn", "step", "retry"


def _scenario_ctx(sc) -> bytes:
    """Step-plan-cache context: the bytes the closed-form loads (and hence
    the shard splits and row assignment) depend on besides (m, k, b)."""
    return sc.a.tobytes() + sc.u.tobytes() + sc.gamma.tobytes()

CODING_SCOPES = ("head", "ffn", "trunk")
EXECUTION_MODES = ("serial", "batched")


def _fill_glue(tr, n0: int) -> None:
    """Backfill un-attributed wall time inside a just-closed step span.

    The parent ("step"-cat) span is ``tr.spans[-1]``; its leaves are the
    stage-cat wall spans recorded since index ``n0``.  The gaps between the
    merged leaf intervals, clamped to the parent's extent, become
    ``cat="glue"`` spans — the host forward math and bookkeeping between
    coded stages — so the stage categories tile the step and
    ``stage_coverage`` stays an honest ≈1 instead of silently shrinking as
    more of a step's time hides between instrumented calls."""
    if tr is None or not tr.spans:
        return
    parent = tr.spans[-1]
    ivs = sorted((max(s.t0, parent.t0), min(s.t1, parent.t1))
                 for s in tr.spans[n0:-1]
                 if s.track == "wall" and s.cat in STAGE_CATS)
    cur, n = parent.t0, 0
    for a, b in ivs:
        if b <= a:
            continue
        if a > cur:
            tr.add_span(f"glue:{parent.name}#{n}", cur, a, cat="glue",
                        track="wall", args={"step": parent.name})
            n += 1
        cur = max(cur, b)
    if parent.t1 > cur:
        tr.add_span(f"glue:{parent.name}#{n}", cur, parent.t1, cat="glue",
                    track="wall", args={"step": parent.name})


class _BarrierExecutor:
    """Batched shard-execution engine for one step barrier.

    Built when the step is dispatched: every member task's covering prefix
    is planned up front (one batched delivery-order sort over the barrier,
    :meth:`~repro_torch.stream.barrier.StepBarrier.delivery_orders`), and each
    forward *stage* — the matmuls sharing a right-hand operand — executes
    as one packed product plus one stacked decode per row-count group
    (:class:`~repro_torch.serve_coded.packing.PackedStage`).  Packs and decode
    plans are X-independent and cached, so every token of a multi-token
    dispatch reuses them.

    With a *current* :class:`StepPlanCache` entry the whole structure is
    reused across steps: the first execution for a plan row freezes its
    prefix plans and packed stages into the entry, and every later step of
    the same width replays them — zero planning/packing wall time at
    steady state.  A stale entry (churn bumped the cache epoch after this
    step dispatched) is ignored and the retimed barrier is planned fresh.
    """

    def __init__(self, linears, barrier, *, backend: str,
                 device_products: bool = False,
                 product_dtype: torch.dtype = torch.float64, entry=None,
                 cache=None):
        self.linears = linears
        self.backend = backend
        self.device_products = bool(device_products)
        self.product_dtype = product_dtype
        self.used_solve = False
        self.solve_backends: set = set()   # decode engines actually run
        current = cache is not None and cache.is_current(entry)
        if current and entry.plans is not None:
            self.plans = entry.plans
            self._stages = entry.stages
            return
        tr = current_tracer()
        ctx = tr.span("plan:prefixes", cat="plan",
                      args={"tasks": len(barrier.tasks)}) \
            if tr is not None else contextlib.nullcontext()
        with ctx:
            # one stacked covering-selection pass over the whole barrier
            self.plans = prefix_plan_batch(linears, barrier)
        if current:
            entry.plans = self.plans
            self._stages = entry.stages
        else:
            self._stages = {}

    def stage(self, keys):
        kt = tuple(keys)
        memo = self._stages.get(kt)
        if memo is None:
            tr = current_tracer()
            ctx = tr.span("pack:stage", cat="pack",
                          args={"matmuls": len(kt)}) \
                if tr is not None else contextlib.nullcontext()
            with ctx:
                stg = PackedStage(
                    [ShardProblem(key=k, linear=self.linears[k],
                                  rows=self.plans[k].rows,
                                  used_solve=self.plans[k].used_solve)
                     for k in kt], backend=self.backend)
            # the solve flag is a pure function of the frozen plans —
            # memoise it with the stage rather than re-deriving per step
            memo = (stg, any(self.plans[k].used_solve for k in kt))
            self._stages[kt] = memo
        return memo

    def _corruptor(self, stg, marks: Dict[int, str], eps: float):
        """Byzantine-worker hook for :meth:`PackedStage.execute`: corrupt
        the marked workers' delivered rows inside the packed product
        buffer, attributed through the frozen prefix plans (the packed
        row ranges are ``stg.pack.offsets`` in ``stg.problems`` order)."""
        plans = self.plans

        def mutate(Y: np.ndarray) -> None:
            off = stg.pack.offsets
            for i, p in enumerate(stg.problems):
                rw = plans[p.key].row_workers()
                blk = Y[off[i]:off[i] + rw.size]
                for w, kind in marks.items():
                    msk = rw == w
                    if msk.any():
                        blk[msk] = corrupt_products(blk[msk], kind, eps=eps)
        return mutate

    def execute(self, items, *, marks=None,
                eps: float = 1e-3) -> Dict[str, np.ndarray]:
        """One stage: ``[(key, X), ...]`` sharing X → ``{key: out}``."""
        keys = [k for k, _ in items]
        assert all(X is items[0][1] for _, X in items), \
            "a stage's matmuls must share one right-hand operand"
        stg, solve_flag = self.stage(keys)
        outs = stg.execute(
            items[0][1], device_products=self.device_products,
            product_dtype=self.product_dtype,
            mutate=self._corruptor(stg, marks, eps) if marks else None)
        self.solve_backends.add(stg.solve_backend)
        self.used_solve |= solve_flag
        return outs


def default_pool(N: int = 8, n_fast: int = 2, seed: int = 0) -> ClusterProfile:
    """The demo pool: EC2-fitted heterogeneous workers, comm-delay aware."""
    return ec2_cluster(N=N, n_fast=n_fast, rng=seed, gamma_over_u=2.0)


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray
    gen_len: int
    tokens: List[int]
    pos: int = 0
    needs_prefill: bool = True


@dataclasses.dataclass
class _Step:
    k_row: np.ndarray
    b_row: np.ndarray
    barrier: StepBarrier
    t_start: float
    t_acquire: float              # last share acquisition (re-dispatch moves it)
    t_done: float
    version: int
    tok_by_slot: Dict[int, List[int]]
    rows_dispatched: int          # Σ shard rows over all (re-)dispatches
    rows_needed: float            # Σ per-task L over the dispatch's matmuls
    used_solve: bool
    max_err: float
    argmax_ok: int
    redispatches: int = 0
    stalled: bool = False         # lost coverage; holds no shares, retried
    # slots admitted when the step was dispatched — the batched engine
    # executes at barrier completion, and later-admitted slots must wait
    # for the next dispatch (exactly the eager engine's token set)
    planned_slots: frozenset = frozenset()
    executed: bool = False        # tokens generated (eager: at dispatch)
    # per-task decode path (True = parity solve, False = systematic
    # scatter) and the decode-solve engine the step actually ran —
    # recorded by execute_step, logged by step_done
    task_solve: Dict[str, bool] = dataclasses.field(default_factory=dict)
    decode_backend: str = ""
    # the step-plan cache entry this step dispatched from (None with the
    # cache disabled); execution checks it is still current before
    # trusting its frozen prefixes/stages
    entry: Optional[StepPlan] = None
    # -- fault layer ---------------------------------------------------------
    # Byzantine corruption drawn for this dispatch: worker → corruption
    # kind, applied to every product block the worker's rows feed
    fault_marks: Dict[int, str] = dataclasses.field(default_factory=dict)
    decode_mode: str = "exact"    # worst per-task mode: exact < ls < degraded
    faults_detected: int = 0      # tasks whose surplus residuals flagged
    rows_rejected: int = 0        # delivered rows excluded from decodes
    retries: int = 0              # leave-one-worker-out recovery attempts
    corrupt_hit: bool = False     # a marked worker's rows reached a decode
    culprits: List[int] = dataclasses.field(default_factory=list)


class _MasterState:
    def __init__(self, n_slots: int):
        self.caches: Any = None
        self.slots: Dict[int, _Slot] = {}
        self.free: List[int] = list(range(n_slots))
        self.step: Optional[_Step] = None


@dataclasses.dataclass
class ServeReport:
    """Everything a coded serve produced, plus the scheduling metrics."""
    metrics: StreamMetrics
    tokens: Dict[int, List[int]]         # rid → generated token ids
    steps: List[Dict[str, float]]        # per coded-step log
    policy: str
    coding_scope: str
    max_err: float                       # NaN when verification was off
    argmax_match_rate: float
    decode_ok: Optional[bool]            # None when verification was off
    wall_seconds: float
    tokens_generated: int
    solve_steps: int
    execution: str = "batched"           # shard-execution engine
    decode_backend: str = "numpy"        # effective decode-solve engine
    backend: str = "numpy"               # backend as *requested*
    # backend that actually ran (the head layer's own record)
    backend_effective: str = "numpy"
    parity_storage: str = "materialized"  # "materialized" | "virtual"
    redispatches: int = 0                # in-flight steps re-timed off-plan
    sim_horizon_ms: float = 0.0          # last step/request completion
    # step-plan cache traffic for this serve (all zero when disabled):
    # steady state is hit-only — one miss per (plan row, width), plus one
    # invalidation per churn/replan event
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_invalidations: int = 0
    # tracing (None unless the bridge was built with a recording Tracer):
    # per-stage wall seconds rolled up from the run's spans, and the path
    # the Chrome/Perfetto trace was written to (when serve(trace_path=...))
    per_stage_wall: Optional[Dict[str, float]] = None
    trace_path: Optional[str] = None
    # fault layer (None unless the bridge was built with faults/ls_tail):
    # per-step decode-mode counts and the chaos/detection/recovery totals
    # — "degraded" steps are the explicitly-reported LS fallbacks, never
    # silently wrong logits
    decode_modes: Optional[Dict[str, int]] = None
    faults: Optional[Dict[str, float]] = None

    def summary(self) -> Dict[str, float]:
        out = self.metrics.summary()
        out.update({
            "tokens_generated": float(self.tokens_generated),
            "coded_steps": float(len(self.steps)),
            "solve_steps": float(self.solve_steps),
            "redispatches": float(self.redispatches),
            "tokens_per_sim_second":
                self.tokens_generated / (self.sim_horizon_ms / 1e3)
                if self.sim_horizon_ms > 0 else 0.0,
            "tokens_per_wall_second":
                self.tokens_generated / max(self.wall_seconds, 1e-300),
            "decode_max_err": self.max_err,
            "argmax_match_rate": self.argmax_match_rate,
            "plan_cache_hits": float(self.plan_cache_hits),
            "plan_cache_misses": float(self.plan_cache_misses),
            "plan_cache_invalidations":
                float(self.plan_cache_invalidations),
            "plan_cache_hit_rate": self.plan_cache_hits
                / max(self.plan_cache_hits + self.plan_cache_misses, 1),
        })
        return out


class CodedServingBridge:
    """Serves generation requests with plan-scheduled coded matmuls.

    Parameters
    ----------
    profile:   worker pool (:class:`ClusterProfile`); ``None`` = the demo
               EC2 pool.  The Scenario's L is the model's padded vocab
               (per-layer matrices reuse the plan row rescaled to their
               own height).
    masters:   number of tenants (plan rows); requests carry a master id.
    arch/seed: model selection (smoke-sized) and init seed.
    config:    a stream :class:`~repro_torch.stream.config.StreamConfig` — the
               same unified surface ``StreamingExecutor`` takes.  Supplies
               ``admission``, ``plan_policy`` (its ``policy``), ``replan``
               and the ``seed`` (its ``rng``) in one object; mutually
               exclusive with passing those individually.  (The
               ``BackendConfig`` half does not apply here: the bridge's
               numerics are governed by ``backend``/``verify`` below.)
    admission: stream :class:`AdmissionConfig` — ``policy`` picks the
               waiting-request ordering, ``min_fraction``/``max_queue`` the
               scaling/backpressure rules.
    plan_policy / replan: forwarded to :class:`OnlinePlanner`.
    slots_per_master: continuous-batching capacity per tenant (the
               contended resource the admission policy arbitrates).
    coding_scope: "head" | "ffn" | "trunk" — which matmuls run coded (see
               module docstring).
    steps_per_dispatch: decode tokens generated per admission (≥ 1).
    execution: "batched" (default) plans every matmul of the step barrier
               at dispatch — prefix rows, packed shard gathers, stacked
               decode plans, all X-independent — and generates the step's
               tokens *once, at barrier completion*, each forward stage
               running as one packed pass; "serial" is the shard-by-shard
               reference engine (per-worker host matmuls, one decode per
               matmul, tokens generated eagerly at dispatch).  The two
               engines emit bit-identical greedy tokens; on the numpy
               backend their shard products are bit-identical outright.
    device_products: route the batched engine's packed products through
               the float32 device-resident weight cache and the
               ``coded_shard_matmul_batch`` kernel (torch backend).
               Off by default: decode-feeding products stay float64
               host-side so tokens match the uncoded pipeline bit-for-bit
               — on-card serving flips this on.
    product_dtype: accumulation/output type of the device products
               (``device_products``).  float64 (default): the float32
               weights and activations multiply exactly and sum in
               float64, so the decode amplifies no float32 rounding;
               float32 is the reference's numerics, kept to measure what
               the float64 products buy.
    backend:   "numpy" | "torch" for the coded encode/decode
               (``ServeReport.backend_effective`` records what ran).
    device:    torch device of the model and of the torch backend
               (default ``cuda``; ``cpu`` runs the plain-torch path).
    parity_storage: "materialized" keeps each layer's packed ``[W; WR]``
               encoded cache (and its float32 device mirror); "virtual"
               derives parity rows from packed threefry counters on
               demand — host gathers re-encode per block (bit-identical),
               the device path runs the generated-parity kernel against
               resident W, and encoded-weight memory drops to ≈ half at
               redundancy 2.  Decoded values and greedy tokens are
               identical across the modes.
    coded:     False serves the identical pipeline with every in-scope
               matmul computed locally (the *uncoded baseline*: same
               scheduling, same sim timing, no shard execution) — the
               reference the parity tests compare greedy tokens against.
    verify:    compare every decoded matmul against the local uncoded
               product (CI/tests).  Off, the bridge skips the reference
               matmuls — the honest serving configuration, since
               distributing those products is the point.
    tracer:    a :class:`repro_torch.obs.Tracer` to record per-step spans
               (plan/pack/kernel/decode stages, sim-side deliveries,
               cache counters) into.  ``None`` or a disabled tracer keeps
               every hot path on its uninstrumented branch — the serve
               loop then costs one predicate per entry point.
    plan_cache: keep a persistent :class:`StepPlanCache` across steps
               (and serves): shard splits, row assignment, covering
               prefixes, packed stages and decode factorizations are
               computed once per (plan row, width) and replayed while the
               pool is unchanged.  Churn and planner re-solves invalidate
               it.  MDS decode is exact for any covering prefix, so the
               frozen structures change no decoded value; ``False`` runs
               the historical re-plan-every-step path.
    faults:    a :class:`repro_torch.faults.FaultConfig` — deterministic chaos
               (crash/drop/duplicate/stale delivery faults, Byzantine
               product corruption) injected per (dispatch, worker), plus
               the detect/quarantine/retry knobs.  Detection spends
               delivered-beyond-the-prefix rows as parity residual
               checks; a confirmed corrupt or crashed worker is
               quarantined through the churn path (plan-cache epoch bump,
               planner re-solve, backoff readmission) and the step
               recovers by re-decoding from the verified row subset —
               exactly when coverage allows, degraded least-squares
               otherwise, never silently wrong.  The fault draws never
               touch the delay stream: a schedule that fires no fault
               serves bit-identically to ``faults=None``.
    ls_tail:   decode every coded matmul by stacked least squares over
               the covering prefix *plus* the delivered surplus rows
               (``faults.surplus_rows`` cap) instead of discarding them —
               the over-determined solve damps the float32 parity-encode
               noise of the torch tail.  With no surplus (cap 0)
               the LS plan routes through the same cached LU as the
               square decode, so tokens are identical to ``ls_tail=False``.
    """

    def __init__(self, profile: Optional[ClusterProfile] = None, *,
                 masters: int = 2, arch: str = "llama3.2-1b",
                 smoke: bool = True,
                 config: Optional[StreamConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 plan_policy: str = "fractional",
                 replan: Optional[ReplanPolicy] = None,
                 slots_per_master: int = 4,
                 coding_scope: str = "head",
                 steps_per_dispatch: int = 1,
                 execution: str = "batched",
                 device_products: bool = False,
                 backend: str = "numpy",
                 parity_storage: str = "materialized",
                 coded: bool = True,
                 verify: bool = True, seed: int = 0,
                 tracer: Optional[Tracer] = None,
                 plan_cache: bool = True,
                 faults: Optional[FaultConfig] = None,
                 ls_tail: bool = False, device=None,
                 product_dtype: torch.dtype = torch.float64):
        if coding_scope not in CODING_SCOPES:
            raise ValueError(f"unknown coding_scope {coding_scope!r}; "
                             f"expected one of {CODING_SCOPES}")
        if execution not in EXECUTION_MODES:
            raise ValueError(f"unknown execution {execution!r}; "
                             f"expected one of {EXECUTION_MODES}")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if config is not None:
            if (admission is not None or replan is not None
                    or plan_policy != "fractional"):
                raise TypeError("pass either config=StreamConfig(...) or "
                                "the per-feature admission/plan_policy/"
                                "replan kwargs, not both")
            admission = config.admission
            plan_policy = config.policy
            replan = config.replan
            seed = config.rng
        self.profile = profile or default_pool(seed=seed)
        self.M = int(masters)
        self.arch = arch
        self.smoke = bool(smoke)
        self.admission = admission or AdmissionConfig(policy="edf")
        self.plan_policy = plan_policy
        self.replan = replan
        self.slots_per_master = int(slots_per_master)
        self.coding_scope = coding_scope
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.execution = execution
        self.device_products = bool(device_products)
        if product_dtype not in (torch.float32, torch.float64):
            raise ValueError(f"product_dtype must be torch.float32 or "
                             f"torch.float64, got {product_dtype}")
        self.product_dtype = product_dtype
        self.backend = bk.check_backend(backend)
        self.device = resolve_device(device)
        if parity_storage not in ("materialized", "virtual"):
            raise ValueError(f"parity_storage must be 'materialized' or "
                             f"'virtual', got {parity_storage!r}")
        self.parity_storage = parity_storage
        self.coded = bool(coded)
        self.verify = bool(verify)
        self.seed = int(seed)
        self.tracer = tracer if (tracer is not None and tracer.enabled) \
            else None
        self.faults = faults
        self.ls_tail = bool(ls_tail)
        # the last serve's quarantine ledger (None before any faulted
        # serve) — tests and the bench introspect offenses/readmissions
        self.ledger: Optional[QuarantineLedger] = None
        self._plan_cache = StepPlanCache() if plan_cache else None
        self._model = None
        self._max_len = 0

    # -- lazy model setup ----------------------------------------------------

    def _setup_model(self, max_len: int):
        if self._model is None:
            from ..launch.serve import build_model, head_matrix, serving_fns
            cfg, params = build_model(self.arch, smoke=self.smoke,
                                      seed=self.seed, device=self.device)
            W = head_matrix(cfg, params)
            self._model = dict(cfg=cfg, params=params, W=W)
            self.sc = self.profile.scenario(self.M, L=float(W.shape[0]))
            self.head = CodedLMHead(W, seed=self.seed, backend=self.backend,
                                    parity_storage=self.parity_storage,
                                    device=self.device)
            self._linears: Dict[str, CodedLinear] = {"head": self.head}
            self.runner: Optional[HostTrunk] = None
            if self.coding_scope == "head":
                prefill_fn, decode_fn = serving_fns(cfg, return_hidden=True)
                self._model.update(prefill_fn=prefill_fn, decode_fn=decode_fn)
            else:
                self.runner = HostTrunk(cfg, params, W)
                for key in trunk_matmul_keys(cfg, self.coding_scope):
                    self._linears[key] = CodedLinear(
                        self.runner.weights[key], name=key, seed=self.seed,
                        backend=self.backend,
                        parity_storage=self.parity_storage,
                        device=self.device)
            self._coded_keys = [k for k in self._linears if k != "head"] \
                + ["head"]
        if max_len > self._max_len:
            # caches must cover the longest request this bridge ever saw —
            # a later serve() with longer requests regrows them
            ml = int(max_len)
            cfg = self._model["cfg"]
            if self.coding_scope == "head":
                from ..launch.serve import zero_caches
                self._model["zero_caches"] = \
                    lambda b: zero_caches(cfg, b, ml, device=self.device)
            else:
                self._model["zero_caches"] = \
                    lambda b: self.runner.zero_caches(b, ml)
            self._max_len = ml

    @staticmethod
    def _write_slot(big, one, slot: int):
        """Scatter a single-request cache into batch slot ``slot``.

        The batch axis is the first axis where the shapes differ (the
        single-request cache has size 1 there); identical shapes mean a
        one-slot batch — replace wholesale.  Writes into ``big`` in place
        and returns it."""
        if isinstance(big, dict):
            return {k: CodedServingBridge._write_slot(big[k], one[k], slot)
                    for k in big}
        ax = next((i for i, (bs, os_) in
                   enumerate(zip(big.shape, one.shape)) if bs != os_), None)
        if ax is None:
            return one
        big.select(ax, slot).copy_(one.select(ax, 0))
        return big

    # -- serve ---------------------------------------------------------------

    def serve(self, requests: Sequence[ServeRequest],
              churn: Sequence[WorkerEvent] = (), *,
              trace_path: Optional[str] = None) -> ServeReport:
        """Serve ``requests`` to completion (see class docstring).

        ``trace_path`` (needs a recording ``tracer``) writes the run's
        Chrome/Perfetto trace JSON there after the event loop drains; the
        report's ``per_stage_wall`` / ``trace_path`` fields are filled in
        either way when a tracer is attached."""
        # re-normalize (callers may assign .tracer after construction):
        # a disabled tracer serves on the identical uninstrumented branch
        tracer = self.tracer \
            if self.tracer is not None and self.tracer.enabled else None
        if tracer is None:
            return self._serve_impl(requests, churn)
        with use_tracer(tracer) as tr:
            with tr.span("serve", cat="run",
                         args={"scope": self.coding_scope,
                               "execution": self.execution,
                               "backend": self.backend,
                               "coded": self.coded,
                               "requests": len(requests)}):
                rep = self._serve_impl(requests, churn)
        rep.per_stage_wall = dict(tr.summary()["per_stage_wall"])
        if trace_path is not None:
            rep.trace_path = str(trace_path)
            tr.write(trace_path)
        return rep

    def _serve_impl(self, requests: Sequence[ServeRequest],
                    churn: Sequence[WorkerEvent] = ()) -> ServeReport:
        t_wall = time.perf_counter()
        reqs = {r.rid: r for r in requests}
        max_len = max(len(r.prompt) + r.gen_len for r in requests) + 8
        self._setup_model(max_len)
        mdl = self._model
        L = self.head.L

        planner = OnlinePlanner(self.sc, policy=self.plan_policy,
                                replan=self.replan, rng=self.seed)
        pool = SharePool(self.sc.N)
        queue = make_admission_policy(self.admission.policy,
                                      self.admission.max_queue)
        metrics = StreamMetrics(self.M, self.sc.N)
        exp = bk.ExponentialBlock(
            np.random.default_rng((self.seed, 0x5E4E)), self.sc.N + 1)
        scale = np.ones(self.sc.N + 1)
        sc_eff = self.sc
        cache = self._plan_cache
        if cache is not None:
            # the cache persists across serves on this bridge; key every
            # lookup on the current effective scenario so a previous
            # serve's entries can only hit when they are still exact
            cache.set_context(_scenario_ctx(sc_eff))
            # a planner re-solve replaces the plan row under the frozen
            # splits' feet — drop everything (first solve does not fire)
            planner.subscribe(lambda: cache.invalidate("replan"))
        cache0 = (cache.hits, cache.misses, cache.invalidations) \
            if cache is not None else (0, 0, 0)
        # per-task covering requirement (each coded matrix's own L) —
        # fixed for the serve, shared by every dispatch's barrier
        needs = np.array([self._linears[key].L
                          for key in self._coded_keys], dtype=np.float64)
        recs: Dict[int, TaskRecord] = {}
        states = [None] * self.M
        for m in range(self.M):
            st = _MasterState(self.slots_per_master)
            st.caches = mdl["zero_caches"](self.slots_per_master)
            states[m] = st
        step_log: List[Dict[str, float]] = []
        tokens_out: Dict[int, List[int]] = {}
        seq = itertools.count()
        version_seq = itertools.count()
        heap: List[Tuple[float, int, str, Any]] = []
        for r in requests:
            heapq.heappush(heap, (r.t_arrive, next(seq), _ARRIVE, r))
        for ev in churn:
            heapq.heappush(heap, (ev.time, next(seq), _CHURN, ev))
        stats = dict(max_err=0.0, match=0, total=0, solves=0, tokens=0,
                     redispatches=0)
        # the decode-solve engine this configuration runs (the report and
        # the per-step log say what ran)
        eff_decode = ("local" if not self.coded
                      else DECODE_ENGINE[self.backend])

        # ---- fault layer (chaos + detect/quarantine/retry) ---------------
        faults = self.faults if self.coded else None
        fsched = faults.schedule() \
            if faults is not None and faults.active else None
        fdetect = faults is not None and faults.detect
        faulting = fdetect or self.ls_tail \
            or (faults is not None and faults.active)
        ledger = QuarantineLedger(backoff_base=faults.backoff_base,
                                  backoff_factor=faults.backoff_factor) \
            if faults is not None else None
        self.ledger = ledger
        dispatch_seq = itertools.count()
        surplus_cap = faults.surplus_rows if faults is not None else 0
        eps = faults.corrupt_eps if faults is not None else 1e-3
        # flag threshold: the float32 parity-encode noise of the torch
        # product tail sits far above the float64 honest-residual
        # floor — detection must not flag its own backend's roundoff
        dtol = faults.residual_tol if faults is not None else 1e-4
        if self.backend != "numpy":
            dtol = max(dtol, 5e-4 if self.coding_scope == "head" else 2e-2)
        decode_modes: Dict[str, int] = {}
        _MODE_RANK = {"exact": 0, "ls": 1, "degraded": 2}
        fstats = dict(injected=0, crashes=0, drops=0, stales=0,
                      duplicates=0, corrupt_steps=0, corrupt_applied=0,
                      detected_steps=0, detected=0, localized=0, retries=0,
                      rows_rejected=0, false_flags=0)

        def _gen(lin, total: int):
            """Generator rows view (``total`` coded rows) for the verify/
            recovery decodes — lazy for virtual parity (no dense G)."""
            if lin.parity_storage == "virtual":
                return bk.SystematicRows(lin.L, max(total, lin.L),
                                         lin.parity_rows)
            return lin.generator(max(total, lin.L))

        def _on_card(lin) -> bool:
            # virtual parity on the torch backend: the recovery decodes
            # and the per-row checks run on the card from counters, never
            # forming a layer's dense parity rows on the host
            return lin.backend == "torch" and lin.parity_storage == "virtual"

        def _decode(lin, G, rows: np.ndarray):
            """Exactly-L recovery decode plan of ``rows`` (L,)."""
            if _on_card(lin):
                return DeviceRowsDecode(lin, rows)
            return bk.plan_decode(G, rows[None])

        def _residuals(lin, G, rows: np.ndarray, x_hat, y) -> np.ndarray:
            """Relative residuals (S,) of delivered ``rows`` against x̂."""
            if _on_card(lin):
                return device_verify_residuals(lin, rows, x_hat, y)
            return bk.plan_verify(G, rows[None]).residuals(x_hat[None],
                                                           y[None])[0]

        # ---- helpers bound to this serve run -----------------------------

        def online() -> np.ndarray:
            return pool.online

        def has_work() -> bool:
            return bool(len(queue)) or any(st.slots for st in states)

        def admit(t: float) -> None:
            while len(queue):
                progressed = False
                for rid in queue.candidates():
                    st = states[reqs[rid].master]
                    if st.free:
                        slot = min(st.free)
                        st.free.remove(slot)
                        queue.remove(rid)
                        queue.note_admitted(reqs[rid].master)
                        recs[rid].t_admit = t
                        r = reqs[rid]
                        st.slots[slot] = _Slot(rid=rid, prompt=r.prompt,
                                               gen_len=r.gen_len, tokens=[])
                        progressed = True
                        break
                    if queue.head_of_line:
                        return
                if not progressed:
                    return

        def fair_cap(m: int, k_req, b_req) -> float:
            # claimants: masters holding step shares, plus masters with
            # queued requests or admitted-but-idle batches (plan-row demand)
            held_rows = {m2: states[m2].step.k_row for m2 in range(self.M)
                         if states[m2].step is not None
                         and not states[m2].step.stalled}
            waiting = queue.waiting_masters() | {
                m2 for m2 in range(self.M)
                if states[m2].slots and states[m2].step is None}
            held, demands = fair_demand_rows(m, planner.plan.k, online(),
                                             waiting, held_rows)
            return queue.fair_fraction(m, k_req, b_req, held=held,
                                       demands=demands)

        def quarantine_worker(w: int, t: float) -> None:
            """Confirmed-fault response: flag the worker in the ledger and
            take it offline through the churn path (synthetic ``crash``
            event — in-flight steps re-time, the plan cache epoch bumps,
            the planner re-solves), with a backoff ``join`` scheduled for
            readmission.  Idempotent while already quarantined."""
            if ledger is None or w <= 0 or not pool.online[w]:
                return
            t_back = ledger.flag(w, t)
            heapq.heappush(heap, (t, next(seq), _CHURN,
                                  WorkerEvent(time=t, worker=w,
                                              kind="crash")))
            heapq.heappush(heap, (t_back, next(seq), _CHURN,
                                  WorkerEvent(time=t_back, worker=w,
                                              kind="join")))

        # ---- hidden-state computation (scope-aware) ----------------------

        def to_host(h: torch.Tensor) -> np.ndarray:
            return h.detach().to(torch.float64).cpu().numpy()

        def hidden_states(st: _MasterState, slot_ids: List[int]
                          ) -> np.ndarray:
            dev = self.device
            cont = [s for s in slot_ids if not st.slots[s].needs_prefill]
            H: Dict[int, np.ndarray] = {}
            if cont:
                B = self.slots_per_master
                toks = np.zeros((B, 1), dtype=np.int64)
                pos = np.zeros((B,), dtype=np.int64)
                for s in cont:
                    toks[s, 0] = st.slots[s].tokens[-1]
                    pos[s] = st.slots[s].pos
                _, st.caches, hid = mdl["decode_fn"](
                    mdl["params"], torch.from_numpy(toks).to(dev),
                    torch.from_numpy(pos).to(dev), st.caches)
                hid = to_host(hid)
                for s in cont:
                    H[s] = hid[s, 0]
                    st.slots[s].pos += 1
            for s in slot_ids:
                slot = st.slots[s]
                if not slot.needs_prefill:
                    continue
                batch = {"tokens": torch.from_numpy(
                    np.asarray(slot.prompt, dtype=np.int64)[None]).to(dev)}
                _, c1, h1 = mdl["prefill_fn"](
                    mdl["params"], batch, mdl["zero_caches"](1))
                st.caches = self._write_slot(st.caches, c1, s)
                slot.pos = len(slot.prompt)
                slot.needs_prefill = False
                H[s] = to_host(h1)[0, 0]
            return np.stack([H[s] for s in slot_ids])

        def hidden_states_host(st: _MasterState, slot_ids: List[int],
                               mm, mm_group=None) -> np.ndarray:
            cont = [s for s in slot_ids if not st.slots[s].needs_prefill]
            H: Dict[int, np.ndarray] = {}
            if cont:
                toks = np.array([[st.slots[s].tokens[-1]] for s in cont],
                                dtype=np.int64)
                pos = np.array([[st.slots[s].pos] for s in cont],
                               dtype=np.int64)
                hid = self.runner.forward(toks, pos, np.array(cont),
                                          st.caches, mm, mm_group=mm_group)
                for i, s in enumerate(cont):
                    H[s] = hid[i, 0]
                    st.slots[s].pos += 1
            for s in slot_ids:
                slot = st.slots[s]
                if not slot.needs_prefill:
                    continue
                P = len(slot.prompt)
                hid = self.runner.forward(
                    np.asarray(slot.prompt)[None].astype(np.int64),
                    np.arange(P, dtype=np.int64)[None], np.array([s]),
                    st.caches, mm, mm_group=mm_group)
                slot.pos = P
                slot.needs_prefill = False
                H[s] = hid[0, -1]
            return np.stack([H[s] for s in slot_ids])

        # ---- step timing + dispatch --------------------------------------

        def make_timing(m: int, t: float, relax: bool):
            """Shares + per-matmul delivery schedule, or None if it cannot
            run now.  Draws one ExponentialBlock row per coded matmul."""
            plan = planner.ensure_plan(online(), scale)
            fair_fn = (lambda kq, bq: fair_cap(m, kq, bq)) \
                if queue.uses_fairness and not relax else None
            scaled = scale_shares(
                pool, plan.k[m], plan.b[m], online(),
                allow_scaling=self.admission.allow_scaling,
                floor=1e-6 if relax else self.admission.min_fraction,
                fair_fn=fair_fn)
            if scaled is None:
                return None
            k_row, b_row, _f = scaled
            keys = self._coded_keys
            entry = cache.lookup(m, k_row, b_row) \
                if cache is not None else None
            if entry is None:
                # miss: the splits and the expected-delay assignment are
                # pure functions of (sc_eff, m, k_row, b_row) — compute
                # once, freeze in the cache for every later step
                l_row, _ = scaled_row_loads(sc_eff, m, k_row, b_row)
                if l_row.sum() < L - 1e-6:
                    return None
                l_ints = np.stack(
                    [coded_row_shards(l_row, L) if self._linears[key].L == L
                     else rescaled_row_shards(l_row, L, self._linears[key].L)
                     for key in keys])
                # expected per-node delay (the Exp(1) draws at their mean):
                # the systematic row ranges go to the statistically fastest
                # nodes, so covering prefixes decode mostly by scatter — a
                # dispatch-time decision, blind to the realized delays below
                expect = bk.sample_delays(np.ones_like(l_ints, dtype=float),
                                          np.ones_like(l_ints, dtype=float),
                                          l_ints, k_row, b_row, sc_eff.a[m],
                                          sc_eff.u[m], sc_eff.gamma[m])
                entry = StepPlan(keys=keys, l_ints=l_ints, assign=expect,
                                 epoch=cache.epoch if cache is not None
                                 else 0)
                if cache is not None:
                    cache.store(m, k_row, b_row, entry)
            l_ints = entry.l_ints
            # all of the barrier's delays in one batched draw + transform
            # (drawn hit or miss — the delay stream is cache-independent)
            e = exp.draw_n(len(keys))                   # (T, 2, N+1)
            d = bk.sample_delays(e[:, 0], e[:, 1], l_ints, k_row, b_row,
                                 sc_eff.a[m], sc_eff.u[m], sc_eff.gamma[m])
            finish = np.where(l_ints > 0, t + d, np.inf)
            # fault injection: resolved per (dispatch, loaded worker) from
            # the stateless hash-seeded schedule — the ExponentialBlock
            # stream above is already drawn, so a schedule that fires
            # nothing leaves the timing bit-identical to faults=None
            marks: Dict[int, str] = {}
            if fsched is not None:
                disp = next(dispatch_seq)
                loaded = np.nonzero(l_ints.sum(axis=0)[1:] > 0)[0] + 1
                for w, kind in sorted(
                        fsched.faults_at(disp, loaded).items()):
                    fstats["injected"] += 1
                    if kind == "crash":
                        # dies mid-task: every undelivered shard of this
                        # dispatch is lost and the worker leaves the pool
                        # until its backoff readmission
                        finish[:, w] = np.inf
                        fstats["crashes"] += 1
                        quarantine_worker(w, t)
                    elif kind == "drop":
                        finish[:, w] = np.inf
                        fstats["drops"] += 1
                    elif kind == "stale":
                        finish[:, w] = t + (finish[:, w] - t) \
                            * faults.stale_factor
                        fstats["stales"] += 1
                    elif kind == "duplicate":
                        # receiver-side dedupe: numerically inert
                        fstats["duplicates"] += 1
                    else:                       # Byzantine corruption
                        marks[w] = kind
            tasks = [BarrierTask(name=key, l_int=l_ints[i],
                                 finish=finish[i],
                                 need=needs[i],
                                 assign=entry.assign[i])
                     for i, key in enumerate(keys)]
            barrier = StepBarrier(tasks, F=finish,
                                  l=l_ints.astype(np.float64), need=needs)
            if not np.isfinite(barrier.completion):
                return None
            return k_row, b_row, barrier, entry, marks

        def plan_timing(m: int, t: float, relax: bool):
            """``make_timing`` under a dispatch-step span: plan lookup,
            share scaling and the batched delay draw are real wall work a
            step pays before any shard moves, so they count toward step
            wall time with the planning attributed to the "plan" stage
            (an OnlinePlanner re-solve inside shows up as its own
            cat="replan" child)."""
            tr = current_tracer()
            if tr is None:
                return make_timing(m, t, relax)
            with tr.span(f"dispatch:m{m}", cat="step",
                         args={"master": m, "sim_t": t}) as a:
                with tr.span(f"plan:m{m}", cat="plan",
                             args={"master": m, "relax": relax}):
                    timing = make_timing(m, t, relax)
                a["dispatched"] = timing is not None
            return timing

        def execute_step(m: int, sp: _Step) -> None:
            """Generate the dispatch's tokens through its matmul engine.

            The serial engine runs this eagerly at dispatch (the decoded
            values only depend on *which* prefix covers, not when it
            lands); the batched engine runs it once, at barrier
            completion, with every stage of the forward as one packed
            pass over plans frozen at dispatch."""
            tr = current_tracer()
            if tr is None:
                return _execute_step(m, sp)
            n0 = len(tr.spans)
            with tr.span(f"step:m{m}", cat="step",
                         args={"master": m, "execution": self.execution,
                               "scope": self.coding_scope}) as a:
                _execute_step(m, sp)
                a["tokens"] = sum(len(v) for v in sp.tok_by_slot.values())
                a["used_solve"] = sp.used_solve
            # the wall time between this step's stage spans is measured,
            # not inferred: host forward math + bookkeeping become glue
            _fill_glue(tr, n0)

        def _execute_step(m: int, sp: _Step) -> None:
            st = states[m]
            task_map = {task.name: task for task in sp.barrier.tasks}
            step_stats = dict(max_err=0.0, used_solve=False, argmax_ok=0)
            batched = self.execution == "batched"
            ex = _BarrierExecutor(self._linears, sp.barrier,
                                  backend=self.backend,
                                  device_products=self.device_products,
                                  product_dtype=self.product_dtype,
                                  entry=sp.entry, cache=self._plan_cache) \
                if batched and self.coded else None
            # serial engine: share the same frozen prefixes across steps —
            # the first step per plan row plans the whole barrier in one
            # stacked pass and later steps skip planning entirely, keeping
            # the two engines decode-for-decode identical
            frozen = None
            if (not batched and self.coded and self._plan_cache is not None
                    and self._plan_cache.is_current(sp.entry)):
                if sp.entry.plans is None:
                    tr = current_tracer()
                    ctx = tr.span("plan:prefixes", cat="plan",
                                  args={"tasks": len(sp.barrier.tasks)}) \
                        if tr is not None else contextlib.nullcontext()
                    with ctx:
                        sp.entry.plans = prefix_plan_batch(
                            self._linears, sp.barrier)
                frozen = sp.entry.plans

            # ---- fault verification / recovery ---------------------------
            # one diagnosis per task per step (the fix replays for every
            # token batch of a multi-token dispatch); injection applies to
            # every product block a marked worker's rows feed
            marks = sp.fault_marks
            active_faults = faulting and self.coded
            fixes: Dict[str, tuple] = {}
            plans_memo: Dict[str, Any] = {}

            def corrupt_rows(y: np.ndarray, rw: np.ndarray) -> None:
                """In-place Byzantine injection on one task's product
                block (rows aligned with worker attribution ``rw``)."""
                for w, kind in marks.items():
                    msk = rw == w
                    if msk.any():
                        y[msk] = corrupt_products(y[msk], kind, eps=eps)

            def serial_mutate(y, plan):
                corrupt_rows(y, plan.row_workers())

            def products(lin, rows: np.ndarray, X: np.ndarray) -> np.ndarray:
                """The fault layer's shard products of coded rows ``rows``
                (surplus, prefix, re-dispatched), (rows, B) float64: with
                the batched engine's device products, through the same
                packed kernels on the card as the step's own products."""
                if ex is None or not ex.device_products \
                        or self.backend != "torch" or not rows.size:
                    return shard_products(lin.gather_encoded(rows), X)
                pack = PackedShards([ShardProblem(key=lin.name, linear=lin,
                                                  rows=rows,
                                                  used_solve=False)])
                y = pack.products_device(X, out_dtype=self.product_dtype)[0]
                return y.to(torch.float64).cpu().numpy()

            def plan_for(key: str):
                if ex is not None:
                    return ex.plans[key]
                if frozen is not None and frozen.get(key) is not None:
                    return frozen[key]
                p = plans_memo.get(key)
                if p is None:
                    task = task_map[key]
                    p = self._linears[key].prefix_plan(
                        task.l_int, task.finish, task.completion,
                        assign=task.assign)
                    plans_memo[key] = p
                return p

            def _diagnose(key, lin, task, plan, out, X):
                """First-token verification of one coded task.

                Residual-check up to ``surplus_cap`` delivered-beyond-the-
                prefix rows against the decoded estimate; on a flag,
                localise by leave-one-worker-out exclusion (retry budget)
                and pick the verified recovery row subset.  Returns the
                per-step fix ``(mode, rows, row_workers, decode_plan)``."""
                sur = swk = np.empty(0, dtype=np.int64)
                if surplus_cap > 0:
                    sur, swk = surplus_plan(task.l_int, task.finish,
                                            task.completion, plan,
                                            cap=surplus_cap,
                                            assign=task.assign)
                g_rows = int(plan.total)
                if fdetect and surplus_cap > 0:
                    # two master-encoded audit rows (worker 0: honest by
                    # construction) always ride along with the delivered
                    # surplus: a *consistent* corruption of every delivered
                    # row — e.g. a sign-flip hitting all used workers —
                    # satisfies its own wrong decode and is undetectable
                    # from worker deliveries alone
                    lin.ensure_parity(g_rows + 2 - lin.L)
                    sur = np.concatenate(
                        [sur, np.arange(g_rows, g_rows + 2, dtype=np.int64)])
                    swk = np.concatenate([swk, np.zeros(2, np.int64)])
                    g_rows += 2
                pw = plan.row_workers()
                if marks and any(
                        w in marks for w in set(plan.used.tolist())
                        | set(swk.tolist())):
                    sp.corrupt_hit = True
                flagged = y_sur = G = None
                if fdetect and sur.size:
                    y_sur = products(lin, sur, X)
                    if marks:
                        corrupt_rows(y_sur, swk)
                    G = _gen(lin, g_rows)
                    resid = _residuals(lin, G, sur, out.T, y_sur)
                    flagged = resid > dtol
                if flagged is None or not flagged.any():
                    if self.ls_tail:
                        rows_all = np.concatenate([plan.rows, sur])
                        wk_all = np.concatenate([pw, swk])
                        dp = bk.plan_decode_ls(_gen(lin, g_rows),
                                               rows_all[None])
                        return ("ls", rows_all, wk_all, dp)
                    return ("pass", None, None, None)
                # detection: the stacked system is inconsistent — either a
                # flagged surplus row or a row inside the decoded prefix
                sp.faults_detected += 1
                fstats["detected"] += 1
                if not marks:
                    fstats["false_flags"] += 1
                rows_all = np.concatenate([plan.rows, sur])
                wk_all = np.concatenate([pw, swk])
                y_pref = products(lin, plan.rows, X)
                if marks:
                    corrupt_rows(y_pref, pw)
                y_all = np.concatenate([y_pref, y_sur])
                # candidate order: workers whose surplus rows flagged
                # first, prior offenders next, the rest after.  Each
                # attempt spends one unit of the retry budget and models a
                # *re-dispatch*: the candidate's rows are recomputed
                # honestly (as if shipped to another worker), the decode
                # re-runs on [everyone else's rows; re-dispatched rows]
                # and the remaining deliveries re-check it — the first
                # candidate whose exclusion restores consistency is the
                # culprit and the re-decoded estimate is verified-exact
                flag_wk = list(dict.fromkeys(int(w) for w in swk[flagged]))
                rest = [w for w in dict.fromkeys(int(v) for v in wk_all)
                        if w not in flag_wk]
                if ledger is not None:
                    rest = ledger.suspects_first(rest)
                def attempt(excl: np.ndarray):
                    """Re-dispatch the excluded rows (honest recompute —
                    worker 0, the master's own column, never marked) and
                    re-decode; the remaining deliveries re-check it."""
                    rows_rd = rows_all[excl]
                    y_rd = products(lin, rows_rd, X)
                    rows_c = np.concatenate([rows_all[~excl], rows_rd])
                    y_c = np.concatenate([y_all[~excl], y_rd])
                    wk_c = np.concatenate(
                        [wk_all[~excl], np.zeros(rows_rd.size, np.int64)])
                    sp.rows_dispatched += int(rows_rd.size)
                    x_hat = _decode(lin, G, rows_c[:lin.L]).apply(
                        y_c[:lin.L][None], backend=self.backend,
                        device=lin.device)[0]
                    resid = _residuals(lin, G, rows_c[lin.L:], x_hat,
                                       y_c[lin.L:])
                    return (not (resid > dtol).any()), rows_c, wk_c, x_hat

                budget = max(faults.retry_budget, 0)
                hit, tried = None, 0
                for w in flag_wk + rest:
                    # the final budget unit is reserved for the full
                    # re-dispatch below — it is the one attempt that is
                    # guaranteed to restore consistency
                    if tried >= budget - 1:
                        break
                    tried += 1
                    ok, rows_c, wk_c, x_hat = attempt(wk_all == w)
                    if ok:
                        hit = (rows_c, wk_c, x_hat)
                        break
                if hit is None and flag_wk:
                    # several workers implicated at once (multiple faults,
                    # or a prefix corruption flagging every honest surplus
                    # row): re-dispatch all of them together, then widen
                    # by one extra candidate at a time while budget lasts
                    base = np.isin(wk_all, flag_wk)
                    widen = ([None] + rest) if len(flag_wk) > 1 else rest
                    for w in widen:
                        if tried >= budget - 1:
                            break
                        tried += 1
                        ok, rows_c, wk_c, x_hat = attempt(
                            base if w is None else base | (wk_all == w))
                        if ok:
                            hit = (rows_c, wk_c, x_hat)
                            break
                if hit is None and tried < budget:
                    # last unit of budget: full timeout re-dispatch — the
                    # whole task re-executes on fresh workers (every row
                    # honest by construction), which both recovers exactly
                    # and lets the attribution below name every culprit
                    tried += 1
                    ok, rows_c, wk_c, x_hat = attempt(
                        np.ones(rows_all.size, dtype=bool))
                    if ok:
                        hit = (rows_c, wk_c, x_hat)
                sp.retries += tried
                fstats["retries"] += tried
                if hit is not None:
                    rows_c, wk_c, x_hat = hit
                    # a *verified* estimate in hand, corruption attributes
                    # per delivered row: every worker owning a row whose
                    # residual against x̂ flags is a confirmed culprit
                    row_res = _residuals(lin, G, rows_all, x_hat, y_all)
                    bad_rows = row_res > dtol
                    fstats["localized"] += 1
                    nrej = int(bad_rows.sum())
                    sp.rows_rejected += nrej
                    fstats["rows_rejected"] += nrej
                    for w in sorted(set(int(v)
                                        for v in wk_all[bad_rows])):
                        if w not in sp.culprits:
                            sp.culprits.append(w)
                    sel_r, sel_w = rows_c[:lin.L], wk_c[:lin.L]
                    return ("exact", sel_r, sel_w, _decode(lin, G, sel_r))
                # no consistent exclusion within budget: reject every row
                # a flagged worker delivered and LS-decode the remainder —
                # explicitly degraded (decode_mode), never silently wrong.
                # Worker 0's audit rows are honest by construction; if they
                # flagged, the fault is elsewhere — always keep them
                bad = np.isin(wk_all, flag_wk) & (wk_all != 0)
                nrej = int(bad.sum())
                sp.rows_rejected += nrej
                fstats["rows_rejected"] += nrej
                sel_r, sel_w = rows_all[~bad], wk_all[~bad]
                dp = bk.plan_decode_ls(G, sel_r[None],
                                       allow_underdetermined=True)
                return ("degraded", sel_r, sel_w, dp)

            def fault_check(key: str, out: np.ndarray,
                            X: np.ndarray) -> np.ndarray:
                """Verify/recover one decoded product (called per token
                batch; the diagnosis is made once and replayed)."""
                lin = self._linears[key]
                fix = fixes.get(key)
                if fix is None:
                    fix = _diagnose(key, lin, task_map[key], plan_for(key),
                                    out, X)
                    fixes[key] = fix
                    mode = fix[0] if fix[0] != "pass" else "exact"
                    if _MODE_RANK[mode] > _MODE_RANK[sp.decode_mode]:
                        sp.decode_mode = mode
                mode, sel_r, sel_w, dp = fix
                if mode == "pass":
                    return out
                y = products(lin, sel_r, X)
                if marks:
                    corrupt_rows(y, sel_w)
                if mode == "exact":
                    z = dp.apply(y[:lin.L][None], backend=self.backend,
                                 device=lin.device)[0]
                else:
                    z = dp.apply(y[None], backend=self.backend,
                                 device=lin.device)[0]
                return z.T

            def verify_coded(key: str, out: np.ndarray, X: np.ndarray):
                lin = self._linears[key]
                ref = lin.local(X) if self.coded else out
                if self.coded:
                    err = float(np.abs(out - ref).max()
                                / (1.0 + np.abs(ref).max()))
                    step_stats["max_err"] = max(step_stats["max_err"], err)
                if key == "head":
                    # reused below for the greedy argmax check — the
                    # head product is the model's largest matmul
                    step_stats["head_ref"] = ref

            def mm(key: str, X: np.ndarray) -> np.ndarray:
                """Serial engine: one shard-by-shard coded task per call."""
                if key not in task_map:             # out-of-scope: local
                    return self.runner.local_matmul(key, X)
                lin = self._linears[key]
                task = task_map[key]
                if self.coded:
                    res = lin.step(X, task.l_int, task.finish,
                                   task.completion, assign=task.assign,
                                   plan=plan_for(key) if active_faults
                                   else (None if frozen is None
                                         else frozen.get(key)),
                                   mutate=serial_mutate if marks else None)
                    out = res.out
                    step_stats["used_solve"] |= res.used_solve
                    sp.task_solve[key] = bool(res.used_solve)
                    sp.decode_backend = res.decode_backend
                    if active_faults:
                        out = fault_check(key, out, X)
                else:
                    out = lin.local(X)
                if self.verify:
                    verify_coded(key, out, X)
                return out

            def mm_group(items) -> Dict[str, np.ndarray]:
                """Batched engine: one dependency stage per call."""
                outs: Dict[str, np.ndarray] = {}
                coded_items = [(k, X) for k, X in items if k in task_map]
                for k, X in items:
                    if k not in task_map:           # out-of-scope: local
                        outs[k] = self.runner.local_matmul(k, X)
                if coded_items:
                    if self.coded:
                        outs.update(ex.execute(coded_items,
                                               marks=marks or None,
                                               eps=eps))
                        step_stats["used_solve"] |= ex.used_solve
                        if active_faults:
                            for k, X in coded_items:
                                outs[k] = fault_check(k, outs[k], X)
                    else:
                        for k, X in coded_items:
                            outs[k] = self._linears[k].local(X)
                    if self.verify:
                        for k, X in coded_items:
                            verify_coded(k, outs[k], X)
                return outs

            tok_by_slot: Dict[int, List[int]] = {}
            for _j in range(self.steps_per_dispatch):
                slot_ids = [s for s in sorted(st.slots)
                            if s in sp.planned_slots
                            and len(st.slots[s].tokens)
                            < st.slots[s].gen_len]
                if not slot_ids:
                    break
                if self.coding_scope == "head":
                    H = hidden_states(st, slot_ids)
                elif batched:
                    H = hidden_states_host(st, slot_ids, None,
                                           mm_group=mm_group)
                else:
                    H = hidden_states_host(st, slot_ids, mm)
                if batched:
                    logits = mm_group([("head", H)])["head"]
                else:
                    logits = mm("head", H)
                tokens = np.argmax(logits, axis=1).astype(np.int64)
                if self.verify:
                    ref = step_stats.pop("head_ref")
                    ok = int((tokens == np.argmax(ref, axis=1)).sum())
                else:
                    ok = len(slot_ids)
                step_stats["argmax_ok"] += ok
                stats["total"] += len(slot_ids)
                for sid, tok in zip(slot_ids, tokens):
                    st.slots[sid].tokens.append(int(tok))
                    tok_by_slot.setdefault(sid, []).append(int(tok))

            stats["max_err"] = max(stats["max_err"], step_stats["max_err"])
            stats["match"] += step_stats["argmax_ok"]
            stats["solves"] += int(step_stats["used_solve"])
            if ex is not None:
                sp.task_solve = {k: bool(p.used_solve)
                                 for k, p in ex.plans.items()}
                if ex.solve_backends:
                    sp.decode_backend = next(iter(ex.solve_backends))
            sp.tok_by_slot = tok_by_slot
            sp.used_solve = step_stats["used_solve"]
            sp.max_err = step_stats["max_err"]
            sp.argmax_ok = step_stats["argmax_ok"]
            sp.executed = True

        def begin_step(m: int, t: float, relax: bool) -> bool:
            st = states[m]
            if not any(len(s.tokens) < s.gen_len
                       for s in st.slots.values()):
                return False
            timing = plan_timing(m, t, relax)
            if timing is None:
                if fsched is not None:
                    # an injected crash/drop can kill this dispatch's
                    # coverage outright; retry on a fresh dispatch id (a
                    # fresh fault draw) instead of deadlocking the master
                    t_tok = float(planner.plan.t_per_master[m])
                    dt = t_tok if math.isfinite(t_tok) and t_tok > 0 \
                        else 1.0
                    heapq.heappush(heap, (t + dt, next(seq), _RETRY, m))
                return False
            k_row, b_row, barrier, entry, marks = timing
            pool.acquire(k_row, b_row)
            sp = _Step(
                k_row=k_row, b_row=b_row, barrier=barrier, t_start=t,
                t_acquire=t, t_done=barrier.completion,
                version=next(version_seq), tok_by_slot={},
                rows_dispatched=barrier.rows_dispatched(),
                rows_needed=float(sum(task.need for task in barrier.tasks)),
                used_solve=False, max_err=0.0, argmax_ok=0,
                planned_slots=frozenset(st.slots), entry=entry,
                fault_marks=marks)
            st.step = sp
            if self.execution == "serial":
                execute_step(m, sp)
            heapq.heappush(heap, (sp.t_done, next(seq), _STEP,
                                  (m, sp.version)))
            return True

        def redispatch_step(m: int, t: float) -> bool:
            """Re-time a coverage-lost in-flight step on the current plan.

            MDS decode is prefix-independent, so the step's greedy tokens
            are the same whichever covering prefix executes: the serial
            engine already decoded them at dispatch and only the *timing*
            is re-dispatched (fresh shards, fresh delays, new completion);
            the batched engine hasn't executed yet and will plan against
            the fresh barrier when the new completion fires.  The caller
            has already released the old shares."""
            st = states[m]
            sp = st.step
            timing = plan_timing(m, t, relax=True)
            sp.version = next(version_seq)
            if timing is None:
                sp.stalled = True
                if fsched is not None:
                    t_tok = float(planner.plan.t_per_master[m])
                    dt = t_tok if math.isfinite(t_tok) and t_tok > 0 \
                        else 1.0
                    heapq.heappush(heap, (t + dt, next(seq), _RETRY, m))
                return False
            k_row, b_row, barrier, entry, marks = timing
            pool.acquire(k_row, b_row)
            sp.k_row, sp.b_row, sp.barrier = k_row, b_row, barrier
            sp.entry = entry
            sp.fault_marks = marks
            sp.t_acquire = t
            sp.t_done = barrier.completion
            sp.rows_dispatched += barrier.rows_dispatched()
            sp.stalled = False
            sp.redispatches += 1
            stats["redispatches"] += 1
            heapq.heappush(heap, (sp.t_done, next(seq), _STEP,
                                  (m, sp.version)))
            return True

        def pump(t: float, relax: bool = False) -> bool:
            started = False
            for m in range(self.M):
                st = states[m]
                if st.step is not None and st.step.stalled:
                    started |= redispatch_step(m, t)
                elif st.step is None and st.slots:
                    started |= begin_step(m, t, relax)
            return started

        def step_done(payload: Tuple[int, int], t: float) -> None:
            m, version = payload
            st = states[m]
            sp = st.step
            if sp is None or sp.version != version:
                return                      # stale (churn re-timed the step)
            if not sp.executed:
                # batched engine: the whole barrier executes now, once, at
                # completion — packed stage products over the frozen plans
                execute_step(m, sp)
            st.step = None
            pool.release(sp.k_row, sp.b_row)
            metrics.record_share_interval(sp.k_row, sp.b_row,
                                          t - sp.t_acquire)
            delivered = sp.barrier.rows_delivered_by(t)
            ntok = sum(len(v) for v in sp.tok_by_slot.values())
            stats["tokens"] += ntok
            # covering-prefix attribution: the step completed at the max of
            # its tasks' earliest covering prefixes — name the task and the
            # worker whose delivery closed that prefix (the straggler the
            # whole barrier waited for)
            crit_task, crit_worker = "", -1
            done_tasks = [task for task in sp.barrier.tasks
                          if np.isfinite(task.completion)]
            if done_tasks:
                ct = max(done_tasks, key=lambda task: task.completion)
                crit_task = ct.name
                eps = 1e-9 * max(1.0, abs(ct.completion))
                hit = np.nonzero((ct.l_int > 0) & np.isfinite(ct.finish)
                                 & (np.abs(ct.finish - ct.completion)
                                    <= eps))[0]
                if hit.size:
                    crit_worker = int(hit[0])
            if crit_worker > 0:
                # repeated-straggler feedback: the planner's suspect
                # signal (shifts load off the worker at suspect_after
                # hits) and the ledger's localisation prior
                planner.note_critical(crit_worker)
                if ledger is not None:
                    ledger.note_critical(crit_worker)
            # confirmed Byzantine culprits: quarantine through the churn
            # path at completion time (same sim behavior for both engines
            # — the serial engine diagnosed eagerly at dispatch)
            for w in sp.culprits:
                quarantine_worker(w, t)
            decode_modes[sp.decode_mode] = \
                decode_modes.get(sp.decode_mode, 0) + 1
            if sp.fault_marks:
                fstats["corrupt_steps"] += 1
                if sp.corrupt_hit:
                    fstats["corrupt_applied"] += 1
                    if sp.faults_detected:
                        fstats["detected_steps"] += 1
            step_log.append({
                "master": m, "scope": self.coding_scope,
                "execution": self.execution,
                "decode_backend": sp.decode_backend or eff_decode,
                "backend": self.head.backend,   # effective, post-fallback
                "parity_storage": self.parity_storage,
                "t_start": sp.t_start, "t_done": t,
                "batch": len(sp.tok_by_slot), "tokens": ntok,
                "n_tasks": len(sp.barrier.tasks),
                "rows_dispatched": sp.rows_dispatched,
                "rows_delivered": delivered, "used_solve": sp.used_solve,
                "redispatches": sp.redispatches, "max_err": sp.max_err,
                "critical_task": crit_task, "critical_worker": crit_worker,
                "decode_mode": sp.decode_mode,
                "faults_detected": sp.faults_detected,
                "rows_rejected": sp.rows_rejected, "retries": sp.retries,
            })
            tr = current_tracer()
            if tr is not None:
                tr.add_span(f"step:m{m}", sp.t_acquire, t, cat="sim_step",
                            track=f"sim:m{m}",
                            args={"master": m, "tokens": ntok,
                                  "batch": len(sp.tok_by_slot),
                                  "redispatches": sp.redispatches,
                                  "critical_task": crit_task,
                                  "critical_worker": crit_worker})
                for task in sp.barrier.tasks:
                    solved = sp.task_solve.get(task.name)
                    if solved is not None:
                        tr.count("decode_parity" if solved
                                 else "decode_systematic", t=t, track="sim")
                    comp = task.completion
                    ok = np.isfinite(comp)
                    eps = 1e-9 * max(1.0, abs(comp)) if ok else 0.0
                    for n in np.nonzero(task.l_int > 0)[0]:
                        fin = float(task.finish[n])
                        if not np.isfinite(fin):
                            continue
                        tr.add_span(
                            f"{task.name}/w{n}", sp.t_acquire, fin,
                            cat="delivery", track=f"sim:worker{n}",
                            args={"worker": int(n), "task": task.name,
                                  "master": m, "rows": int(task.l_int[n]),
                                  "in_prefix": bool(ok and fin
                                                    <= comp + eps),
                                  "critical": bool(ok and abs(fin - comp)
                                                   <= eps)})
            for sid, toks in sp.tok_by_slot.items():
                slot = st.slots[sid]
                tokens_out.setdefault(slot.rid, []).extend(toks)
                rec = recs[slot.rid]
                share = len(toks) / max(ntok, 1)
                rec.rows_needed += sp.rows_needed * share
                rec.rows_total += sp.rows_dispatched * share
                rec.rows_delivered += delivered * share
                if len(slot.tokens) >= slot.gen_len:
                    rec.t_complete = t
                    metrics.record_task(rec)
                    del st.slots[sid]
                    st.free.append(sid)
            admit(t)
            pump(t)

        def on_arrive(r: ServeRequest, t: float) -> None:
            plan = planner.ensure_plan(online(), scale, event=True)
            t_tok = float(plan.t_per_master[r.master])
            deadline = math.inf
            if math.isfinite(r.slack) and math.isfinite(t_tok):
                deadline = t + r.slack * r.gen_len * t_tok
            rec = TaskRecord(tid=r.rid, master=r.master, t_arrive=t,
                             deadline=deadline)
            recs[r.rid] = rec
            if not queue.offer(r.rid, master=r.master, deadline=deadline):
                del recs[r.rid], reqs[r.rid]    # backpressure rejection
                return
            admit(t)
            pump(t)

        def on_churn(ev: WorkerEvent, t: float) -> None:
            nonlocal sc_eff
            undo = scale[ev.worker]
            reason = "churn"
            if ev.kind in ("leave", "crash"):
                pool.set_online(ev.worker, False)
                if ev.kind == "crash" and ledger is not None \
                        and ev.worker in ledger.readmit_at:
                    reason = "quarantine"
            elif ev.kind == "join":
                if ledger is not None and ev.worker in ledger.readmit_at:
                    # backoff readmission of a quarantined worker
                    ledger.readmit(ev.worker)
                    reason = "readmit"
                pool.set_online(ev.worker, True)
            elif ev.kind == "degrade":
                scale[ev.worker] *= ev.factor
            elif ev.kind == "restore":
                scale[ev.worker] = 1.0
            sc_eff = planner.effective_scenario(online(), scale)
            if cache is not None:
                # frozen splits/prefixes derive from the pre-churn pool;
                # in-flight steps detect their entry went stale via the
                # epoch bump and rebuild from their retimed barriers
                cache.invalidate(reason)
                cache.set_context(_scenario_ctx(sc_eff))
            planner.ensure_plan(online(), scale, event=True)
            # re-time in-flight steps' per-layer tasks (the engine's path)
            if ev.kind in ("leave", "crash", "degrade", "restore"):
                for m2 in range(self.M):
                    sp = states[m2].step
                    if sp is None or sp.stalled:
                        continue
                    if not sp.barrier.retime(ev.worker, ev.kind, t,
                                             factor=ev.factor, undo=undo):
                        continue
                    sp.version = next(version_seq)
                    comp = sp.barrier.completion
                    if np.isfinite(comp):
                        sp.t_done = max(comp, t)
                        heapq.heappush(heap, (sp.t_done, next(seq), _STEP,
                                              (m2, sp.version)))
                    else:
                        # coverage lost: release and re-dispatch the timing
                        pool.release(sp.k_row, sp.b_row)
                        metrics.record_share_interval(
                            sp.k_row, sp.b_row, t - sp.t_acquire)
                        redispatch_step(m2, t)
            admit(t)
            pump(t)

        # ---- event loop --------------------------------------------------

        now = 0.0
        while True:
            if not heap:
                # forward-progress fallback: relax fairness/min-fraction so
                # leftover work cannot deadlock against its own reservation
                if has_work() and pump(now, relax=True):
                    continue
                break
            now, _, kind, payload = heapq.heappop(heap)
            if kind == _ARRIVE:
                on_arrive(payload, now)
            elif kind == _CHURN:
                on_churn(payload, now)
            elif kind == _RETRY:
                # fault-killed dispatch: try again (no-op if the master
                # started a step through some other event meanwhile)
                admit(now)
                pump(now)
            else:
                step_done(payload, now)

        metrics.replans = planner.replans
        metrics.rejected = queue.rejected
        metrics.unserved = len(queue) + sum(len(st.slots) for st in states)
        for rid in queue.candidates():
            metrics.record_unserved(recs[rid])
        for st in states:
            for slot in st.slots.values():
                metrics.record_unserved(recs[slot.rid])
        # float64 end to end on numpy; torch encodes the parity block in
        # float32, and the deeper scopes run hundreds of small mixed-row
        # solves per serve whose random Gaussian sub-blocks occasionally
        # draw a small least singular value — the relative error of an
        # exact solve against float32-encoded parity rows then spikes to
        # ~1e-2 on unlucky steps (MIN_PARITY_BLOCK bounds the worst tiny-
        # block cases; the tail of larger blocks is irreducible without a
        # least-squares decode).  Tokens are still bit-checked — argmax
        # parity with the uncoded pipeline is the real invariant.
        if self.backend == "numpy":
            tol = 1e-6
        else:
            tol = 5e-4 if self.coding_scope == "head" else 2e-2
        match_rate = stats["match"] / max(stats["total"], 1)
        verifying = self.verify and self.coded
        fault_report = None
        if faults is not None:
            # headline rates: a corruption "applies" when the marked
            # worker's rows actually reached some decode or surplus check
            # (an unused worker corrupts nothing — nothing to detect)
            fault_report = {k: float(v) for k, v in fstats.items()}
            fault_report.update(
                detection_rate=(fstats["detected_steps"]
                                / fstats["corrupt_applied"])
                if fstats["corrupt_applied"] else 1.0,
                localization_rate=(fstats["localized"]
                                   / fstats["detected"])
                if fstats["detected"] else 1.0,
                quarantines=float(ledger.quarantines),
                readmissions=float(ledger.readmissions),
                degraded_steps=float(decode_modes.get("degraded", 0)),
                suspect_replans=float(planner.suspect_replans),
            )
        return ServeReport(
            metrics=metrics,
            tokens=tokens_out,
            steps=step_log,
            policy=self.admission.policy,
            coding_scope=self.coding_scope,
            max_err=stats["max_err"] if verifying else float("nan"),
            argmax_match_rate=match_rate,
            decode_ok=(stats["max_err"] <= tol and match_rate == 1.0)
            if verifying else None,
            wall_seconds=time.perf_counter() - t_wall,
            tokens_generated=stats["tokens"],
            solve_steps=stats["solves"],
            execution=self.execution,
            decode_backend=eff_decode,
            backend=self.backend,
            backend_effective=self.head.backend,
            parity_storage=self.parity_storage,
            redispatches=stats["redispatches"],
            sim_horizon_ms=max([metrics.t_end]
                               + [s["t_done"] for s in step_log]),
            plan_cache_hits=cache.hits - cache0[0] if cache else 0,
            plan_cache_misses=cache.misses - cache0[1] if cache else 0,
            plan_cache_invalidations=cache.invalidations - cache0[2]
            if cache else 0,
            decode_modes=dict(decode_modes)
            if (faults is not None or self.ls_tail) else None,
            faults=fault_report,
        )
