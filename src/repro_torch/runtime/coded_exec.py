"""Straggler-aware coded matmul executor — the paper's full workflow as an
executable engine; the port of ``repro.runtime.coded_exec``.

Pipeline per master m (paper §II): Theorem-1/2 loads → MDS encode (the
hand-written ``mds_encode`` kernel on the card) → per-worker partial
products (the batched ``coded_matvec`` kernel) → workers "arrive" at
sampled (comm + comp) delays → the master decodes from the earliest prefix
reaching L_m rows → completion time = that prefix's last arrival.

This is simultaneously (a) the simulation backend for the paper's Fig. 2-6/8
(numerically exact completion delays), and (b) the fault-tolerance engine:
``run`` simply never waits for workers outside the decoding prefix, so a
dead worker (delay = inf) costs nothing once redundancy covers its load.

``run`` builds **one stacked problem over the master axis** and calls the
shared :mod:`repro.stream.backend` once per stage: a batched encode, a
single ``completion_times`` call over all masters, and a single
``decode_batch`` (with its systematic-prefix fast path) for every master
that completes.  On the default numpy backend this is bit-for-bit equal to
the legacy per-master loop — kept as :meth:`CodedExecutor._run_loop` and
asserted by the equivalence tests.  ``backend="torch"`` (in place of the
reference's ``"jax"`` and ``"pallas"``) runs the encode, the coded
products and the decode on ``device`` in float64, so it is held to the
numpy path's 1e-6 verification tolerance: the reference's float32 device
paths fail ``decode_ok`` from L ≈ 2000 rows, and the paper's L is 1e4.
All randomness stays on the host in the reference's draw order, so
completion times and decode prefixes equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import mds
from ..core.delays import sample_total
from ..core.problem import Plan, Scenario
from ..device import resolve_device
from ..obs import device_span
from ..stream.backend import check_backend, completion_times, decode_batch

__all__ = ["CodedExecutor", "ExecutionReport"]


@dataclasses.dataclass
class ExecutionReport:
    completion: np.ndarray           # (M,) completion time of each master
    used_nodes: List[np.ndarray]     # per-master node ids in the decode prefix
    decode_ok: np.ndarray            # (M,) bool — result verified vs A x
    max_err: np.ndarray              # (M,) max |ŷ - A x|
    redundancy: np.ndarray           # (M,) Σl / L

    @property
    def overall(self) -> float:
        return float(self.completion.max())


@dataclasses.dataclass
class _MasterProblem:
    """One master's prepared (encoded-side) problem, pre-numerics."""
    m: int
    A: np.ndarray
    x: np.ndarray
    L: int
    L_tilde: int
    G: np.ndarray                    # (max(L_tilde, L), L)
    rows_L: Optional[np.ndarray]     # (L,) received row ids, None if DNF
    prefix: np.ndarray               # node ids in the decode prefix
    node_rows: List[Tuple[int, np.ndarray]]  # (node, its row slice) in order


class CodedExecutor:
    """Executes one realization of the coded multi-master computation.

    backend: "numpy" (default; bit-for-bit with the legacy per-master
    loop) or "torch" (encode / product kernels from
    ``repro_torch.kernels`` and the decode on ``device``, float64
    throughout).  ``verify_tol`` is the relative decode-verification
    tolerance, 1e-6 on both.  ``device`` defaults to ``cuda`` and raises
    without a card; the CPU runs the kernels' plain versions.
    """

    def __init__(self, sc: Scenario, plan: Plan, *,
                 generator_kind: str = "systematic",
                 rng: np.random.Generator | int = 0,
                 backend: str = "numpy",
                 verify_tol: Optional[float] = None,
                 device=None):
        self.sc = sc
        self.plan = plan
        self.rng = (np.random.default_rng(rng)
                    if not isinstance(rng, np.random.Generator) else rng)
        self.generator_kind = generator_kind
        self.backend = check_backend(backend)
        self.device = resolve_device(device)
        self.verify_tol = 1e-6 if verify_tol is None else verify_tol

    # ------------------------------------------------------------- staging

    def _prepare(self, A_list, x_list, dead_workers
                 ) -> Tuple[np.ndarray, List[_MasterProblem]]:
        """Sample delays, draw generators, and resolve every master's decode
        prefix — all randomness happens here, in the legacy draw order."""
        sc, plan = self.sc, self.plan
        loads = mds.integer_loads(plan.l, 0)

        delays = sample_total(self.rng, (), plan.l, plan.k, plan.b,
                              sc.a, sc.u, sc.gamma, local_col0=True)
        for w in dead_workers:
            delays[:, w] = np.inf
        # A NaN delay (poisoned sample) means "never arrives", same as a dead
        # worker — fold both into inf so ordering and prefix logic are exact.
        delays = np.where(np.isnan(delays), np.inf, delays)

        need = np.array([np.asarray(A).shape[0] for A in A_list],
                        dtype=np.float64)
        # one batched completion call over the master axis
        completion = completion_times(delays, loads.astype(np.float64), need)

        problems: List[_MasterProblem] = []
        for m in range(sc.M):
            A, x = np.asarray(A_list[m]), np.asarray(x_list[m])
            L = A.shape[0]
            lm = loads[m]
            active = np.nonzero(lm > 0)[0]
            L_tilde = int(lm[active].sum())
            G = mds.make_generator(L, max(L_tilde, L),
                                   kind=self.generator_kind,
                                   rng=self.rng, dtype=np.float64)
            slices = mds.split_loads(L_tilde, lm[active])
            # prefix bookkeeping: earliest arrivals until >= L rows.  A dead
            # or NaN worker ranked anywhere in the sort is *skipped* (it
            # never arrives); the live workers behind it still count.
            d_act = delays[m, active]
            finite = np.isfinite(d_act)
            order_j = np.argsort(np.where(finite, d_act, np.inf),
                                 kind="stable")
            got_rows: List[np.ndarray] = []
            node_rows: List[Tuple[int, np.ndarray]] = []
            prefix: List[int] = []
            acc = 0
            for j in order_j:
                if not finite[j]:
                    break           # only non-arrivals remain past this point
                n = int(active[j])
                got_rows.append(slices[j])
                node_rows.append((n, slices[j]))
                prefix.append(n)
                acc += slices[j].size
                if acc >= L:
                    break
            rows_L = (np.concatenate(got_rows)[:L] if acc >= L else None)
            problems.append(_MasterProblem(
                m=m, A=A, x=x, L=L, L_tilde=L_tilde, G=G, rows_L=rows_L,
                prefix=np.array(prefix), node_rows=node_rows))
        return completion, problems

    # ------------------------------------------------------------ numerics

    def _encode_products_np(self, p: _MasterProblem) -> np.ndarray:
        """(L,) received results for one master — legacy-exact numerics.

        Encode and per-node partial products run at the legacy loop's exact
        shapes (``G[:L̃] @ A`` then one gemv per prefix node), so the numpy
        path stays bit-for-bit; only nodes inside the decode prefix are
        computed (the legacy loop also multiplied never-used nodes)."""
        A_tilde = mds.encode(p.G[:p.L_tilde], p.A)
        parts = [A_tilde[idx] @ p.x for _, idx in p.node_rows]
        return np.concatenate(parts)[:p.L]

    def _encode_products_dev(self, group: List[_MasterProblem]) -> np.ndarray:
        """(B, L) received results for one same-shape group of masters, all
        stacked on the card in float64: one ``mds_encode`` launch for the
        group's encode, one ``coded_matvec`` launch for its coded products,
        one gather of the received rows, one host transfer out."""
        from ..kernels import ops
        dev, f64 = self.device, torch.float64
        p0 = group[0]
        B, Lt = len(group), p0.L_tilde

        def stack(arrs, shape):
            out = torch.empty((B,) + shape, dtype=f64, device=dev)
            for i, a in enumerate(arrs):
                out[i].copy_(torch.from_numpy(
                    np.ascontiguousarray(a, dtype=np.float64)))
            return out

        G = stack([p.G[:Lt] for p in group], (Lt, p0.L))
        A = stack([p.A for p in group], p0.A.shape)
        x = stack([p.x for p in group], p0.x.shape)
        with device_span("executor:encode", cat="kernel",
                         args={"tasks": B, "rows": Lt}) as fence:
            A_tilde = fence(ops.mds_encode_batch(
                G, A, systematic=self.generator_kind == "systematic"))
        del G, A
        with device_span("executor:products", cat="kernel",
                         args={"tasks": B, "rows": Lt}) as fence:
            y_full = fence(ops.coded_matvec_batch(A_tilde, x))
        del A_tilde
        rows = torch.from_numpy(
            np.stack([p.rows_L for p in group]).astype(np.int64)).to(dev)
        if y_full.dim() == 3:                  # matrix right-hand sides
            rows = rows[..., None]
        return torch.take_along_dim(y_full, rows, dim=1).cpu().numpy()

    # ----------------------------------------------------------------- run

    def run(self, A_list: Sequence[np.ndarray], x_list: Sequence[np.ndarray],
            dead_workers: Sequence[int] = (),
            ) -> Tuple[List[np.ndarray], ExecutionReport]:
        """Compute A_m x_m for every master through the coded pipeline.

        ``dead_workers`` are 1-based worker columns that never respond
        (fault injection)."""
        sc, plan = self.sc, self.plan
        completion, problems = self._prepare(A_list, x_list, dead_workers)
        results: List[Optional[np.ndarray]] = [None] * sc.M
        ok = np.zeros(sc.M, bool)
        errs = np.zeros(sc.M)

        # group completed masters by problem shape → one stacked decode (and,
        # off-numpy, one stacked encode/product) per group.  The numpy path
        # only needs a common L to share the decode, so it groups coarser.
        groups: Dict[Tuple[int, ...], List[_MasterProblem]] = {}
        for p in problems:
            if p.rows_L is None:
                results[p.m] = np.full(p.L, np.nan)
                continue
            key = ((p.L, p.x.shape[1:]) if self.backend == "numpy"
                   else (p.L, p.L_tilde, p.A.shape[1], p.x.shape[1:]))
            groups.setdefault(key, []).append(p)

        for group in groups.values():
            if self.backend == "numpy":
                y_sel = np.stack([self._encode_products_np(p)
                                  for p in group])
            else:
                y_sel = self._encode_products_dev(group)
            rows = np.stack([p.rows_L for p in group])
            # "prefix" (scatter fast path only, full solve for mixed tasks)
            # keeps the bit-for-bit contract with the legacy _run_loop's
            # per-task mds.decode; the mixed-row substitution path is for
            # the streaming/serving decoders, which verify by tolerance.
            y_hat = decode_batch(
                [p.G for p in group], rows, y_sel, systematic="prefix",
                backend=self.backend, device=self.device)
            for i, p in enumerate(group):
                truth = p.A @ p.x
                results[p.m] = y_hat[i]
                errs[p.m] = float(np.max(np.abs(y_hat[i] - truth)))
                ok[p.m] = errs[p.m] <= self.verify_tol * \
                    (1 + float(np.max(np.abs(truth))))

        report = ExecutionReport(
            completion=completion, used_nodes=[p.prefix for p in problems],
            decode_ok=ok, max_err=errs,
            redundancy=plan.l.sum(axis=1) / sc.L)
        return list(results), report

    # -------------------------------------------------- reference (legacy)

    def _run_loop(self, A_list: Sequence[np.ndarray],
                  x_list: Sequence[np.ndarray],
                  dead_workers: Sequence[int] = (),
                  ) -> Tuple[List[np.ndarray], ExecutionReport]:
        """The original per-master Python loop, kept verbatim as the
        reference implementation: the equivalence tests assert ``run`` (on
        the numpy backend) reproduces it bit-for-bit from the same seed."""
        sc, plan = self.sc, self.plan
        loads = mds.integer_loads(plan.l, 0)
        results: List[np.ndarray] = []
        completion = np.zeros(sc.M)
        used, ok, errs = [], np.zeros(sc.M, bool), np.zeros(sc.M)

        delays = sample_total(self.rng, (), plan.l, plan.k, plan.b,
                              sc.a, sc.u, sc.gamma, local_col0=True)
        for w in dead_workers:
            delays[:, w] = np.inf
        delays = np.where(np.isnan(delays), np.inf, delays)

        for m in range(sc.M):
            A, x = np.asarray(A_list[m]), np.asarray(x_list[m])
            L = A.shape[0]
            lm = loads[m]
            active = np.nonzero(lm > 0)[0]
            L_tilde = int(lm[active].sum())
            G = mds.make_generator(L, max(L_tilde, L),
                                   kind=self.generator_kind,
                                   rng=self.rng, dtype=np.float64)
            slices = mds.split_loads(L_tilde, lm[active])
            A_tilde = mds.encode(G[:L_tilde], A)
            y_parts = {int(n): A_tilde[rows] @ x
                       for n, rows in zip(active, slices)}

            d_act = delays[m, active]
            finite = np.isfinite(d_act)
            order_j = np.argsort(np.where(finite, d_act, np.inf),
                                 kind="stable")
            got_rows: List[np.ndarray] = []
            got_y: List[np.ndarray] = []
            acc = 0
            t_done = np.inf
            prefix = []
            for j in order_j:
                if not finite[j]:
                    break
                n = int(active[j])
                idx = slices[j]
                got_rows.append(idx)
                got_y.append(y_parts[n])
                prefix.append(n)
                acc += idx.size
                if acc >= L:
                    t_done = d_act[j]
                    break
            completion[m] = t_done
            used.append(np.array(prefix))
            if acc >= L:
                rows = np.concatenate(got_rows)[:max(L, 0)]
                ys = np.concatenate(got_y)[:rows.size]
                rows_L, ys_L = rows[:L], ys[:L]
                y_hat = mds.decode(G[:L_tilde], rows_L, ys_L)
                truth = A @ x
                errs[m] = float(np.max(np.abs(y_hat - truth)))
                ok[m] = errs[m] <= 1e-6 * (1 + float(np.max(np.abs(truth))))
                results.append(y_hat)
            else:
                results.append(np.full(L, np.nan))

        report = ExecutionReport(
            completion=completion, used_nodes=used, decode_ok=ok,
            max_err=errs, redundancy=plan.l.sum(axis=1) / sc.L)
        return results, report
