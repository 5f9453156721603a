"""Batched numerics shared by the coded-serving layer — the port of
``repro.stream.backend``.

Two backends:

* ``numpy`` — the authoritative reference, copied from ``repro``.  Batched
  sort + cumsum over the node axis, stacked LAPACK decode (cached getrf +
  per-step getrs).
* ``torch`` — the device engine, in place of the reference's jax branch.
  Completion runs as a stable ``torch.sort`` + cumsum, and the decode
  solves run in float64 with ``torch.linalg`` (``lu_factor`` once per
  frozen plan, ``lu_solve`` per step; ``lstsq`` for the least-squares
  tail) on the given device (default ``cuda``).  The reference's solve is
  ``jnp.linalg.solve``, not a Pallas kernel, so a library solve is its
  counterpart.

The Monte-Carlo sampler (``simulate_batch``) runs the numpy Generator loop
(``simulate_chunks_np``, the reference's, bit-stable) or, on ``torch``,
the counterpart of the reference's jitted kernel: per-master active-node
gathers, exponential draws from a seeded ``torch.Generator`` on the
device and the completion rule as a sort + cumsum, in bounded chunks.

Public entry points:

* ``completion_times`` — earliest time the cumulative received coded rows
  reach L, batched over any leading axes (realizations, masters, tasks).
  NaN and ±inf delays are "never arrives" instead of poisoning the prefix.
* ``sample_delays`` — turn pre-drawn Exp(1) variates into T = T_tr + T_cp
  delays, with optional heavy-tail ``straggle_p``/``straggle_factor``
  throttling (burstable-instance CPU-credit exhaustion).
* ``simulate_batch`` — (trials, M) Monte-Carlo completion delays for a full
  plan in one call; the device path behind
  ``sim.simulate_plan(backend="torch")``.
* ``decode_batch`` — batched exactly-L MDS decode with a systematic-prefix
  fast path: when the generator's top L rows are the identity and a task
  received only those rows, the "solve" is a row permutation and is applied
  by a scatter (bit-identical to LAPACK on a permutation matrix, no O(L^3)
  factorization).
* ``ExponentialBlock`` — block-amortised standard-exponential (and
  optionally uniform) draws so the event loop consumes pre-sampled
  randomness (deterministic replay, no per-event RNG overhead).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..obs import current_tracer, device_span

__all__ = [
    "completion_times",
    "delivered_by",
    "sample_delays",
    "simulate_batch",
    "simulate_chunks_np",
    "decode_batch",
    "plan_decode",
    "DecodePlan",
    "SystematicRows",
    "plan_decode_ls",
    "LSDecodePlan",
    "decode_ls_batch",
    "plan_verify",
    "VerifyPlan",
    "verify_decode",
    "localize_faulty_worker",
    "solve_stacked",
    "lu_factor_torch",
    "lu_solve_torch",
    "StackedLU",
    "ExponentialBlock",
]

_EPS = 1e-12
_LU_ONE_BY_ONE = 512      # StackedLU: factor systems this large singly
BACKENDS = ("numpy", "torch")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def as_f64(x, device: torch.device) -> torch.Tensor:
    """Host array or tensor → float64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(
        device)


# ---------------------------------------------------------------------------
# Completion times
# ---------------------------------------------------------------------------

def _completion_np(T: np.ndarray, loads: np.ndarray, need: np.ndarray,
                   needs_all: bool) -> np.ndarray:
    active = loads > 0
    # NaN (poisoned sample) and inf (dead worker) both mean "never arrives".
    Ti = np.where(active & np.isfinite(T), T, np.inf)
    if needs_all:
        out = np.where(active, Ti, -np.inf).max(axis=-1)
        out = np.where(active.any(axis=-1), out, np.inf)
        return np.where(np.isfinite(out), out, np.inf)
    order = np.argsort(Ti, axis=-1, kind="stable")
    T_s = np.take_along_axis(Ti, order, axis=-1)
    l_s = np.take_along_axis(np.where(active, loads, 0.0), order, axis=-1)
    cum = np.cumsum(l_s, axis=-1)
    hit = cum >= need[..., None] - 1e-9
    first = np.argmax(hit, axis=-1)
    reachable = np.take_along_axis(hit, first[..., None], axis=-1)[..., 0]
    out = np.take_along_axis(T_s, first[..., None], axis=-1)[..., 0]
    return np.where(reachable & np.isfinite(out), out, np.inf)


def _completion_torch(T: torch.Tensor, loads: torch.Tensor,
                      need: torch.Tensor, needs_all: bool,
                      rel: float = 0.0) -> torch.Tensor:
    """The numpy rule on tensors (stable sort, cumsum, first hit).

    ``rel`` widens the ``need - 1e-9`` threshold by ``rel * need``: the
    float32 Monte-Carlo path absorbs its cumsum rounding with it when the
    coverage is exact (0 keeps the float64 rule bit for bit)."""
    inf = torch.tensor(float("inf"), dtype=T.dtype, device=T.device)
    active = loads > 0
    Ti = torch.where(active & torch.isfinite(T), T, inf)
    if needs_all:
        out = torch.where(active, Ti, -inf).amax(dim=-1)
        out = torch.where(active.any(dim=-1), out, inf)
        return torch.where(torch.isfinite(out), out, inf)
    T_s, order = torch.sort(Ti, dim=-1, stable=True)
    l_s = torch.gather(torch.where(active, loads, torch.zeros_like(loads)),
                       -1, order)
    cum = torch.cumsum(l_s, dim=-1)
    hit = cum >= need[..., None] - 1e-9 - rel * need[..., None]
    first = torch.argmax(hit.to(torch.uint8), dim=-1)
    ok = torch.gather(hit, -1, first[..., None])[..., 0]
    out = torch.gather(T_s, -1, first[..., None])[..., 0]
    return torch.where(ok & torch.isfinite(out), out, inf)


def completion_times(T, loads, need, *, needs_all: bool = False,
                     backend: str = "numpy", device=None) -> np.ndarray:
    """Earliest t per batch row with Σ_{n: T_n <= t} l_n >= need.

    T:     (..., K) arrival times (absolute or relative — any monotone scale).
    loads: broadcastable to T; zero-load nodes are ignored.
    need:  broadcastable to T's leading axes.
    needs_all: the uncoded rule — wait for *every* positive-load node.

    Non-finite delays (inf dead workers, NaN poisoned samples) never arrive:
    they are skipped by the prefix, and the result is inf only if the
    remaining live nodes cannot cover ``need``.

    The torch backend runs the same rule over the whole batch on
    ``device`` (default ``cuda``); the host boundary is a single transfer
    each way.
    """
    check_backend(backend)
    T = np.asarray(T, dtype=np.float64)
    loads = np.broadcast_to(np.asarray(loads, dtype=np.float64), T.shape)
    need = np.broadcast_to(np.asarray(need, dtype=np.float64), T.shape[:-1])
    if backend == "torch":
        dev = resolve_device(device)
        return _completion_torch(as_f64(T, dev), as_f64(loads, dev),
                                 as_f64(need, dev),
                                 bool(needs_all)).cpu().numpy()
    return _completion_np(T, loads, need, needs_all)


def delivered_by(T, loads, t) -> np.ndarray:
    """Rows delivered by time ``t``: Σ_{n: T_n <= t} l_n (batched)."""
    T = np.asarray(T, dtype=np.float64)
    loads = np.broadcast_to(np.asarray(loads, dtype=np.float64), T.shape)
    t = np.asarray(t, dtype=np.float64)
    arrived = np.isfinite(T) & (T <= t[..., None]) & (loads > 0)
    return np.where(arrived, loads, 0.0).sum(axis=-1)


# ---------------------------------------------------------------------------
# Delay sampling
# ---------------------------------------------------------------------------

def sample_delays(e_tr: np.ndarray, e_cp: np.ndarray, l, k, b, a, u, gamma,
                  *, local_col0: bool = True,
                  straggle_p: float = 0.0, straggle_factor: float = 8.0,
                  straggle_u: Optional[np.ndarray] = None) -> np.ndarray:
    """Turn standard-exponential draws into T = T_tr + T_cp delays.

    ``e_tr``/``e_cp`` are ~Exp(1) draws of the same (batched) shape as ``l``;
    the transformation matches ``repro_torch.core.delays.sample_total`` exactly, so
    an ``ExponentialBlock`` + ``sample_delays`` pipeline is distributionally
    identical to the legacy per-call sampler while being batchable and
    replayable.

    ``straggle_p`` / ``straggle_factor``: per-node probability that the node
    is in a degraded state for this task, multiplying its whole delay by
    ``factor`` — the heavy-tailed *measured* behaviour of burstable cloud
    instances (CPU-credit throttling) that the fitted shifted exponential
    underestimates.  ``straggle_u`` supplies the uniform draws (same shape
    as ``l``; see ``ExponentialBlock(uniform_rows=1)``) so replay stays
    deterministic.
    """
    l = np.asarray(l, dtype=np.float64)
    lsafe = np.maximum(l, _EPS)
    ksafe = np.maximum(k, _EPS)
    bsafe = np.maximum(b, _EPS)
    t_tr = e_tr * lsafe / (bsafe * gamma)
    if local_col0:
        t_tr = t_tr.copy()
        t_tr[..., 0] = 0.0
    t_cp = a * l / ksafe + e_cp * lsafe / (ksafe * u)
    total = t_tr + t_cp
    if straggle_p > 0.0:
        if straggle_u is None:
            raise ValueError("straggle_p > 0 requires straggle_u draws "
                             "(use ExponentialBlock(uniform_rows=1))")
        total = np.where(np.asarray(straggle_u) < straggle_p,
                         total * straggle_factor, total)
    return np.where(l > 0, total, 0.0)


class ExponentialBlock:
    """Pre-sampled Exp(1) (+ optional Uniform(0,1)) draws consumed row-by-row.

    The event loop needs one (2, N+1) standard-exponential row per admitted
    task (plus one uniform row when heavy-tail throttling is on); drawing
    them one event at a time costs a Generator call per event.  This draws
    ``block`` tasks' worth at once and hands out views — deterministic
    replay at block-amortised cost.
    """

    def __init__(self, rng: np.random.Generator, width: int,
                 block: int = 512, uniform_rows: int = 0):
        self.rng = rng
        self.width = int(width)
        self.block = int(block)
        self.uniform_rows = int(uniform_rows)
        self.rows = 2 + self.uniform_rows
        self._buf = np.empty((0, self.rows, self.width))
        self._pos = 0

    def _refill(self) -> None:
        exp = self.rng.exponential(
            1.0, size=(self.block, 2, self.width))
        if self.uniform_rows:
            uni = self.rng.random(
                size=(self.block, self.uniform_rows, self.width))
            self._buf = np.concatenate([exp, uni], axis=1)
        else:
            self._buf = exp
        self._pos = 0

    def draw(self) -> np.ndarray:
        if self._pos >= self._buf.shape[0]:
            self._refill()
        row = self._buf[self._pos]
        self._pos += 1
        return row

    def draw_n(self, n: int) -> np.ndarray:
        """``n`` consecutive draws as one (n, rows, width) view — the
        multi-task serving dispatch consumes one row per coded matmul and
        samples all of a step barrier's delays in a single batched
        :func:`sample_delays` call.  The stream is identical to ``n``
        successive :meth:`draw` calls."""
        if n <= 0:
            raise ValueError("draw_n needs n >= 1")
        if self._pos + n <= self._buf.shape[0]:
            out = self._buf[self._pos:self._pos + n]
            self._pos += n
            return out
        # keep the stream identical to n draw() calls: consume the tail,
        # then refill block-by-block for the remainder (n may exceed one
        # block — e.g. a deep trunk's 1 + 7·n_layers tasks per dispatch)
        parts = [self._buf[self._pos:]]
        need = n - parts[0].shape[0]
        while need > 0:
            self._refill()
            take = min(need, self._buf.shape[0])
            parts.append(self._buf[:take])
            self._pos = take
            need -= take
        return np.concatenate([p for p in parts if p.size])


# ---------------------------------------------------------------------------
# Monte-Carlo (sample + complete, device-resident on torch)
# ---------------------------------------------------------------------------

def _gather_active(l, k, b, a, u, gamma, dtype):
    """Per-master active-column gather → (idx, loads, c_tr, shift, c_cp).

    Returns (M, A) coefficient arrays with T = c_tr·e1 + shift + c_cp·e2;
    padded slots have shift = +inf (never arrive) and zero load.  Column 0
    (the master's local processor) gets c_tr = 0 — no communication.
    """
    M = l.shape[0]
    counts = (l > 0).sum(axis=1)
    A = max(int(counts.max()), 1)
    idx = np.zeros((M, A), dtype=np.int64)
    pad = np.ones((M, A), dtype=bool)
    for m in range(M):
        nz = np.nonzero(l[m] > 0)[0]
        idx[m, :nz.size] = nz
        pad[m, nz.size:] = False
    act = pad          # True where a real node sits
    ga = lambda arr: np.take_along_axis(np.asarray(arr, np.float64), idx, 1)
    l_a = np.where(act, ga(l), 0.0)
    k_a, b_a = ga(k), ga(b)
    a_a, u_a, g_a = ga(a), ga(u), ga(gamma)
    c_tr = np.where(act, l_a / np.maximum(b_a * g_a, _EPS), 0.0)
    c_tr[idx == 0] = 0.0                       # local node: no comm delay
    shift = np.where(act, a_a * l_a / np.maximum(k_a, _EPS), np.inf)
    c_cp = np.where(act, l_a / np.maximum(k_a * u_a, _EPS), 0.0)
    return (idx, l_a.astype(dtype), c_tr.astype(dtype),
            shift.astype(dtype), c_cp.astype(dtype))


def simulate_chunks_np(rng: np.random.Generator, l, k, b, a, u, gamma, L,
                       trials: int, *, needs_all: bool = False,
                       straggle_p: float = 0.0, straggle_factor: float = 8.0,
                       chunk: int = 20_000):
    """Yield (r, M) completion-delay chunks from the Generator-based
    sampler — the single numpy Monte-Carlo loop behind both
    ``simulate_batch(backend="numpy")`` and ``sim.montecarlo``'s
    streaming aggregation (bit-stable for a given Generator + chunk)."""
    from ..core.delays import sample_total
    l = np.asarray(l, dtype=np.float64)
    L = np.atleast_1d(np.asarray(L, dtype=np.float64))
    chunk = max(int(chunk), 1)
    done = 0
    while done < trials:
        r = min(chunk, trials - done)
        T = sample_total(rng, (r,), l, k, b, a, u, gamma, local_col0=True)
        if straggle_p > 0:
            throttled = rng.random(T.shape) < straggle_p
            T = np.where(throttled, T * straggle_factor, T)
        yield completion_times(T, l[None], L[None], needs_all=needs_all)
        done += r


def _simulate_torch(gen: torch.Generator, c_tr: torch.Tensor,
                    shift: torch.Tensor, c_cp: torch.Tensor,
                    loads: torch.Tensor, need: torch.Tensor, trials: int,
                    chunk: int, needs_all: bool, straggle_p: float,
                    straggle_factor: float) -> torch.Tensor:
    """(trials, M) completion delays on the tensors' device, ``chunk``
    trials at a time (every temporary is (chunk, M, A)).

    Each chunk draws its two (chunk, M, A) exponential blocks (and the
    throttling uniforms) from ``gen`` and completes them by the numpy
    rule: stable sort of the arrivals, cumsum of the loads, first hit."""
    dt = c_tr.dtype
    # need-1e-9 matches numpy; the relative term absorbs float32 cumsum
    # rounding when coverage is exact (never larger than a fraction of one
    # coded row at L ~ 1e4)
    rel = 1e-6 if dt == torch.float32 else 0.0
    M, A = c_tr.shape
    out = torch.empty((trials, M), dtype=dt, device=c_tr.device)
    for lo in range(0, trials, chunk):
        r = min(chunk, trials - lo)
        e = torch.empty((2, r, M, A), dtype=dt, device=c_tr.device)
        e.exponential_(generator=gen)
        T = c_tr * e[0] + shift + c_cp * e[1]          # padded nodes: +inf
        if straggle_p > 0:
            u01 = torch.rand((r, M, A), dtype=dt, device=c_tr.device,
                             generator=gen)
            T = torch.where(u01 < straggle_p, T * straggle_factor, T)
        out[lo:lo + r] = _completion_torch(T, loads.expand(r, M, A),
                                           need.expand(r, M), needs_all,
                                           rel=rel)
    return out


def simulate_batch(l, k, b, a, u, gamma, L, trials: int, *,
                   seed: "int | np.random.Generator" = 0,
                   needs_all: bool = False,
                   straggle_p: float = 0.0, straggle_factor: float = 8.0,
                   backend: str = "torch", dtype=torch.float32,
                   chunk: Optional[int] = None, device=None) -> np.ndarray:
    """(trials, M) Monte-Carlo completion delays for a full plan, one call.

    All inputs are the dense (M, N+1) plan/scenario arrays (column 0 = the
    master's local processor, communication-free).  The torch path runs
    on ``device`` (default ``cuda``) over each master's *active* worker
    columns (:func:`_gather_active`), ``chunk`` trials at a time (default
    65 536); float32 by default — delay-model rounding is orders of
    magnitude below Monte-Carlo noise at any trial count this path exists
    for — or float64 on request.  Its draws come from a
    ``torch.Generator`` seeded with the integer ``seed`` (drawn from it
    when a numpy Generator is passed), so results are reproducible on one
    device but *not* bit-equal to the numpy Generator stream — the two
    backends agree statistically, which is what the tests assert.

    ``backend="numpy"`` runs :func:`simulate_chunks_np` (default chunk
    4096; a Generator is also accepted as ``seed``, for bit-stable shared
    streams).
    """
    check_backend(backend)
    l = np.asarray(l, dtype=np.float64)
    trials = int(trials)
    if backend == "numpy":
        rng = (seed if isinstance(seed, np.random.Generator)
               else np.random.default_rng(seed))
        return np.concatenate(list(simulate_chunks_np(
            rng, l, k, b, a, u, gamma, L, trials, needs_all=needs_all,
            straggle_p=straggle_p, straggle_factor=straggle_factor,
            chunk=4096 if chunk is None else chunk)))
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    dev = resolve_device(device)
    if isinstance(seed, np.random.Generator):
        seed = int(seed.integers(np.iinfo(np.int64).max))
    L = np.atleast_1d(np.asarray(L, dtype=np.float64))
    _, l_a, c_tr, shift, c_cp = _gather_active(l, k, b, a, u, gamma,
                                               np.float64)
    t = lambda x: torch.from_numpy(np.array(x)).to(  # noqa
        device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    chunk = max(min(65_536 if chunk is None else int(chunk), trials), 1)
    # device_span fences only while a tracer records, so the launch queue
    # is untouched when tracing is off
    with device_span("simulate_batch", cat="kernel",
                     args={"trials": trials, "M": int(l.shape[0]),
                           "chunks": math.ceil(trials / chunk)}) as fence:
        comp = fence(_simulate_torch(
            gen, t(c_tr), t(shift), t(c_cp), t(l_a),
            t(np.broadcast_to(L, (l.shape[0],))), trials, chunk,
            bool(needs_all), float(straggle_p), float(straggle_factor)))
    return comp.to(torch.float64).cpu().numpy()


# ---------------------------------------------------------------------------
# Batched MDS decode
# ---------------------------------------------------------------------------

try:                                   # the gufunc behind np.linalg.solve
    from numpy.linalg import _umath_linalg as _gu
    _gu.solve(np.eye(2)[None], np.ones((1, 2, 1)), signature="dd->d")
except Exception:  # pragma: no cover - exotic numpy builds
    _gu = None


try:
    from scipy.linalg import lu_factor as _lu_factor, lu_solve as _lu_solve
    from scipy.linalg.lapack import dgetrs as _dgetrs
except Exception:  # pragma: no cover - no-scipy builds
    _lu_factor = _lu_solve = _dgetrs = None


class StackedLU:
    """Lazily cached LU factorization of stacked (g, n, n) systems.

    ``np.linalg.solve`` (LAPACK ``gesv``) re-factorizes on every call.  A
    *frozen* decode plan solves the same parity sub-blocks for every step
    of a serve with only the right-hand side changing, so the ``getrf``
    is paid once and each step replays the O(n²) ``getrs``.  Solutions
    are bit-identical to :func:`solve_stacked` — ``gesv`` *is*
    ``getrf`` + ``getrs`` — and both decode engines route through this,
    so they cannot drift from each other.  Falls back to the one-shot
    solve when scipy is unavailable.

    ``backend="torch"`` factors once with ``torch.linalg.lu_factor`` in
    float64 on ``device`` and replays ``lu_solve`` per right-hand side;
    it returns a tensor on ``device`` for a tensor ``b``, else a host
    array.  Systems of order ``_LU_ONE_BY_ONE`` or more are factored one
    at a time: the batched routines are built for small matrices, and the
    card ran the executor's 1e4-order minors about twice as fast singly.
    A column-major device ``A`` is factored in place.
    """

    __slots__ = ("A", "_fac", "_checked", "_tfac")

    def __init__(self, A: np.ndarray):
        self.A = A
        self._fac = None
        self._checked = False
        self._tfac = None

    def solve(self, b, *, backend: str = "numpy", device=None):
        if backend == "torch":
            out = self._solve_torch(b, resolve_device(device))
            return out if isinstance(b, torch.Tensor) else out.cpu().numpy()
        if _lu_factor is None:
            return solve_stacked(self.A, b)
        if self._fac is None:
            self._fac = [_lu_factor(a, check_finite=False) for a in self.A]
        # raw getrs: same triangular sweeps as lu_solve minus its per-call
        # argument validation (thousands of tiny serving solves per run)
        if len(self._fac) == 1:
            lu, piv = self._fac[0]
            out = _dgetrs(lu, piv, b[0])[0][None]
        else:
            out = np.empty(self.A.shape[:1] + b.shape[1:])
            for i, (lu, piv) in enumerate(self._fac):
                out[i] = _dgetrs(lu, piv, b[i])[0]
        # singularity is a property of the frozen matrices, not the RHS —
        # one finiteness pass on the first solve is enough
        if not self._checked:
            if not np.isfinite(out).all():
                raise np.linalg.LinAlgError("Singular matrix")
            self._checked = True
        return out

    def _solve_torch(self, b, device: torch.device) -> torch.Tensor:
        if self._tfac is None:
            A = as_f64(self.A, device)
            self._tfac = [lu_factor_torch(a) for a in A] \
                if A.shape[-1] >= _LU_ONE_BY_ONE else lu_factor_torch(A)
        b = as_f64(b, device)
        if isinstance(self._tfac, list):
            out = torch.stack([lu_solve_torch(f, b[i])
                               for i, f in enumerate(self._tfac)])
        else:
            out = lu_solve_torch(self._tfac, b)
        if not self._checked:
            if not bool(torch.isfinite(out).all()):
                raise np.linalg.LinAlgError("Singular matrix")
            self._checked = True
        return out


def lu_factor_torch(A: torch.Tensor):
    """``(LU, pivots)`` of a float64 or float32 (…, n, n) tensor via
    ``torch.linalg.lu_factor_ex``.

    When ``A`` is column-major in its last two dims (``A.mT`` contiguous)
    the factors are written into ``A``'s own storage — torch skips its
    input copy when the output is the input — so a minor the size of most
    of the card's memory is factored without a second copy.  Singular
    systems surface as non-finite solves (checked by the callers)."""
    piv = torch.empty(A.shape[:-1], dtype=torch.int32, device=A.device)
    info = torch.empty(A.shape[:-2], dtype=torch.int32, device=A.device)
    if A.mT.is_contiguous():
        LU, piv, _ = torch.linalg.lu_factor_ex(A, out=(A, piv, info))
    else:
        LU, piv, _ = torch.linalg.lu_factor_ex(A)
    return LU, piv


def lu_solve_torch(fac, b: torch.Tensor) -> torch.Tensor:
    """Solve with factors from :func:`lu_factor_torch`."""
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b)


def solve_stacked(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.linalg.solve(A, b)`` for stacked (g, n, n) · (g, n, C) systems,
    minus the per-call wrapper overhead.

    The serving decode issues thousands of tiny (n ≲ 50) solves per run;
    ``np.linalg.solve``'s Python wrapper (shape juggling, errstate, extobj
    plumbing) costs more than LAPACK ``gesv`` itself at those sizes.  This
    calls the same gufunc directly — results are bit-identical — and falls
    back to the public API when the private entry point is unavailable.
    Singular inputs still raise ``LinAlgError`` (the gufunc emits
    non-finite rows; the finiteness check costs one cheap pass, and a
    silent NaN would otherwise reach ``argmax`` as token 0 in the
    verify-off serving configuration).
    """
    if _gu is not None and A.dtype == np.float64 and b.dtype == np.float64:
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            out = _gu.solve(A, b, signature="dd->d")
        if not np.isfinite(out).all():
            raise np.linalg.LinAlgError("Singular matrix")
        return out
    return np.linalg.solve(A, b)


class SystematicRows:
    """Lazy row-view of a systematic generator ``[I; R]`` — no dense G.

    Virtual parity storage keeps no materialised generator; what decode
    planning actually consumes is *rows* of G (the mixed groups' square
    minors, the full-solve gathers).  This adapter satisfies exactly that:
    ``take(rows)`` synthesises identity rows for indices < L and asks
    ``parity_rows_fn(ids)`` (e.g. :meth:`CodedLinear.parity_rows`, the
    counter derivation) for the rest.  ``plan_decode`` accepts it wherever
    a shared 2-D generator is accepted; the identity prefix holds by
    construction.
    """

    __slots__ = ("L", "total", "parity_rows_fn")
    ndim = 2

    def __init__(self, L: int, total: int, parity_rows_fn):
        self.L = int(L)
        self.total = int(total)
        self.parity_rows_fn = parity_rows_fn

    @property
    def shape(self):
        return (self.total, self.L)

    def take(self, rows: np.ndarray, cols=None) -> np.ndarray:
        """Gather G[rows] (float64) for any integer index array — the
        result has shape ``rows.shape + (L,)``.  With ``cols`` (distinct
        column ids) only those columns are gathered, ``rows.shape +
        (len(cols),)``, and ``parity_rows_fn(ids, cols)`` is asked for
        just them — decode minors never need whole parity rows."""
        rows = np.asarray(rows)
        flat = rows.ravel()
        sys_m = flat < self.L
        sys_i = np.nonzero(sys_m)[0]
        if cols is None:
            out = np.zeros((flat.size, self.L))
            out[sys_i, flat[sys_m]] = 1.0
        else:
            cols = np.asarray(cols, dtype=np.int64)
            out = np.zeros((flat.size, cols.size))
            pos = np.full(self.L, -1, dtype=np.int64)
            pos[cols] = np.arange(cols.size)
            p = pos[flat[sys_m]]
            out[sys_i[p >= 0], p[p >= 0]] = 1.0
        if (~sys_m).any():
            ids = flat[~sys_m] - self.L
            par = self.parity_rows_fn(ids) if cols is None \
                else self.parity_rows_fn(ids, cols)
            out[~sys_m] = np.asarray(par, dtype=np.float64)
        return out.reshape(rows.shape + (out.shape[1],))

    def __getitem__(self, rows):
        return self.take(rows)


def _identity_prefix(G) -> bool:
    """True iff the generator's (shared) top L rows are exactly I_L (a host
    array or a device tensor)."""
    L = G.shape[-1]
    if G.shape[-2] < L:
        return False
    top = G[..., :L, :]
    if isinstance(G, torch.Tensor):
        return bool((top == torch.eye(L, dtype=G.dtype,
                                      device=G.device)).all())
    return bool((top == np.eye(L, dtype=G.dtype)).all())


def _idx_t(a, device) -> torch.Tensor:
    """Host index array → int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def _gather_generator_rows(G, glist: bool, idx: np.ndarray,
                           rows: np.ndarray, device=None):
    """Stack G[rows[i]] for the selected task indices → (len(idx), R, L),
    on ``device`` when the plan is built there (G then holds float64
    tensors, except a :class:`SystematicRows`, which synthesises its rows
    on the host)."""
    if device is not None and not isinstance(G, SystematicRows):
        r = _idx_t(rows, device)
        if glist:
            return torch.stack([G[i][r[j]] for j, i in enumerate(idx)])
        if G.dim() == 2:
            return G[r]
        return G[_idx_t(idx, device)[:, None], r]
    if glist:
        out = np.stack([G[i][rows[j]] for j, i in enumerate(idx)])
    elif G.ndim == 2:
        out = G[rows]
    else:
        out = G[idx[:, None], rows]
    return out if device is None else as_f64(out, device)


def _take_cols(Gp, cols: np.ndarray):
    """Per-task column gather ``Gp[b][:, cols[b]]`` of (g, R, L) blocks."""
    if isinstance(Gp, torch.Tensor):
        return torch.take_along_dim(Gp, _idx_t(cols, Gp.device)[:, None, :],
                                    dim=2)
    return np.take_along_axis(Gp, cols[:, None, :], axis=2)


class _MixedGroup:
    """One mixed-row substitution group of a :class:`DecodePlan`: every
    task that received exactly ``s`` systematic rows (0 < s < L).

    Its generator blocks are gathered at the first solve and kept for the
    next; :meth:`release` drops them, so a one-shot decode holds one
    group's blocks at a time."""

    __slots__ = ("grp", "sys_rows", "unk", "sys_pos", "par_pos", "_gather",
                 "_lu", "_Gk")

    def __init__(self, grp, sys_rows, unk, sys_pos, par_pos, gather):
        self.grp = grp                # (g,) task indices in the batch
        self.sys_rows = sys_rows      # (g, s) pinned coordinate ids
        self.unk = unk                # (g, L-s) coordinates to solve for
        self.sys_pos = sys_pos        # (g, s) receive positions of sys rows
        self.par_pos = par_pos        # (g, L-s) receive positions of parity
        self._gather = gather         # () -> (A, Gk)
        self._lu = self._Gk = None

    def _blocks(self):
        if self._lu is None:
            A, self._Gk = self._gather()
            self._lu = StackedLU(A)   # (g, L-s, L-s) parity sub-blocks
        return self._lu, self._Gk

    @property
    def lu(self) -> "StackedLU":
        return self._blocks()[0]

    @property
    def Gk(self):
        """(g, L-s, s) known-coordinate columns."""
        return self._blocks()[1]

    @property
    def A(self) -> np.ndarray:
        return self.lu.A

    def release(self) -> None:
        self._lu = self._Gk = None


class DecodePlan:
    """The X-independent structure of one stacked exactly-L decode.

    Everything :func:`decode_batch` derives from ``(G, rows)`` alone — the
    systematic/mixed/full partition of the batch, the per-``s`` substitution
    groups, the gathered generator sub-blocks (a group's at its first
    solve) — is computed once here, so a caller that decodes many
    right-hand sides against the *same* received rows (the serving
    bridge's step barrier: one delivery prefix, one decode problem per
    coded matmul, re-applied for every token of a multi-token dispatch)
    pays the planning overhead once.  ``apply(y)`` runs the solves;
    ``decode_batch(G, rows, y)`` is literally
    ``plan_decode(G, rows).apply(y, release=True)`` on both engines, so the
    two can never drift.  A plan built with a ``device`` holds its
    generator blocks there (float64 tensors) and applies on that device
    only.
    """

    __slots__ = ("B", "L", "fast_idx", "fast_rows", "full_idx", "full_G",
                 "full_lu", "mixed_groups", "device")

    def __init__(self, B: int, L: int, fast_idx, fast_rows, full_idx,
                 full_G, mixed_groups, device=None):
        self.B = B
        self.L = L
        self.fast_idx = fast_idx          # (f,) tasks decoded by scatter
        self.fast_rows = fast_rows        # (f, L) their received row ids
        self.full_idx = full_idx          # (n,) tasks needing the full solve
        self.full_G = full_G              # (n, L, L) gathered generators
        self.full_lu = StackedLU(full_G)  # factor cached across applies
        self.mixed_groups = mixed_groups  # one _MixedGroup per distinct s
        self.device = device              # None: host arrays

    def apply(self, y: np.ndarray, *, backend: str = "numpy",
              device=None, release: bool = False) -> np.ndarray:
        """Solve the planned systems for one stacked right-hand side
        ``y`` (B, L) or (B, L, C).  ``backend="torch"`` scatters,
        substitutes and solves in float64 on the plan's device, else on
        ``device`` (default ``cuda``); the result comes back to the host
        once.  ``release`` drops each substitution group's blocks once it
        is solved (a plan applied once)."""
        check_backend(backend)
        tr = current_tracer()
        t0 = tr.now() if tr is not None else 0.0
        if backend == "torch":
            dev = self.device or resolve_device(device)

            def arr(a):
                return as_f64(a, dev)

            def idx(a):
                return _idx_t(a, dev)

            take = torch.take_along_dim
        elif self.device is not None:
            raise ValueError("a plan built on a device applies with "
                             "backend='torch'")
        else:
            dev = None

            def arr(a):
                return np.asarray(a, dtype=np.float64)

            def idx(a):
                return a

            take = np.take_along_axis
        y = arr(y)
        squeeze = y.ndim == 2
        if squeeze:
            y = y[..., None]
        shape = (self.B, self.L, y.shape[-1])
        out = np.empty(shape) if dev is None else \
            torch.empty(shape, dtype=torch.float64, device=dev)

        def solve(lu: StackedLU, b):
            # both engines factor once per frozen plan and replay the
            # triangular solves (numpy: getrf/getrs, bit-identical to gesv)
            return lu.solve(b, backend=backend, device=dev)

        if self.fast_idx.size:
            # permutation decode: out[b, rows[b, i]] = y[b, i]
            fi = idx(self.fast_idx)
            out[fi[:, None], idx(self.fast_rows)] = y[fi]
        if self.full_idx.size:
            fi = idx(self.full_idx)
            out[fi] = solve(self.full_lu, y[fi])
        for mg in self.mixed_groups:
            # receive-order partitions were frozen at plan time as position
            # index arrays; partition y the same row-major way
            gi = idx(mg.grp)
            yg = y[gi]
            sys_y = take(yg, idx(mg.sys_pos)[:, :, None], 1)
            par_y = take(yg, idx(mg.par_pos)[:, :, None], 1)
            sol = solve(mg.lu, par_y - arr(mg.Gk) @ sys_y)
            out[gi[:, None], idx(mg.sys_rows)] = sys_y        # exact pins
            out[gi[:, None], idx(mg.unk)] = sol
            if release:
                mg.release()
        if dev is not None:
            out = out.cpu().numpy()
        if tr is not None:
            tr.add_span("decode_apply", t0, tr.now(), cat="decode",
                        track="wall",
                        args={"tasks": self.B, "backend": backend,
                              "scatter": int(self.fast_idx.size),
                              "solved": int(self.full_idx.size),
                              "mixed": sum(int(mg.grp.size)
                                           for mg in self.mixed_groups)})
        return out[..., 0] if squeeze else out


def plan_decode(G, rows: np.ndarray, *, systematic: str = "auto",
                identity_prefix: Optional[bool] = None,
                device=None) -> DecodePlan:
    """Build the :class:`DecodePlan` for stacked received rows.

    ``identity_prefix`` short-circuits the O(L²) top-rows-are-identity
    check when the caller constructed G as a systematic [I; R] generator
    (``CodedLinear`` always does) — pass ``True``/``False`` to assert the
    structure, ``None`` (default) to detect it.

    ``device`` builds the plan there: G is uploaded once as float64 and
    every generator gather, minor and factor stays on the device, which
    then only takes ``apply(..., backend="torch")``.  The partition of the
    row ids is host work either way.
    """
    if systematic not in ("auto", "prefix", "never"):
        raise ValueError(f"systematic must be 'auto', 'prefix' or 'never', "
                         f"got {systematic!r}")
    tr = current_tracer()
    t0 = tr.now() if tr is not None else 0.0
    dev = None if device is None else resolve_device(device)
    rows = np.asarray(rows)
    glist = isinstance(G, (list, tuple))
    if glist:
        G = [as_f64(g, dev) for g in G] if dev is not None \
            else [np.asarray(g, dtype=np.float64) for g in G]
    elif not isinstance(G, SystematicRows):
        G = as_f64(G, dev) if dev is not None \
            else np.asarray(G, dtype=np.float64)
    B, L = rows.shape

    sys_ok = False
    if systematic != "never" and B:
        if identity_prefix is not None:
            sys_ok = bool(identity_prefix)
        elif isinstance(G, SystematicRows):
            sys_ok = True            # systematic by construction
        else:
            sys_ok = all(_identity_prefix(g) for g in (G if glist else [G]))
    sys_counts = (rows < L).sum(axis=1) if sys_ok else np.zeros(B, dtype=int)
    fast = sys_counts == L
    fast_idx = np.nonzero(fast)[0]

    if systematic == "auto" and sys_ok:
        full_idx = np.nonzero(sys_counts == 0)[0]
    else:
        full_idx = np.nonzero(~fast)[0]
    if not full_idx.size:
        full_G = np.empty((0, L, L))
    elif dev is None:
        full_G = _gather_generator_rows(G, glist, full_idx, rows[full_idx])
    else:
        # column-major minors: the first solve factors them in place, so
        # an L = 1e4 minor costs no second copy on the card
        full_G = torch.empty((full_idx.size, L, L), dtype=torch.float64,
                             device=dev).mT
        full_G.copy_(_gather_generator_rows(G, glist, full_idx,
                                            rows[full_idx], dev))

    mixed_groups = []
    if systematic == "auto" and sys_ok:
        mixed = (sys_counts > 0) & (sys_counts < L)
        for s in np.unique(sys_counts[mixed]):
            grp = np.nonzero(sys_counts == s)[0]
            g = grp.size
            m_sys = rows[grp] < L                            # (g, L)
            # boolean indexing is row-major, so per-task receive order is
            # preserved inside both partitions
            sys_pos = np.nonzero(m_sys)[1].reshape(g, s)
            par_pos = np.nonzero(~m_sys)[1].reshape(g, L - s)
            sys_rows = np.take_along_axis(rows[grp], sys_pos, axis=1)
            par_rows = np.take_along_axis(rows[grp], par_pos, axis=1)
            # unknown coordinates: per-task complement of the pinned ones
            known = np.zeros((g, L), dtype=bool)
            known[np.arange(g)[:, None], sys_rows] = True
            unk = np.nonzero(~known)[1].reshape(g, L - s)

            def gather(grp=grp, par_rows=par_rows, sys_rows=sys_rows,
                       unk=unk):
                Gp = _gather_generator_rows(G, glist, grp, par_rows, dev)
                return _take_cols(Gp, unk), _take_cols(Gp, sys_rows)
            mixed_groups.append(
                _MixedGroup(grp, sys_rows, unk, sys_pos, par_pos, gather))
    if tr is not None:
        tr.add_span("plan_decode", t0, tr.now(), cat="plan", track="wall",
                    args={"tasks": B, "L": L, "scatter": int(fast_idx.size),
                          "solved": int(full_idx.size),
                          "mixed_groups": len(mixed_groups)})
    return DecodePlan(B, L, fast_idx, rows[fast_idx], full_idx, full_G,
                      mixed_groups, dev)


def decode_batch(G: np.ndarray, rows: np.ndarray, y: np.ndarray,
                 *, backend: str = "numpy", systematic: str = "auto",
                 identity_prefix: Optional[bool] = None,
                 device=None) -> np.ndarray:
    """Recover B systems A_t x_t from exactly-L received coded results each.

    G:    (L̃, L) shared generator, (B, L̃, L) per-task generators, or a
          length-B list of (L̃_b, L) generators (avoids stacking the full
          generators when only the received rows are needed).
    rows: (B, L) int — received coded-row indices per task.
    y:    (B, L) or (B, L, C) received results.

    systematic="auto" (default) exploits an identity prefix (G's top L rows
    are exactly I_L) at every straggler pattern:

    * a task that received *only* systematic rows is a permutation decode —
      ``out[rows] = y``, a scatter, bit-identical to the general solve (LU
      of a permutation matrix is exact) at O(L) instead of O(L³);
    * a task with ``0 < s < L`` systematic rows *substitutes* the known
      coordinates (each received systematic row pins one entry of x
      exactly) and solves only the (L−s)-sized parity block for the rest —
      tasks are grouped by s so each group is one stacked solve.  The
      pinned coordinates are bit-identical to the received values; the
      parity block agrees with the full L×L solve to solver precision.

    "prefix" keeps only the pure-systematic scatter and sends every mixed
    task through the full solve (the pre-substitution behaviour; the
    benchmark baseline for the substitution speedup).  "never" forces the
    general solve for everything.

    ``identity_prefix=True`` skips the O(L²) identity-prefix scan when the
    caller built G systematically (see :func:`plan_decode`).

    Solves run as cached LAPACK getrf/getrs on the numpy backend and
    float64 ``torch.linalg`` LU on the torch backend, whose plan gathers
    its generator blocks on ``device`` (default ``cuda``).  This function
    is the composition ``plan_decode(G, rows).apply(y, release=True)``
    (one substitution group's blocks on hand at a time); callers
    re-decoding against fixed received rows should hold the plan and call
    ``apply``.
    """
    check_backend(backend)
    dev = resolve_device(device) if backend == "torch" else None
    return plan_decode(G, rows, systematic=systematic,
                       identity_prefix=identity_prefix, device=dev).apply(
                           y, backend=backend, device=dev, release=True)


# ---------------------------------------------------------------------------
# Batched least-squares decode (> L received rows)
# ---------------------------------------------------------------------------

class LSDecodePlan:
    """X-independent structure of a stacked *least-squares* decode.

    The exact :class:`DecodePlan` consumes exactly L rows per task; when a
    prefix delivered R > L rows (extra parity arrived before the cut), the
    overdetermined solve averages out the float32 encode noise of the
    jax/pallas product path instead of discarding the surplus — the
    streaming analogue of :func:`repro_torch.core.mds.decode_ls`.  Gathered
    generator blocks are frozen at plan time; ``apply`` re-solves per
    right-hand side.  The numpy engine is *literally* a per-task
    ``np.linalg.lstsq`` sweep, so it is bit-identical to the reference by
    construction; torch runs a batched float64 ``torch.linalg.lstsq`` (the
    minimum-norm ``pinv`` solve for the under-determined degraded case,
    which the CUDA ``gels`` driver does not take).
    """

    __slots__ = ("B", "L", "Gs", "_lu")

    def __init__(self, B: int, L: int, Gs: np.ndarray):
        self.B = B
        self.L = L
        self.Gs = Gs                     # (B, R, L) gathered generator rows
        # R == L is a square system: route it through the same cached-LU
        # solve the exact decode uses, so "least squares with no surplus"
        # is bit-identical to the square decode (tested) instead of
        # merely close via the QR in lstsq
        self._lu = StackedLU(Gs) if Gs.shape[1] == L else None

    def apply(self, y: np.ndarray, *, backend: str = "numpy",
              device=None) -> np.ndarray:
        """Least-squares solve for stacked received results ``y`` of shape
        (B, R) or (B, R, C) → (B, L[, C])."""
        check_backend(backend)
        tr = current_tracer()
        t0 = tr.now() if tr is not None else 0.0
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 2
        if squeeze:
            y = y[..., None]
        if self._lu is not None:
            out = self._lu.solve(y, backend=backend, device=device)
        elif backend == "torch":
            dev = resolve_device(device)
            Gs, yt = as_f64(self.Gs, dev), as_f64(y, dev)
            if self.Gs.shape[1] >= self.L:
                sol = torch.linalg.lstsq(Gs, yt).solution
            else:
                sol = torch.linalg.pinv(Gs) @ yt
            out = sol.cpu().numpy()
        else:
            out = self._apply_np(y)
        if tr is not None:
            tr.add_span("decode_ls_apply", t0, tr.now(), cat="decode",
                        track="wall",
                        args={"tasks": self.B, "L": self.L,
                              "rows": int(self.Gs.shape[1]),
                              "backend": backend})
        return out[..., 0] if squeeze else out

    def _apply_np(self, y: np.ndarray) -> np.ndarray:
        out = np.empty((self.B, self.L, y.shape[-1]))
        for b in range(self.B):
            out[b], *_ = np.linalg.lstsq(self.Gs[b], y[b], rcond=None)
        return out


def plan_decode_ls(G, rows: np.ndarray, *,
                   allow_underdetermined: bool = False) -> LSDecodePlan:
    """Build the :class:`LSDecodePlan` for stacked received rows (B, R),
    R ≥ L.  ``G`` accepts the same forms as :func:`plan_decode` —
    including :class:`SystematicRows` for virtual parity.

    ``allow_underdetermined`` admits R < L for the *degraded* recovery
    path (fault verification rejected rows below coverage): ``lstsq``
    then returns the minimum-norm solution — explicitly reported as
    degraded by the caller, never silently exact."""
    rows = np.asarray(rows)
    glist = isinstance(G, (list, tuple))
    B, R = rows.shape
    if glist:
        L = np.asarray(G[0]).shape[-1]
    else:
        L = G.shape[-1]
    if R < L and not allow_underdetermined:
        raise ValueError(f"least-squares decode needs >= L={L} rows per "
                         f"task, got {R}")
    if not glist and not isinstance(G, SystematicRows):
        G = np.asarray(G, dtype=np.float64)
    Gs = _gather_generator_rows(G, glist, np.arange(B), rows)
    return LSDecodePlan(B, int(L), np.asarray(Gs, dtype=np.float64))


def decode_ls_batch(G, rows: np.ndarray, y: np.ndarray,
                    *, backend: str = "numpy",
                    device=None) -> np.ndarray:
    """Least-squares decode of B tasks from ≥ L received rows each —
    the composition ``plan_decode_ls(G, rows).apply(y)``."""
    return plan_decode_ls(G, rows).apply(y, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Parity-residual verification (fault detection over surplus rows)
# ---------------------------------------------------------------------------

class VerifyPlan:
    """X-independent structure of a batched parity-residual check.

    A decode consumes exactly L delivered rows; every row delivered
    *beyond* the covering prefix is a free integrity check on the result:
    for surplus row r with generator row G[r],

        resid_r = | y_r − G[r] · x̂ | / (1 + |y_r|)

    is ≈ 0 (float noise) when worker deliveries are honest and O(1) when
    any consumed or surplus row was corrupted.  The gathered surplus
    generator block is frozen at plan time (cached alongside the decode's
    :class:`StackedLU` in the serving step-plan cache); ``residuals``
    re-checks per right-hand side.
    """

    __slots__ = ("B", "L", "Gs")

    def __init__(self, B: int, L: int, Gs: np.ndarray):
        self.B = B
        self.L = L
        self.Gs = Gs                     # (B, S, L) surplus generator rows

    def residuals(self, x_hat: np.ndarray,
                  y_surplus: np.ndarray) -> np.ndarray:
        """Relative parity residual per surplus row.

        ``x_hat`` (B, L) or (B, L, C); ``y_surplus`` (B, S) or (B, S, C)
        → (B, S), the max over C of the relative residuals."""
        x_hat = np.asarray(x_hat, dtype=np.float64)
        y_surplus = np.asarray(y_surplus, dtype=np.float64)
        pred = np.einsum("bsl,bl...->bs...", self.Gs, x_hat)
        r = np.abs(y_surplus - pred) / (1.0 + np.abs(y_surplus))
        if r.ndim == 3:
            r = r.max(axis=-1)
        return r


def plan_verify(G, surplus_rows: np.ndarray) -> VerifyPlan:
    """Build the :class:`VerifyPlan` for stacked surplus rows (B, S).
    ``G`` accepts the same forms as :func:`plan_decode`."""
    surplus_rows = np.asarray(surplus_rows)
    glist = isinstance(G, (list, tuple))
    B = surplus_rows.shape[0]
    if glist:
        L = np.asarray(G[0]).shape[-1]
    else:
        L = G.shape[-1]
    if not glist and not isinstance(G, SystematicRows):
        G = np.asarray(G, dtype=np.float64)
    Gs = _gather_generator_rows(G, glist, np.arange(B), surplus_rows)
    return VerifyPlan(B, int(L), np.asarray(Gs, dtype=np.float64))


def verify_decode(G, rows: np.ndarray, y: np.ndarray,
                  surplus_rows: np.ndarray, y_surplus: np.ndarray, *,
                  tol: float = 1e-6, backend: str = "numpy",
                  device=None):
    """Decode from the earliest covering prefix and parity-check every
    surplus delivered row.

    ``rows`` (B, L) and ``y`` (B, L[, C]) feed the exact decode;
    ``surplus_rows`` (B, S) and ``y_surplus`` (B, S[, C]) are the extra
    deliveries to check.  Returns ``(x_hat, resid, bad)``: the decoded
    (B, L[, C]) result, the (B, S) relative residuals, and the boolean
    flag mask ``resid > tol``.  A flagged row means the system is
    inconsistent — either that surplus row or a row *inside* the decoded
    prefix is corrupt; :func:`localize_faulty_worker` disambiguates.
    """
    x_hat = plan_decode(G, np.asarray(rows)).apply(y, backend=backend,
                                                   device=device)
    resid = plan_verify(G, surplus_rows).residuals(x_hat, y_surplus)
    return x_hat, resid, resid > tol


def localize_faulty_worker(G, rows: np.ndarray, y: np.ndarray,
                           row_workers: np.ndarray, *, tol: float = 1e-6,
                           candidates=None, backend: str = "numpy",
                           device=None):
    """Leave-one-worker-out sweep over ONE task's delivered rows.

    ``rows`` (R,) delivered coded-row ids (prefix + surplus, R > L),
    ``y`` (R,) or (R, C) their products, ``row_workers`` (R,) the worker
    that delivered each row.  For each candidate worker w (most-suspect
    first when ``candidates`` orders them): exclude w's rows; if ≥ L
    remain, decode from the earliest L and residual-check the rest — the
    first exclusion that restores consistency names the culprit.

    Returns ``(worker, x_hat, keep)``: the localised worker (or None
    when no exclusion is consistent), the clean decode over the kept
    rows, and the boolean keep-mask.  Guaranteed to localise when the
    corrupt worker's rows number ≤ R − L − 1 (enough surplus remains to
    re-check after exclusion); with exactly R − L the sweep still
    localises unless the corruption hides in an uncheckable exact-L
    remainder, which candidate ordering makes vanishingly rare.
    """
    rows = np.asarray(rows)
    y = np.asarray(y, dtype=np.float64)
    row_workers = np.asarray(row_workers)
    L = G.shape[-1] if not isinstance(G, (list, tuple)) \
        else np.asarray(G[0]).shape[-1]
    if candidates is None:
        candidates = sorted(set(int(w) for w in row_workers))
    for w in candidates:
        keep = row_workers != w
        if not (~keep).any() or int(keep.sum()) < L:
            continue
        kept_rows = rows[keep]
        kept_y = y[keep]
        x_hat = plan_decode(G, kept_rows[:L][None]).apply(
            kept_y[:L][None], backend=backend, device=device)[0]
        if kept_rows.size > L:
            resid = plan_verify(G, kept_rows[L:][None]).residuals(
                x_hat[None], kept_y[L:][None])[0]
            if (resid > tol).any():
                continue
        return int(w), x_hat, keep
    return None, None, None
