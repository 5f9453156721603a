"""MDS-coded execution of an arbitrary row-sharded linear layer.

The serving bridge treats every large matmul ``out = X @ W.T`` — the output
head, the attention q/k/v/o projections, the FFN up/down projections — as
one of the paper's coded tasks: the rows of W (L of them — padded_vocab for
the head, d_ff for the FFN up projection, d_model for the down projection,
…) are encoded with a systematic MDS generator ``G = [I; R]``, split into
per-node contiguous shards sized by the Theorem-1/3 load row (integerised
by :func:`repro_torch.parallel.hetero.coded_row_shards` /
``rescaled_row_shards``), and each *arrived* shard's product is physically
computed as its own matmul — exactly what that worker would return.  The
earliest prefix of shard deliveries covering L rows decodes the exact
output through :func:`repro_torch.stream.backend.decode_batch` (permutation
scatter when only systematic rows arrived, mixed-row substitution
otherwise); *within* that prefix the decoder prefers the received
systematic rows — any L delivered coded rows recover the product, so
picking identity rows first shrinks the parity solve to the coverage
shortfall (see :meth:`CodedLinear.prefix_plan`).

**Counter-derived parity.**  Every parity generator row is a pure
function of ``(seed, name, row index)`` through the threefry counter
derivation in :func:`repro_torch.core.mds.counter_parity_rows`: rows are
derived in fixed ``parity_chunk``-aligned blocks, each block's
conditioning-guard redraw index is itself deterministic, and therefore
row r carries identical bits no matter in what order or granularity the
cache grew — across replans, serves, and processes.  (The historical
implementation drew parity from one *sequential* ``default_rng`` stream,
so a row's values depended on the growth history — a replay bug this
module fixed when virtual storage made the contract load-bearing.)

**Two parity storage modes.**

``parity_storage="materialized"`` (default): the encoded matrix
``[W; WR]`` lives in one packed row-major buffer per layer, grown
*incrementally*: the systematic prefix is W itself (the
identity-skipping trick of the reference's ``mds_encode``), and each
lazily-derived parity block appends ``R_block @ W`` without re-encoding
anything already cached.  Shard execution in both the serial and the
batched engine is a gather from this cache — ``device_rows`` maintains
the float32 device-resident mirror the same incremental way for the
torch batched kernel path.

``parity_storage="virtual"``: nothing is materialised beyond W itself
plus the per-row seed schedule (packed threefry counters).  Host-side
shard execution derives the few parity rows a covering prefix actually
uses block-by-block on demand (a tiny LRU memo keeps the hot blocks of
a frozen plan resident — bit-identical to the materialised encode, the
same ``R_block @ W`` call on the same block); the device path hands the
packed counters to the generated-parity kernel
(:func:`repro_torch.kernels.ops.gen_parity_products`), which re-derives
each parity entry in registers and contracts it against the resident W —
no ``[W; WR]`` mirror in HBM.  At redundancy 2 this halves
encoded-weight memory (see :meth:`CodedLinear.encoded_cache_bytes`).

**Prefix planning vs execution.**  :meth:`prefix_plan` derives the
earliest covering prefix (which coded rows, from which workers, in
delivery order) from the dispatch timing alone — no activations needed —
so the batched engine plans every matmul of a step barrier up front and
executes the packed products in one pass.  :meth:`step` is the serial
reference: the same plan, executed shard-by-shard.

Numerics: decode-feeding shard products run through
:func:`shard_products` — a float64 ``np.einsum`` contraction whose
per-row bits are independent of how the rows are batched (unlike BLAS
GEMM, whose edge-panel handling changes with the row count), so the
batched engine is bit-identical to the serial loop by construction.
``backend="torch"`` routes the parity encode through the port's matmul
kernel, derives parity blocks on the card with the counter-rows kernel
(conditioning guard in float64 there too), and solves the decode in
float64 with ``torch.linalg`` on ``device`` (float32 encode — verify with
the looser tolerance, as in the streaming engine).

This is the port of ``repro.serve_coded.coded_linear``: the planning and
the numpy engine are unchanged; the device half speaks torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import List, Optional

import numpy as np
import torch

from ..core import mds
from ..device import resolve_device
from ..obs import current_tracer
from ..stream import backend as bk

__all__ = ["CodedLinear", "CodedLMHead", "LinearStep", "HeadStep",
           "PrefixPlan", "shard_products", "prefix_plan_batch",
           "surplus_plan"]

#: the decode solve engine each backend runs (torch: float64
#: ``torch.linalg`` on the layer's device)
DECODE_ENGINE = {"numpy": "numpy", "torch": "torch"}

#: smallest mixed-row parity solve block (see ``prefix_plan``): blocks
#: below this swap in extra delivered parity rows for the last systematic
#: pins, bounding the inverse-norm tail of tiny Gaussian sub-blocks
MIN_PARITY_BLOCK = 8


def _assemble_prefix(L: int, workers: np.ndarray, starts: np.ndarray,
                     stops_: np.ndarray):
    """Systematic-first row selection within a fixed covering prefix.

    ``workers``/``starts``/``stops_`` describe the delivered shards in
    delivery order (node column, row-range start, row-range stop).  Pick
    the received systematic rows (< L) first and fill the remainder with
    the earliest-delivered parity rows, honouring the MIN_PARITY_BLOCK
    conditioning floor.  The quota arithmetic is vectorised — the old
    sequential per-worker cut/take loop is exactly
    ``clip(quota − cumsum_excl(avail), 0, avail)`` — and only the final
    ``np.arange`` row materialisation loops (short: one pass over the
    prefix's workers).

    Returns ``(rows, slices, used)`` as in :class:`PrefixPlan`.
    """
    sizes = stops_ - starts
    c = np.clip(L - starts, 0, sizes)            # systematic part per shard
    n_sys = int(c.sum())
    par = sizes - c                              # parity rows available
    # parity-fill budget: at least the shortfall; when a solve is needed
    # at all, at least MIN_PARITY_BLOCK rows (a tiny Gaussian block has a
    # fat inverse-norm tail that amplifies the float32 parity-encode error
    # on the torch backend); never more than L rows total
    budget = L - n_sys
    if budget > 0:
        budget = min(max(budget, MIN_PARITY_BLOCK), int(par.sum()), L)
    sys_quota = L - budget
    cuts = np.clip(sys_quota - (np.cumsum(c) - c), 0, c)
    takes = np.clip(budget - (np.cumsum(par) - par), 0, par)
    slices: List[np.ndarray] = []
    used: List[int] = []
    for w, a, ci, cut, take in zip(workers, starts, c, cuts, takes):
        if cut + take == 0:
            continue
        part = np.arange(a, a + cut) if take == 0 else (
            np.arange(a + ci, a + ci + take) if cut == 0 else
            np.concatenate([np.arange(a, a + cut),
                            np.arange(a + ci, a + ci + take)]))
        slices.append(part)
        used.append(int(w))
    rows = np.concatenate(slices) if len(slices) > 1 else slices[0]
    return rows, slices, np.asarray(used)


def prefix_plan_batch(linears, barrier) -> dict:
    """Covering prefixes for a whole step barrier in one stacked pass.

    Replaces the per-matmul Python planning (~15 ``prefix_plan`` calls
    per trunk step) with one batched selection:
    :meth:`repro_torch.stream.barrier.StepBarrier.covering_selections` computes
    every task's delivered-shard prefix (orders, coverage, row-range
    edges) as stacked array ops, and the per-task remainder is just the
    vectorised quota assembly above.  Bit-identical to calling
    ``prefix_plan`` per task — both run the same selection math and the
    same :func:`_assemble_prefix`.

    ``linears`` maps task name → :class:`CodedLinear`.  Returns
    ``{task.name: PrefixPlan}``.
    """
    plans = {}
    for task, (workers, starts, stops_) in zip(
            barrier.tasks, barrier.covering_selections()):
        lin = linears[task.name]
        total = int(task.l_int.sum())
        if total < lin.L:
            raise ValueError(f"shards cover {total} < L={lin.L} rows")
        lin.ensure_parity(total - lin.L)
        rows, slices, used = _assemble_prefix(lin.L, workers, starts, stops_)
        par = rows[rows >= lin.L] - lin.L
        plans[task.name] = PrefixPlan(
            rows=rows, slices=slices, used=used, total=total,
            used_solve=bool(par.size),
            parity_ctrs=lin.parity_ctrs(par) if par.size else None)
    return plans


def surplus_plan(l_int: np.ndarray, finish: np.ndarray, t_complete: float,
                 plan: PrefixPlan, *, cap: int = 8,
                 assign: Optional[np.ndarray] = None):
    """Delivered coded rows *beyond* a covering prefix — verification fuel.

    MDS redundancy means a dispatch usually delivers more than L rows by
    the barrier completion; the decode uses exactly L of them
    (``plan.rows``) and historically discarded the rest.  The fault
    detector instead spends up to ``cap`` of those surplus rows as parity
    residual checks (each surplus row's product must agree with the
    decoded estimate — see :func:`repro_torch.stream.backend.verify_decode`),
    and the LS tail consumes them for an over-determined solve.

    Same selection math as :meth:`CodedLinear.prefix_plan` (row-range
    layout under ``assign``, delivery cutoff ``t_complete``), earliest
    deliveries first.  Returns ``(rows, row_workers)`` — absolute coded
    row ids and the worker column each came from, aligned.
    """
    l_int = np.asarray(l_int, dtype=np.int64)
    total = int(l_int.sum())
    active = np.nonzero(l_int > 0)[0]
    l_act = l_int[active]
    if assign is None:
        starts_act = np.concatenate([[0], np.cumsum(l_act)[:-1]]).astype(
            np.int64)
    else:
        aorder = np.argsort(np.asarray(assign)[active], kind="stable")
        starts_act = np.empty(active.size, dtype=np.int64)
        starts_act[aorder] = np.concatenate(
            [[0], np.cumsum(l_act[aorder])[:-1]])
    f_act = np.asarray(finish, dtype=np.float64)[active]
    ok = np.isfinite(f_act) & (f_act <= t_complete + 1e-9)
    order = np.argsort(np.where(ok, f_act, np.inf), kind="stable")
    in_prefix = np.zeros(total, dtype=bool)
    in_prefix[plan.rows] = True
    rows_out: List[np.ndarray] = []
    wk_out: List[np.ndarray] = []
    n = 0
    for i in order:
        if not ok[i] or n >= cap:
            break
        r = np.arange(starts_act[i], starts_act[i] + l_act[i])
        keep = r[~in_prefix[r]][:cap - n]
        if keep.size:
            rows_out.append(keep)
            wk_out.append(np.full(keep.size, active[i], dtype=np.int64))
            n += keep.size
    if not rows_out:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    return np.concatenate(rows_out), np.concatenate(wk_out)


def shard_products(W_rows: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Per-shard products ``W_rows @ X.T`` (rows, B) in float64.

    This is the one product primitive both execution engines share.  It is
    deliberately an ``np.einsum`` contraction, not BLAS ``@``: einsum's
    per-row reduction order depends only on the contraction length D, so
    computing a shard's rows alone, per worker, or packed into a step-wide
    buffer gives bit-identical rows — the property the batched engine's
    exactness tests rely on (BLAS GEMM edge panels break it).
    """
    return np.einsum("ld,bd->lb", W_rows, X)


@dataclasses.dataclass
class PrefixPlan:
    """The earliest covering prefix of one dispatched coded matmul.

    Pure timing — derived from shard sizes and delivery times before any
    activation exists, which is what lets the batched engine pack a whole
    step barrier's gathers and decode structure at dispatch time.
    """
    rows: np.ndarray            # (L,) coded-row ids feeding the decode
    slices: List[np.ndarray]    # per-used-worker row ids, delivery order
    used: np.ndarray            # worker columns, delivery order
    total: int                  # Σ integer shard sizes dispatched
    used_solve: bool            # parity rows in the prefix → general solve
    #: packed threefry counters of the prefix's parity rows (rows ≥ L, in
    #: row order) — the seed/row-block metadata frozen plans carry so
    #: virtual-parity execution needs no encoded-row cache to replay
    parity_ctrs: Optional[np.ndarray] = None

    def row_workers(self) -> np.ndarray:
        """Worker column of every row in ``rows``, aligned — the
        attribution the fault detector localises residual flags with."""
        return np.repeat(self.used,
                         [len(sl) for sl in self.slices]).astype(np.int64)


@dataclasses.dataclass
class LinearStep:
    """Result of one coded linear execution."""
    out: np.ndarray             # (B, L) decoded — exact X @ W.T per row of X
    rows: np.ndarray            # (L,) coded-row ids used by the decode
    workers_used: np.ndarray    # node columns whose shards fed the decode
    rows_dispatched: int        # Σ integer shard sizes
    used_solve: bool            # parity rows in the prefix → general solve
    decode_backend: str = "numpy"   # effective decode-solve engine

    @property
    def logits(self) -> np.ndarray:
        """Head-layer alias: the decoded product *is* the logits batch."""
        return self.out


#: how many derived / encoded parity blocks the virtual mode keeps warm —
#: a frozen steady-state plan touches a handful of parity blocks per step,
#: so a small LRU makes virtual serving gather-speed without growing the
#: footprint toward the materialised cache it exists to avoid
PARITY_BLOCK_MEMO = 4


def host64(x) -> np.ndarray:
    """Host float64 copy of a numpy array or a tensor (any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def parity_cond_torch(R: torch.Tensor) -> float:
    """:func:`repro_torch.core.mds.parity_cond` on the tensor's device, in
    float64: σ_max/σ_min from the eigenvalues of the smaller Gram matrix
    (R Rᵀ for a wide block).  The block is r × L with r ≪ L on the serving
    path, so this is one r×L·L×r product and an r×r eigensolve instead of
    an SVD of the block.  +inf for a rank-deficient block."""
    if R.numel() == 0:
        return 1.0
    R64 = R.to(torch.float64)
    gram = R64 @ R64.T if R64.shape[0] <= R64.shape[1] else R64.T @ R64
    ev = torch.linalg.eigvalsh(gram)
    lo, hi = float(ev[0]), float(ev[-1])
    return float("inf") if lo <= 0.0 else math.sqrt(hi / lo)


class CodedLinear:
    """Systematic-MDS-encoded linear layer with a persistent encoded cache.

    W: (L, D) float weight matrix, row-sharded across workers.
    name: label used by the bridge's step log ("head", "blk0.wq", ...).
    seed: parity-generator seed (one layer = one generator stream).
    backend: "numpy" | "torch" for the parity derivation, encode and
    decode solve.
    parity_storage: "materialized" caches ``[W; WR]`` rows; "virtual"
    derives parity from packed threefry counters on demand (module
    docstring).
    device: the torch backend's device (default ``cuda``); unused on numpy.
    """

    def __init__(self, W: np.ndarray, *, name: str = "linear",
                 seed: int = 0, backend: str = "numpy",
                 parity_chunk: int = 256,
                 parity_storage: str = "materialized", device=None):
        bk.check_backend(backend)
        self.requested_backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        if parity_storage not in ("materialized", "virtual"):
            raise ValueError(
                f"parity_storage must be 'materialized' or 'virtual', "
                f"got {parity_storage!r}")
        self.W = np.asarray(W, dtype=np.float64)
        self.L, self.D = self.W.shape
        self.name = name
        self.backend = backend
        self.decode_backend = DECODE_ENGINE[backend]
        self.parity_chunk = int(parity_chunk)
        self.parity_storage = parity_storage
        # crc32, not hash(): parity must replay across processes.  The
        # threefry key is the only per-layer generator state — every
        # parity row is a pure function of (key, packed row counter).
        self.pkey = (zlib.crc32(name.encode()) & 0xFFFFFFFF,
                     (int(seed) ^ 0x9E3779B9) & 0xFFFFFFFF)
        self._block_draws = {}    # block id -> conditioning-guard redraw
        self._block_memo = {}     # block id -> derived R block (LRU)
        self._encb_memo = {}      # block id -> encoded R_b @ W block (LRU)
        self._n_avail = 0         # virtual mode: logical parity rows grown
        if parity_storage == "materialized":
            self._R = np.zeros((0, self.L))       # parity generator rows
            # packed encoded cache [W; WR]: rows [0, L) are W itself (the
            # systematic prefix needs no encode), parity rows append below
            self._enc = np.empty((self.L, self.D))
            self._enc[:] = self.W
            self._n_enc = self.L
        else:
            self._R = None
            self._enc = self.W   # systematic prefix only — a *view*, no copy
            self._n_enc = self.L
        self.parity_redraws = 0                   # conditioning-guard hits
        self._G_cache: Optional[np.ndarray] = None
        self._dplan_memo = None                   # (rows bytes, DecodePlan)
        self._W_dev = None                        # f32 device copy of W
        self._enc_dev = None                      # f32 device [W; WR] mirror
        self._n_dev = 0
        self._scale = np.float32(np.sqrt(3.0 / self.L))

    @property
    def R(self) -> np.ndarray:
        """Materialised parity generator rows (use :meth:`parity_rows` for
        storage-agnostic access)."""
        if self._R is None:
            raise RuntimeError(
                f"CodedLinear({self.name!r}): parity_storage='virtual' keeps "
                "no dense R — gather rows via parity_rows(ids)")
        return self._R

    @property
    def WR(self) -> np.ndarray:
        """Encoded parity rows — a view into the packed cache."""
        if self.parity_storage != "materialized":
            raise RuntimeError(
                f"CodedLinear({self.name!r}): parity_storage='virtual' keeps "
                "no [W; WR] cache — gather via gather_encoded(rows)")
        return self._enc[self.L:self._n_enc]

    @property
    def n_parity(self) -> int:
        if self.parity_storage == "virtual":
            return self._n_avail
        return self._n_enc - self.L

    # -- encoding ------------------------------------------------------------

    def _encode_parity(self, R_new) -> np.ndarray:
        if self.backend == "numpy":
            return R_new @ self.W
        from ..kernels import ops
        # W is uploaded once per matrix (device_W); parity chunks reuse it
        R_dev = torch.as_tensor(R_new, dtype=torch.float32,
                                device=self.device)
        return host64(ops.matmul(R_dev, self.device_W()))

    def _grow_enc(self, n_new: int) -> None:
        need = self._n_enc + n_new
        if need > self._enc.shape[0]:
            cap = max(need, 2 * self._enc.shape[0])
            grown = np.empty((cap, self.D))
            grown[:self._n_enc] = self._enc[:self._n_enc]
            self._enc = grown

    @staticmethod
    def _memo_put(memo: dict, key: int, val: np.ndarray) -> None:
        """Tiny insertion-order LRU (dicts iterate oldest-first)."""
        memo.pop(key, None)
        memo[key] = val
        while len(memo) > PARITY_BLOCK_MEMO:
            memo.pop(next(iter(memo)))

    def _derive_rows(self, ctrs: np.ndarray, cols=None):
        """Parity entries ``R[ctrs][:, cols]`` (every column by default)
        straight from the counters: host float64 on numpy, a float32 tensor
        on the layer's device on torch (the counter-rows kernel).  The
        values are float32-exact and identical on both."""
        if self.backend == "torch":
            from ..kernels import ops
            return ops.counter_parity_rows(self.pkey, self.L, ctrs,
                                           cols=cols, device=self.device)
        if cols is None:
            return mds.counter_parity_rows(self.pkey, ctrs, self.L)
        return mds.counter_gaussian_tile(
            np.uint32(self.pkey[0]), np.uint32(self.pkey[1]),
            np.asarray(ctrs, dtype=np.uint32)[:, None],
            np.asarray(cols, dtype=np.uint32)[None, :],
            self._scale).astype(np.float64)

    def _cond(self, blk) -> float:
        if isinstance(blk, torch.Tensor):
            return parity_cond_torch(blk)
        return mds.parity_cond(blk)

    def _derive_block(self, b: int):
        """Derive parity block ``b`` (``parity_chunk`` rows) from counters
        (host float64 on numpy; a float32 device tensor on torch).

        Pure function of ``(pkey, b)``: the conditioning-guard redraw index
        is found by bumping the counter's draw byte until the block passes
        :func:`repro_torch.core.mds.parity_cond` — the *same* deterministic walk
        regardless of when, or in what growth order, the block is first
        needed.  That growth-history independence is the replay bug fix:
        the old sequential ``default_rng`` stream gave row r different
        values depending on how the cache had grown before it."""
        blk = self._block_memo.get(b)
        if blk is not None:
            self._memo_put(self._block_memo, b, blk)   # refresh LRU slot
            return blk
        ids = np.arange(b * self.parity_chunk, (b + 1) * self.parity_chunk)
        draw = self._block_draws.get(b)
        if draw is None:
            draw = 0
            blk = self._derive_rows(mds.parity_counters(ids, draw))
            while self._cond(blk) > mds.PARITY_COND_LIMIT:
                draw += 1
                self.parity_redraws += 1
                blk = self._derive_rows(mds.parity_counters(ids, draw))
            self._block_draws[b] = draw
        else:
            blk = self._derive_rows(mds.parity_counters(ids, draw))
        self._memo_put(self._block_memo, b, blk)
        return blk

    def _encoded_block(self, b: int) -> np.ndarray:
        """Encoded parity block ``R_b @ W`` (virtual mode, memoised).

        Always encodes the *full* aligned block in one ``_encode_parity``
        call — the identical dgemm the materialised growth path issues for
        the same block, so gathered rows are bit-equal across modes."""
        enc = self._encb_memo.get(b)
        if enc is None:
            enc = self._encode_parity(self._derive_block(b))
        self._memo_put(self._encb_memo, b, enc)
        return enc

    def ensure_parity(self, n_parity: int) -> None:
        """Grow the available parity region to ≥ ``n_parity`` rows.

        Materialised: derive + encode whole ``parity_chunk`` blocks and
        append them to the packed ``[W; WR]`` cache.  Virtual: only the
        logical row count grows — derivation happens lazily per gathered
        block.  Either way each block passes the
        :func:`repro_torch.core.mds.parity_cond` conditioning guard (a collapsed
        singular spectrum is the symptom of every degenerate decode minor)
        via a deterministic redraw-index walk."""
        tr = current_tracer()
        if tr is not None:
            # hit/miss of the persistent encoded cache: a miss pays a
            # parity derivation (+ encode when materialised), a hit is a
            # pure row gather
            tr.count("encode_cache_hits" if self.n_parity >= n_parity
                     else "encode_cache_misses")
        if self.parity_storage == "virtual":
            if n_parity > self._n_avail:
                if tr is not None:
                    tr.count("encode_cache_miss_rows",
                             n_parity - self._n_avail)
                self._n_avail = n_parity
                self._G_cache = None
            return
        while self.n_parity < n_parity:
            R_new = self._derive_block(self.n_parity // self.parity_chunk)
            self._R = np.concatenate([self._R, host64(R_new)])
            enc = self._encode_parity(R_new)
            self._grow_enc(enc.shape[0])
            self._enc[self._n_enc:self._n_enc + enc.shape[0]] = enc
            self._n_enc += enc.shape[0]
            self._G_cache = None
            if tr is not None:
                tr.count("encode_cache_miss_rows", enc.shape[0])

    # -- storage-agnostic parity access --------------------------------------

    def parity_rows(self, ids: np.ndarray, cols=None) -> np.ndarray:
        """Generator parity rows R[ids] (float64), either storage mode.

        ``ids`` are 0-based indices into the parity region (absolute coded
        row minus L).  Materialised mode slices the dense R; virtual mode
        derives the covering blocks (memoised).  Bit-identical between the
        modes — both ultimately come from the same counter derivation.
        ``cols`` restricts the result to those columns (C-ordered): the
        entries are derived straight from the rows' counters, so a decode
        minor never forms the full (len(ids), L) rows."""
        ids = np.asarray(ids, dtype=np.int64)
        if cols is not None:
            return np.ascontiguousarray(host64(
                self._derive_rows(self.parity_ctrs(ids), cols)))
        if self.parity_storage == "materialized":
            self.ensure_parity(int(ids.max()) + 1 if ids.size else 0)
            return self._R[ids]
        out = np.empty((ids.size, self.L))
        for b in np.unique(ids // self.parity_chunk):
            m = (ids // self.parity_chunk) == b
            blk = self._derive_block(int(b))
            out[m] = host64(blk[ids[m] % self.parity_chunk])
        return out

    def parity_ctrs(self, ids: np.ndarray) -> np.ndarray:
        """Packed threefry counters for parity rows ``ids`` — the only
        per-row metadata a frozen plan (or the generated-parity kernel)
        needs.  Deriving them walks the covering blocks' conditioning
        guards, so the redraw byte is already folded in."""
        ids = np.asarray(ids, dtype=np.int64)
        blocks = ids // self.parity_chunk
        for b in np.unique(blocks):
            if int(b) not in self._block_draws:
                self._derive_block(int(b))
        draws = np.asarray([self._block_draws[int(b)] for b in blocks],
                           dtype=np.int64)
        return mds.parity_counters(ids, draws)

    def gather_encoded(self, rows: np.ndarray,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
        """Encoded weight rows ``[W; WR][rows]`` (float64), either mode.

        The one gather primitive both execution engines use.  Materialised:
        a fancy-index into the packed cache.  Virtual: systematic rows come
        straight from W and parity rows from memoised per-block encodes —
        the same full-block dgemm the materialised path ran, so the bits
        match across modes."""
        rows = np.asarray(rows)
        if self.parity_storage == "materialized":
            if out is None:
                return self._enc[:self._n_enc][rows]
            np.take(self._enc[:self._n_enc], rows, axis=0, out=out)
            return out
        if out is None:
            out = np.empty((rows.size, self.D))
        sys_m = rows < self.L
        if sys_m.any():
            out[sys_m] = self.W[rows[sys_m]]
        pids = rows[~sys_m] - self.L
        if pids.size:
            pout = np.empty((pids.size, self.D))
            for b in np.unique(pids // self.parity_chunk):
                m = (pids // self.parity_chunk) == b
                pout[m] = self._encoded_block(int(b))[
                    pids[m] % self.parity_chunk]
            out[~sys_m] = pout
        return out

    def encoded_cache_bytes(self) -> int:
        """Resident encoded-weight bytes (host + device) beyond the model.

        Materialised counts the packed ``[W; WR]`` buffer (full capacity),
        the dense R, and the float32 device mirrors; virtual counts only
        the LRU block memos and the float32 device W — its host systematic
        prefix is a *view* of W, not a copy.  The benchmark gate holds the
        virtual/materialised ratio ≤ 0.55 at redundancy 2."""
        n = 0
        if self.parity_storage == "materialized":
            n += self._enc.nbytes + self._R.nbytes
            if self._enc_dev is not None:
                n += self._n_dev * self.D * 4
        else:
            n += sum(b.nbytes for b in self._block_memo.values())
            n += sum(b.nbytes for b in self._encb_memo.values())
        if self._W_dev is not None:
            n += self.L * self.D * 4
        return n

    def device_W(self) -> torch.Tensor:
        """Float32 device-resident W — the operand the generated-parity
        kernel contracts counter-derived tiles against (uploaded once).
        Row-major whatever the host array's order: an untied head's W is
        the transpose of the model's output matrix."""
        if self._W_dev is None:
            self._W_dev = torch.from_numpy(self.W).to(
                device=self.device, dtype=torch.float32,
                memory_format=torch.contiguous_format)
        return self._W_dev

    def generator(self, L_tilde: int) -> np.ndarray:
        """The systematic generator [I; R] truncated to ``L_tilde`` rows.

        Materialises the dense generator — virtual-mode decode planning
        avoids this via :class:`repro_torch.stream.backend.SystematicRows`, but
        the dense form stays available for reference/verify paths."""
        self.ensure_parity(max(L_tilde - self.L, 0))
        if self._G_cache is None or self._G_cache.shape[0] < L_tilde:
            n_par = max(L_tilde - self.L, 0)
            R = (self._R if self.parity_storage == "materialized"
                 else self.parity_rows(np.arange(n_par)))
            self._G_cache = np.concatenate([np.eye(self.L), R])
        return self._G_cache[:L_tilde]

    def encoded_rows(self, rows: np.ndarray) -> np.ndarray:
        """Gather encoded weight rows from the packed cache."""
        return self.gather_encoded(rows)

    def device_rows(self, n_rows: int):
        """Float32 device-resident ``[W; WR]`` prefix of ``n_rows`` rows.

        Uploaded once and grown *incrementally*: only parity rows encoded
        since the last call transfer to the device — the persistent cache
        the batched kernel path gathers its shard tiles from.  Virtual
        storage keeps no such mirror (the generated-parity kernel derives
        parity in-grid against :meth:`device_W`), so this raises there."""
        if self.parity_storage != "materialized":
            raise RuntimeError(
                f"CodedLinear({self.name!r}): parity_storage='virtual' "
                "keeps no device [W; WR] mirror — the batched device path "
                "uses device_W() + parity_ctrs() with the generated-parity "
                "kernel instead")
        self.ensure_parity(max(n_rows - self.L, 0))
        tr = current_tracer()
        if self._enc_dev is None:
            self._enc_dev = torch.from_numpy(self._enc[:self._n_enc]).to(
                device=self.device, dtype=torch.float32)
            if tr is not None:
                tr.count("device_cache_upload_rows", self._n_enc)
            self._n_dev = self._n_enc
        elif self._n_dev < self._n_enc:
            fresh = torch.from_numpy(self._enc[self._n_dev:self._n_enc]).to(
                device=self.device, dtype=torch.float32)
            self._enc_dev = torch.cat([self._enc_dev, fresh])
            if tr is not None:
                tr.count("device_cache_upload_rows",
                         self._n_enc - self._n_dev)
            self._n_dev = self._n_enc
        else:
            if tr is not None:
                tr.count("device_cache_hits")
        return self._enc_dev[:n_rows]

    # -- reference -----------------------------------------------------------

    def local(self, X: np.ndarray) -> np.ndarray:
        """The uncoded product X @ W.T (float64) — the verify reference and
        the matmul the ``coded=False`` bridge serves with."""
        return np.asarray(X, dtype=np.float64) @ self.W.T

    # -- prefix planning -----------------------------------------------------

    def prefix_plan(self, l_int: np.ndarray, finish: np.ndarray,
                    t_complete: float,
                    order: Optional[np.ndarray] = None,
                    assign: Optional[np.ndarray] = None) -> PrefixPlan:
        """Derive the earliest covering prefix of a dispatch — timing only.

        l_int:  (N+1,) integer shard sizes (Σ ≥ L; contiguous row slices,
                exactly the executor's dispatch layout).
        finish: (N+1,) absolute delivery times (inf = never); the earliest
                prefix covering L by ``t_complete`` feeds the decode.
        order:  optional pre-computed stable argsort of the active nodes'
                finish times (the step barrier computes all tasks' orders
                in one batched call).
        assign: optional (N+1,) sort key fixing which node holds which
                contiguous row range.  ``None`` assigns ranges in node
                order (the historical layout).  The serving bridge passes
                each node's *expected* delay (dispatch-time information
                only — no realized delays), so the systematic prefix sits
                on the statistically fastest nodes: covering prefixes then
                carry mostly identity rows, the decode's parity block
                shrinks, and the pure-scatter fast path fires far more
                often.  Any assignment decodes exactly — this is purely a
                decode-cost optimisation the systematic code enables.
        """
        l_int = np.asarray(l_int, dtype=np.int64)
        total = int(l_int.sum())
        if total < self.L:
            raise ValueError(f"shards cover {total} < L={self.L} rows")
        self.ensure_parity(total - self.L)
        active = np.nonzero(l_int > 0)[0]
        l_act = l_int[active]
        if assign is None:
            edges = np.concatenate([[0], np.cumsum(l_act)])
        else:
            aorder = np.argsort(assign[active], kind="stable")
            starts = np.empty(active.size, dtype=np.int64)
            starts[aorder] = np.concatenate(
                [[0], np.cumsum(l_act[aorder])[:-1]])
            edges = np.concatenate([starts, [total]])  # per-active starts
        f_act = finish[active]
        if order is None:
            order = np.argsort(np.where(np.isfinite(f_act), f_act, np.inf),
                               kind="stable")
        f_ord = f_act[order]
        ok = np.isfinite(f_ord) & (f_ord <= t_complete + 1e-9)
        cum = np.cumsum(np.where(ok, l_act[order], 0))
        stop = int(np.searchsorted(cum, self.L))
        if stop >= cum.size or cum[stop] < self.L:
            raise RuntimeError("deliveries do not cover L by t_complete")
        sel = np.nonzero(ok[:stop + 1])[0]
        picked = order[sel]
        # the covering prefix is fixed (completion semantics untouched);
        # *within* it, decode from the received systematic rows first and
        # fill the remainder with the earliest-delivered parity rows —
        # the decode-free fast path the systematic code exists for.  With
        # the expected-delay assignment above, most prefixes then pin
        # (nearly) every coordinate by scatter and the parity solve block
        # shrinks to the overlap shortfall.
        starts = edges[picked]
        stops_ = starts + l_act[picked]
        rows, slices, used = _assemble_prefix(self.L, active[picked],
                                              starts, stops_)
        par = rows[rows >= self.L] - self.L
        return PrefixPlan(rows=rows, slices=slices, used=used, total=total,
                          used_solve=bool(par.size),
                          parity_ctrs=self.parity_ctrs(par)
                          if par.size else None)

    # -- decode --------------------------------------------------------------

    def decode_plan(self, rows: np.ndarray) -> bk.DecodePlan:
        """X-independent decode structure for one received-rows vector
        (the generator is systematic by construction — the identity-prefix
        scan is skipped).  Memoised on the received-rows vector: at steady
        state every step of a serve decodes the same frozen prefix, so the
        factorization is computed once and replayed."""
        key = rows.tobytes()
        if self._dplan_memo is not None and self._dplan_memo[0] == key:
            return self._dplan_memo[1]
        total = max(int(rows.max()) + 1, self.L)
        if self.parity_storage == "virtual":
            # lazy-row generator adapter: the planner gathers only the
            # parity rows the mixed groups actually solve with — the dense
            # (total, L) G is never formed
            G = bk.SystematicRows(self.L, total, self.parity_rows)
        else:
            G = self.generator(total)
        plan = bk.plan_decode(G, rows[None], identity_prefix=True)
        self._dplan_memo = (key, plan)
        return plan

    # -- one step (the serial reference engine) ------------------------------

    def step(self, X: np.ndarray, l_int: np.ndarray, finish: np.ndarray,
             t_complete: float,
             assign: Optional[np.ndarray] = None,
             plan: Optional[PrefixPlan] = None,
             mutate=None) -> LinearStep:
        """Execute one coded product for an activation batch, shard by
        shard — the serial reference the batched engine is bit-checked
        against.

        X: (B, D) input activations (float64); each row is one token/
        position of the step's batch.  See :meth:`prefix_plan` for the
        timing arguments.  ``plan`` supplies a pre-computed (possibly
        cached) covering prefix; planning is skipped entirely then.
        ``mutate(y, plan)`` is the fault injector's hook, called on the
        freshly assembled (L, B) product block before the decode — the
        serial twin of :meth:`PackedStage.execute`'s ``mutate``.
        """
        X = np.asarray(X, dtype=np.float64)
        tr = current_tracer()
        if plan is None:
            ctx = tr.span(f"plan:{self.name}", cat="plan") \
                if tr is not None else contextlib.nullcontext()
            with ctx:
                plan = self.prefix_plan(l_int, finish, t_complete,
                                        assign=assign)
        # the per-worker shard execution: each node's encoded rows × X
        ctx = tr.span(f"product:{self.name}", cat="kernel",
                      args={"rows": int(plan.rows.size),
                            "workers": int(plan.used.size)}) \
            if tr is not None else contextlib.nullcontext()
        with ctx:
            y = np.concatenate([shard_products(self.gather_encoded(sl), X)
                                for sl in plan.slices])       # (L, B)
        if mutate is not None:
            mutate(y, plan)
        # decode_plan / apply time themselves (repro_torch.stream.backend spans)
        z = self.decode_plan(plan.rows).apply(
            y[None], backend=self.backend, device=self.device)[0]
        return LinearStep(out=z.T, rows=plan.rows,
                          workers_used=plan.used,
                          rows_dispatched=plan.total,
                          used_solve=plan.used_solve,
                          decode_backend=self.decode_backend)


# ---------------------------------------------------------------------------
# The output head — a named CodedLinear
# ---------------------------------------------------------------------------

#: Result of one coded head execution (``.logits`` aliases ``.out``).
HeadStep = LinearStep


class CodedLMHead(CodedLinear):
    """Systematic-MDS-encoded output head, executed shard-by-shard.

    Historically the bridge coded only the output-head matmul and a
    separate module held this implementation; the per-layer
    generalisation is :class:`CodedLinear` and the head is now just the
    instance named ``"head"``: W is ``launch.serve.head_matrix``
    (L = padded vocab) and the step result exposes the decoded product
    as ``.logits``.

    W: (L, D) float weight matrix.
    seed: parity-generator seed (one head = one generator stream).
    backend: "numpy" | "torch" for the parity encode + decode solve.
    """

    def __init__(self, W: np.ndarray, *, seed: int = 0,
                 backend: str = "numpy", parity_chunk: int = 256,
                 parity_storage: str = "materialized", device=None):
        super().__init__(W, name="head", seed=seed, backend=backend,
                         parity_chunk=parity_chunk,
                         parity_storage=parity_storage, device=device)
