"""Ragged-shard packing: a step's coded shard products as one pass — the
port of ``repro.serve_coded.packing``.

The serial engine executes a coded matmul shard-by-shard: one small host
matmul per worker per matrix, then one decode per matmul.  This module is
the batched alternative: the *prefix plans* of all matmuls that share a
right-hand operand (one dependency stage of the forward) are packed into
one row-gather over the layers' persistent encoded caches, executed as a
single product, and decoded through one stacked substitution solve per
row-count group.

Layout.  A :class:`PackedShards` concatenates each problem's prefix rows
into one (P, D) float64 buffer with per-problem offsets — rows stay in
delivery order, so slicing the packed product at the offsets reproduces
the serial per-task results *bit-identically* (the product primitive is
row-stable; see :func:`repro_torch.serve_coded.coded_linear
.shard_products`).  The host buffer is gathered lazily, only when the host
product runs.  For the device path the rows are padded to ``tile``-aligned
row tiles and a 128-aligned contraction width::

    problem 0: rows r00 r01 r02 …   ┐ gather            ┌ tile 0 (128, Dp)
    problem 1: rows r10 r11 …       ├──────▶ (P, D) ──▶ │ tile 1 (128, Dp)
    problem 2: rows r20 …           ┘  pad P→T·128,     └ …   (zero rows)
                                       D→Dp=⌈D/128⌉·128

and :func:`repro_torch.kernels.ops.coded_shard_matmul_batch` runs every
tile in one launch of the coded_matvec kernel (virtual-parity lanes come
from the generated-parity kernel).  The float32 device products are the
offload path — host products stay float64 so greedy tokens remain
bit-identical to the uncoded pipeline.

Decode on the card.  With ``backend="torch"`` the substitution decode
runs on the card in float64 (:class:`_DeviceDecodeGroup`): the
unknown-column parity minor ``R[par, unk]`` and the substitution term
``R[par, known] @ y_known`` are derived blockwise from the rows' packed
counters by the counter-rows kernel — at llama3.2-1b's head (L = 128 512,
a ~56k-row solve) the dense parity rows (s × L) and the known-column block
(s × (L − s)) would each take tens of GB and are never formed.  The numpy
engine derives the same two blocks column-restricted on the host
(:class:`_DecodeGroup`), bit-identical to slicing the dense rows.

X-independence.  Everything here is built from dispatch timing alone
(prefix rows, packed gathers, stacked decode plans), so the bridge packs
a whole :class:`~repro_torch.stream.barrier.StepBarrier` when the step is
dispatched and only the products + solves run inside the token loop —
and a multi-token dispatch (``steps_per_dispatch``) re-uses the packs for
every token.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..obs import current_tracer
from ..stream import backend as bk
from .coded_linear import CodedLinear, shard_products

__all__ = ["ShardProblem", "PackedShards", "PackedStage",
           "pack_shard_problems"]

#: parity entries derived per chunk of the on-card decode (≈1 GB float32
#: plus its float64 copy) — bounds the transient memory of the minor
#: build and of the substitution term
DECODE_CHUNK = 1 << 28


@dataclasses.dataclass
class ShardProblem:
    """One coded matmul's prefix execution spec inside a packed stage."""
    key: str
    linear: CodedLinear
    rows: np.ndarray            # (L,) coded-row ids, delivery order
    used_solve: bool


class PackedShards:
    """Packed row-gather over the problems' persistent encoded caches.

    ``products(X)`` is the one-pass host execution; ``device_tiles()`` /
    ``products_device(X)`` are the 128-aligned tile layout and the
    one-launch kernel execution for the torch backend.
    """

    def __init__(self, problems: Sequence[ShardProblem], *, tile: int = 128):
        if not problems:
            raise ValueError("pack needs at least one problem")
        D = {p.linear.D for p in problems}
        if len(D) != 1:
            raise ValueError(f"packed problems must share the contraction "
                             f"width D, got {sorted(D)}")
        self.problems = list(problems)
        self.D = D.pop()
        self.tile = int(tile)
        counts = np.array([p.rows.size for p in self.problems])
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.total = int(self.offsets[-1])
        self._W_packed = None
        self._tiles = None
        self._gen_specs = None

    @property
    def W_packed(self) -> np.ndarray:
        """The packed host buffer: one storage-agnostic gather per problem
        (materialised: the packed [W; WR] cache; virtual: W rows + the
        memoised per-block counter-derived encodes — same bits), built on
        first use so the device path never encodes parity rows on the
        host."""
        if self._W_packed is None:
            W = np.empty((self.total, self.D))
            for i, p in enumerate(self.problems):
                p.linear.gather_encoded(
                    p.rows, out=W[self.offsets[i]:self.offsets[i + 1]])
            self._W_packed = W
        return self._W_packed

    # -- host one-pass execution (float64, bit-identical to serial) ---------

    def products(self, X: np.ndarray) -> List[np.ndarray]:
        """All problems' shard products in one contraction → per-problem
        (L_t, B) float64 slices (bit-identical to the serial per-worker
        loop: the primitive is row-stable)."""
        Y = shard_products(self.W_packed, np.asarray(X, dtype=np.float64))
        return [Y[self.offsets[i]:self.offsets[i + 1]]
                for i in range(len(self.problems))]

    # -- device tile layout + one-launch execution (float32) ----------------

    @property
    def n_tiles(self) -> int:
        return -(-self.total // self.tile)

    def device_tiles(self) -> torch.Tensor:
        """(T, tile, Dp) float32 device tiles of the packed rows, gathered
        from each layer's incremental device cache (zero rows pad the last
        tile; Dp pads D to 128 lanes).

        Virtual-parity problems gather only their *systematic* lanes from
        the device-resident W; parity lanes stay zero here and their
        products are written by the generated-parity kernel at execution
        time (:meth:`products_device`) — no ``[W; WR]`` mirror ever
        exists."""
        dev = self.problems[0].linear.device
        Dp = -(-self.D // 128) * 128
        tiles = torch.zeros((self.n_tiles * self.tile, Dp),
                            dtype=torch.float32, device=dev)
        for i, p in enumerate(self.problems):
            r = np.asarray(p.rows)
            o = int(self.offsets[i])
            if p.linear.parity_storage == "virtual":
                pos = np.nonzero(r < p.linear.L)[0]
                src = p.linear.device_W()[torch.from_numpy(r[pos]).to(dev)]
                tiles[torch.from_numpy(o + pos).to(dev), :self.D] = src
            else:
                n = max(int(r.max()) + 1, p.linear.L)
                tiles[o:o + r.size, :self.D] = \
                    p.linear.device_rows(n)[torch.from_numpy(r).to(dev)]
        return tiles.reshape(self.n_tiles, self.tile, Dp)

    def products_device(self, X: np.ndarray) -> List[torch.Tensor]:
        """One-launch device execution of every packed product → per-
        problem (L_t, B) float32 device slices (the offload path)."""
        from ..kernels import ops
        if self._tiles is None:
            self._tiles = self.device_tiles()
        if self._gen_specs is None:
            # virtual-parity lane specs, frozen once per pack: the flat
            # tile-space lane, its packed threefry counter, and the layer
            # key/W the generated kernel derives the row from
            self._gen_specs = []
            for i, p in enumerate(self.problems):
                if p.linear.parity_storage != "virtual":
                    continue
                r = np.asarray(p.rows)
                par_pos = np.nonzero(r >= p.linear.L)[0]
                if not par_pos.size:
                    continue
                self._gen_specs.append(ops.GeneratedParity(
                    lanes=self.offsets[i] + par_pos,
                    ctrs=p.linear.parity_ctrs(r[par_pos] - p.linear.L),
                    key=p.linear.pkey,
                    w=p.linear.device_W()))
        X = np.asarray(X, dtype=np.float64)
        Dp = self._tiles.shape[-1]
        Xp = torch.zeros((Dp, X.shape[0]), dtype=torch.float32,
                         device=self._tiles.device)
        Xp[:self.D] = torch.from_numpy(X.T).to(Xp.device, torch.float32)
        Y = ops.coded_shard_matmul_batch(
            self._tiles, Xp,
            parity_mode="generated" if self._gen_specs else "materialized",
            parity=self._gen_specs or None)
        flat = Y.reshape(-1, X.shape[0])
        return [flat[self.offsets[i]:self.offsets[i + 1]]
                for i in range(len(self.problems))]


def pack_shard_problems(problems: Sequence[ShardProblem], *,
                        tile: int = 128) -> PackedShards:
    """Bucket a stage's ragged shard row-slices into one packed gather."""
    return PackedShards(problems, tile=tile)


def _partition(r: np.ndarray, L: int):
    """Receive positions of the systematic / parity rows of one prefix,
    the pinned coordinates, and the unknown ones (their complement)."""
    m_sys = r < L
    sys_pos = np.nonzero(m_sys)[0]
    par_pos = np.nonzero(~m_sys)[0]
    sys_rows = r[sys_pos]
    known = np.zeros(L, dtype=bool)
    known[sys_rows] = True
    return sys_pos, par_pos, sys_rows, np.nonzero(~known)[0]


class _DecodeGroup:
    """Stacked decode structure for one (L, s) group of a stage (numpy).

    The same substitution decomposition :func:`repro_torch.stream.backend
    .plan_decode` builds — received systematic rows pin coordinates, the
    (L−s)-sized parity block solves the rest — specialised to the serving
    layout: the systematic generator is ``[I; R]`` by construction, so the
    two parity sub-blocks (known and unknown columns) are derived
    column-restricted straight from each layer's packed counters
    (:meth:`CodedLinear.parity_rows` with ``cols``) — bit-identical to
    slicing dense parity rows, without forming them.  Every block is
    C-ordered, the layout the serial engine's blocks have (BLAS results
    are layout-sensitive at the last bit), so per-item solve inputs are
    value- and layout-identical to the serial engine's and the decoded
    outputs match it bit-for-bit on numpy however tasks are stacked.
    """

    __slots__ = ("sel", "perm", "rows", "sys_pos", "par_pos", "sys_rows",
                 "unk", "lu", "Gk")

    def __init__(self, sel, problems, rows, s):
        self.sel = sel                          # (gs,) indices into L-group
        L = rows.shape[1]
        if s == L:
            self.perm = True
            self.rows = rows
            return
        self.perm = False
        parts = [_partition(rows[j], L) for j in range(sel.size)]
        self.sys_pos = np.stack([p[0] for p in parts])        # (gs, s)
        self.par_pos = np.stack([p[1] for p in parts])        # (gs, L-s)
        self.sys_rows = np.stack([p[2] for p in parts])
        self.unk = np.stack([p[3] for p in parts])
        pr = [rows[j][p[1]] - L for j, p in enumerate(parts)]
        lins = [problems[i].linear for i in sel]
        self.Gk = np.stack([lin.parity_rows(pr[j], cols=self.sys_rows[j])
                            for j, lin in enumerate(lins)])   # (gs, L-s, s)
        self.lu = bk.StackedLU(np.stack(
            [lin.parity_rows(pr[j], cols=self.unk[j])
             for j, lin in enumerate(lins)]))               # (gs, L-s, L-s)

    def apply(self, yg: np.ndarray, z: np.ndarray) -> None:
        """Decode this group's slice of the stacked products into ``z``
        through the group's cached LU factors (getrf once per frozen plan,
        getrs per step)."""
        if self.perm:
            z[self.sel[:, None], self.rows] = yg[self.sel]
            return
        if self.sel.size == 1:
            # dominant serving case: 1D gathers + a 2D gemm gather the
            # same values as the stacked path below (one dgemm either
            # way), minus the broadcast-index overhead per call
            y0 = yg[self.sel[0]]
            sys_y = y0[self.sys_pos[0]]
            par_y = y0[self.par_pos[0]]
            sol = self.lu.solve((par_y - self.Gk[0] @ sys_y)[None])
            z0 = z[self.sel[0]]
            z0[self.sys_rows[0]] = sys_y                     # exact pins
            z0[self.unk[0]] = sol[0]
            return
        sel2 = self.sel[:, None]
        ys = yg[self.sel]
        g_ar = np.arange(self.sel.size)[:, None]
        sys_y = ys[g_ar, self.sys_pos]
        par_y = ys[g_ar, self.par_pos]
        sol = self.lu.solve(par_y - self.Gk @ sys_y)
        z[sel2, self.sys_rows] = sys_y                       # exact pins
        z[sel2, self.unk] = sol


class _DeviceMember:
    """One problem's on-card substitution solve (see
    :class:`_DeviceDecodeGroup`)."""

    __slots__ = ("lin", "sys_pos", "par_pos", "sys_rows", "unk", "ctrs",
                 "lu", "checked")

    def __init__(self, lin: CodedLinear, r: np.ndarray):
        dev = lin.device
        sys_pos, par_pos, sys_rows, unk = _partition(r, lin.L)
        t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
        self.lin = lin
        self.sys_pos, self.par_pos = t(sys_pos), t(par_pos)
        self.sys_rows, self.unk = t(sys_rows), t(unk)
        self.ctrs = t(lin.parity_ctrs(r[par_pos] - lin.L))
        self.lu = None
        self.checked = False

    def _blocks(self, cols: torch.Tensor):
        """Row chunks ``(i, R[par[i:i+k], cols])`` float32 from the
        counter-rows kernel, ≤ :data:`DECODE_CHUNK` entries each."""
        from ..kernels import ops
        n = self.ctrs.numel()
        step = max(1, DECODE_CHUNK // max(cols.numel(), 1))
        for i in range(0, n, step):
            yield i, ops.counter_parity_rows(
                self.lin.pkey, self.lin.L, self.ctrs[i:i + step], cols=cols)

    def factor(self) -> None:
        """Build the (s, s) unknown-column minor in float64, column-major,
        and LU-factor it in place (one float64 copy of the minor)."""
        n = self.ctrs.numel()
        A = torch.empty((n, n), dtype=torch.float64,
                        device=self.ctrs.device).mT
        for i, blk in self._blocks(self.unk):
            A[i:i + blk.shape[0]] = blk
        self.lu = bk.lu_factor_torch(A)

    def known_term(self, sys_y: torch.Tensor) -> torch.Tensor:
        """``R[par, known] @ y_known`` with float64 accumulation."""
        out = torch.empty((self.ctrs.numel(), sys_y.shape[1]),
                          dtype=torch.float64, device=sys_y.device)
        for i, blk in self._blocks(self.sys_rows):
            out[i:i + blk.shape[0]] = blk.to(torch.float64) @ sys_y
        return out

    def solve(self, y0: torch.Tensor, z0: torch.Tensor) -> None:
        sys_y = y0[self.sys_pos]
        rhs = y0[self.par_pos] - self.known_term(sys_y)
        if self.lu is None:
            self.factor()
        sol = bk.lu_solve_torch(self.lu, rhs)
        if not self.checked:
            if not bool(torch.isfinite(sol).all()):
                raise np.linalg.LinAlgError("Singular matrix")
            self.checked = True
        z0[self.sys_rows] = sys_y                            # exact pins
        z0[self.unk] = sol


class _DeviceDecodeGroup:
    """The torch twin of :class:`_DecodeGroup`: the same substitution
    decode, run on the card in float64.

    Each member's unknown-column minor ``R[par, unk]`` is derived by the
    counter-rows kernel in row chunks into one column-major float64
    buffer and LU-factored in place on first use (once per frozen plan);
    each step derives the known-column block chunk by chunk and contracts
    it against the pinned values in float64 — neither the dense parity
    rows nor the known-column block ever exists whole."""

    def __init__(self, sel, problems, rows, s):
        self.sel = sel
        L = rows.shape[1]
        self.perm = s == L
        dev = problems[sel[0]].linear.device
        if self.perm:
            self.rows = torch.from_numpy(rows.astype(np.int64)).to(dev)
            return
        self.members = [_DeviceMember(problems[i].linear, rows[j])
                        for j, i in enumerate(sel)]

    def apply(self, yg: torch.Tensor, z: torch.Tensor) -> None:
        if self.perm:
            for j, i in enumerate(self.sel):
                z[i][self.rows[j]] = yg[i]
            return
        for j, i in enumerate(self.sel):
            self.members[j].solve(yg[i], z[i])


class PackedStage:
    """One dependency stage of a step: packed products + grouped decode.

    Problems are ordered by matrix height L at pack time, so each height
    group's stacked products are a contiguous *view* of the packed
    product buffer, and each (L, s) straggler group decodes as one
    stacked substitution solve (:class:`_DecodeGroup`, or
    :class:`_DeviceDecodeGroup` on the torch backend) — a stage costs one
    contraction plus one solve per group instead of a Python loop of
    per-matmul decodes.
    """

    def __init__(self, problems: Sequence[ShardProblem], *,
                 backend: str = "numpy", tile: int = 128):
        if len(problems) > 1:
            order = sorted(range(len(problems)),
                           key=lambda i: (problems[i].linear.L, i))
            self.problems = [problems[i] for i in order]
        else:
            self.problems = list(problems)
        self.backend = bk.check_backend(backend)
        # the decode-solve engine this stage runs — the bridge logs it
        self.solve_backend = backend
        self.pack = pack_shard_problems(self.problems, tile=tile)
        group = _DeviceDecodeGroup if backend == "torch" else _DecodeGroup
        # decode groups: (offset problem index, L, member count, subgroups)
        self.groups: List[Tuple[int, int, int, list]] = []
        i = 0
        n = len(self.problems)
        while i < n:
            L = self.problems[i].linear.L
            j = i
            while j < n and self.problems[j].linear.L == L:
                j += 1
            members = self.problems[i:j]
            rows = np.stack([p.rows for p in members])
            s_counts = (rows < L).sum(axis=1)
            subs = [group(np.nonzero(s_counts == s)[0], members,
                          rows[s_counts == s], int(s))
                    for s in np.unique(s_counts)]
            self.groups.append((i, L, j - i, subs))
            i = j

    def execute(self, X: np.ndarray, *,
                device_products: bool = False,
                mutate=None) -> Dict[str, np.ndarray]:
        """Decode every problem of the stage for one activation batch →
        ``{key: (B, L) exact product}``.

        ``mutate``, when given, is called with the packed product buffer
        ``Y`` (total_rows, B) after the products and before the decode —
        the fault injector's hook for corrupting a worker's returned
        rows exactly where a real Byzantine worker would (the per-problem
        row ranges are ``self.pack.offsets`` / ``self.problems``).  The
        buffer is freshly materialised here, so in-place edits never
        touch the packed weight cache."""
        tr = current_tracer()
        if device_products and self.backend == "torch":
            # the kernel launch inside products_device times itself
            # (kernels.ops device_span) — no outer kernel span here,
            # stage categories must not double count
            y = self.pack.products_device(X)
            Y = torch.cat(y) if len(y) > 1 else y[0]
        else:
            ctx = tr.span("stage:products", cat="kernel",
                          args={"rows": self.pack.total,
                                "problems": len(self.problems)}) \
                if tr is not None else contextlib.nullcontext()
            with ctx:
                Y = shard_products(self.pack.W_packed,
                                   np.asarray(X, dtype=np.float64))
        if mutate is not None:
            if isinstance(Y, torch.Tensor):
                Y = Y.to(torch.float64).cpu().numpy()
            mutate(Y)
        out: Dict[str, np.ndarray] = {}
        off = self.pack.offsets
        ctx = tr.span("stage:decode", cat="decode",
                      args={"groups": len(self.groups),
                            "solve": self.solve_backend}) \
            if tr is not None else contextlib.nullcontext()
        with ctx:
            if self.backend == "torch":
                dev = self.problems[0].linear.device
                Y = bk.as_f64(Y, dev)
            B = Y.shape[-1]
            for i0, L, g, subs in self.groups:
                yg = Y[off[i0]:off[i0] + g * L].reshape(g, L, B)  # a view
                if self.backend == "torch":
                    z = torch.empty((g, L, B), dtype=torch.float64,
                                    device=Y.device)
                    for sub in subs:
                        sub.apply(yg, z)
                    z = z.cpu().numpy()
                else:
                    z = np.empty((g, L, B))
                    for sub in subs:
                        sub.apply(yg, z)
                for j in range(g):
                    out[self.problems[i0 + j].key] = z[j].T
        return out
