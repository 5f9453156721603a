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
from the generated-parity kernel).  The device products are the offload
path: float32 tiles and activations, multiplied exactly and summed in
float64 (``product_dtype``), so the float64 decode amplifies no float32
rounding — host products stay float64 so greedy tokens remain
bit-identical to the uncoded pipeline.

Decode on the card.  With ``backend="torch"`` the substitution decode
runs on the card in float64 (:class:`_DeviceDecodeGroup`): the
unknown-column parity minor ``R[par, unk]`` is derived blockwise from the
rows' packed counters by the counter-rows kernel, and the substitution
term ``R[par, known] @ y_known`` by the parity-contraction kernel, which
derives the known-column entries in registers — at llama3.2-1b's head (L
= 128 512, a ~56k-row solve) the dense parity rows (s × L) and the
known-column block (s × (L − s)) would each take tens of GB and are never
formed.  The minor (s × s) is LU-factored in place in float64 while its
8 s² bytes fit the card (:func:`minor_route`); past that it is factored in
float32 (4 s² bytes; its entries are float32 values, so the copy is
exact) and each solve is refined in float64 against the minor's float64
product from the contraction kernel (:func:`refine_solve`) — a decode the
card holds up to s ≈ 140k parity rows instead of ≈ 95k.  The numpy
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

import collections
import contextlib
import dataclasses
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..obs import current_tracer, device_span
from ..stream import backend as bk
from .coded_linear import CodedLinear, shard_products

__all__ = ["ShardProblem", "PackedShards", "PackedStage",
           "pack_shard_problems", "DeviceRowsDecode",
           "device_verify_residuals"]

#: parity entries derived per chunk of the minor build (≈1 GB float32
#: before its float64 copy into the minor) and of the known term on the
#: CPU — bounds their transient memory
DECODE_CHUNK = 1 << 28
#: trace category of the on-card decode's parts (known term, minor build
#: and factorisation with the build inside it, LU solve): nested inside
#: the ``decode`` stage span, so outside the stage categories that tile a
#: step
_SPLIT = "decode_split"
#: bytes a parity minor may take on the card; None: the card's free
#: memory, less :data:`MINOR_MARGIN`, when the minor is factored (tests
#: lower it to send a small minor down the refined route)
MINOR_BUDGET = None
#: what the budget leaves free for the factorisation's workspace and the
#: decode's other buffers
MINOR_MARGIN = 4 << 30
#: the refined route's sweeps before it gives up (LAPACK dsgesv's ITERMAX)
REFINE_SWEEPS = 30
#: minors factored and refined solves run, by route, and the sweeps of
#: each refined solve (the smoke run prints them)
ROUTES = {"float64": 0, "refined": 0}
SWEEPS: List[int] = []
#: cached factors released to make room for another minor (a released
#: member refactors from its counters on its next solve)
RELEASED: List[int] = []
#: members holding factors, least recently used first
_FACTORED: "collections.OrderedDict[int, weakref.ref]" = \
    collections.OrderedDict()


def _factored(device, keep=None) -> list:
    """The live members other than ``keep`` holding factors on
    ``device``, least recently used first."""
    out = []
    for key, ref in list(_FACTORED.items()):
        m = ref()
        if m is None or m.lu is None:
            del _FACTORED[key]
        elif m is not keep and m.lu[0].device == device:
            out.append(m)
    return out


def _nbytes(m) -> int:
    return m.lu[0].numel() * m.lu[0].element_size()


def _free(device) -> int:
    """Bytes free on the card for a minor: the allocator's cached blocks
    returned first (a freed minor of another plan stays cached in them)."""
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0] - MINOR_MARGIN


def _make_room(need: int, device, keep) -> None:
    """Release other members' cached factors, least recently used first,
    until ``need`` bytes are free on the card."""
    for m in _factored(device, keep):
        if _free(device) >= need:
            return
        RELEASED.append(_nbytes(m))
        m.lu = None
        torch.cuda.empty_cache()


def minor_route(n: int, device: torch.device, keep=None) -> str:
    """The decode route of an (n, n) parity minor, by its size alone:
    ``"float64"`` (an in-place float64 LU) while 8 n² bytes fit the
    budget, else ``"refined"`` (a float32 LU, refined in float64) while 4
    n² bytes do; else a ``MemoryError`` that states n and the bytes.  The
    budget is :data:`MINOR_BUDGET`, or the card's free memory less
    :data:`MINOR_MARGIN` plus what the cached factors of members other
    than ``keep`` hold, which a factorisation releases when it needs the
    room (unbounded on the CPU)."""
    if MINOR_BUDGET is not None:
        budget = MINOR_BUDGET
    elif device.type == "cuda":
        budget = _free(device) + sum(_nbytes(m)
                                     for m in _factored(device, keep))
    else:
        budget = float("inf")
    if 8 * n * n <= budget:
        return "float64"
    if 4 * n * n <= budget:
        return "refined"
    held = f" ({torch.cuda.memory_allocated(device)} allocated)" \
        if device.type == "cuda" else ""
    raise MemoryError(
        f"a parity minor of s = {n} rows needs {8 * n * n} bytes in float64 "
        f"or {4 * n * n} in float32; the card holds {int(budget)}{held}")


def refine_solve(fac, b: torch.Tensor, matvec, anorm: float
                 ) -> Tuple[torch.Tensor, int]:
    """Solve A z = b in float64 from float32 LU factors ``fac`` of A by
    iterative refinement: z from the factors, then per sweep the float64
    residual r = b - ``matvec(z)`` (A @ z in float64), a float32 solve for
    the correction d and z += d.  It stops when every column's residual
    satisfies ‖r‖∞ ≤ √n · u · ‖A‖∞ · ‖z‖∞ (u the float64 unit roundoff,
    ``anorm`` = ‖A‖∞; LAPACK dsgesv's test: z's backward error is then a
    small multiple of u, as an LU in float64 would give), and raises
    ``LinAlgError`` when a value is not finite or :data:`REFINE_SWEEPS`
    sweeps do not get there (A too ill-conditioned for float32 factors).
    ``b`` (n, C) float64 → (z (n, C) float64, sweeps run)."""
    n = b.shape[0]
    tol = n ** 0.5 * float(torch.finfo(torch.float64).eps) / 2 * anorm

    def correction(r):
        # scaled into float32's range column by column
        s = r.abs().amax(dim=0, keepdim=True).clamp(min=1e-300)
        return bk.lu_solve_torch(fac, (r / s).float()).double() * s

    z = correction(b)
    for sweep in range(REFINE_SWEEPS + 1):
        r = b - matvec(z)
        rn = r.abs().amax(dim=0)
        if not bool(torch.isfinite(rn).all()):
            raise np.linalg.LinAlgError("refined decode: non-finite residual")
        if bool((rn <= tol * z.abs().amax(dim=0)).all()):
            return z, sweep
        if sweep < REFINE_SWEEPS:
            z = z + correction(r)
    raise np.linalg.LinAlgError(
        f"refined decode: no convergence in {REFINE_SWEEPS} sweeps (residual "
        f"{float(rn.max()):.3e}, bound {tol * float(z.abs().max()):.3e}): the "
        f"minor is too ill-conditioned for float32 factors")


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

    def products_device(self, X: np.ndarray, *,
                        out_dtype: torch.dtype = torch.float64
                        ) -> List[torch.Tensor]:
        """One-launch device execution of every packed product → per-
        problem (L_t, B) device slices in ``out_dtype`` (the offload
        path; float64 by default, since the products feed the decode)."""
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
            parity=self._gen_specs or None, out_dtype=out_dtype)
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
                 "lu", "checked", "route", "anorm", "__weakref__")

    def __init__(self, lin: CodedLinear, r: np.ndarray):
        dev = lin.device
        sys_pos, par_pos, sys_rows, unk = _partition(r, lin.L)
        # int32 holding the uint32 bits: the kernels' operand type (and an
        # index type), so no call of a frozen plan converts its operands
        t = lambda a: torch.from_numpy(
            np.asarray(a, np.uint32).view(np.int32)).to(dev)
        self.lin = lin
        self.sys_pos, self.par_pos = t(sys_pos), t(par_pos)
        self.sys_rows, self.unk = t(sys_rows), t(unk)
        self.ctrs = t(lin.parity_ctrs(r[par_pos] - lin.L))
        self.lu = None
        self.checked = False
        self.route = None
        self.anorm = 0.0

    def factor(self, route: str = None) -> None:
        """Build the (s, s) unknown-column minor, column-major, and
        LU-factor it in place — in float64, or in float32 on the refined
        route (:func:`minor_route`; one copy of the minor either way); its
        rows come from the counter-rows kernel in chunks of ≤
        :data:`DECODE_CHUNK` entries."""
        from ..kernels import ops
        n = self.ctrs.numel()
        dev = self.ctrs.device
        self.route = route or minor_route(n, dev, keep=self)
        refined = self.route == "refined"
        if dev.type == "cuda" and MINOR_BUDGET is None:
            _make_room((4 if refined else 8) * n * n, dev, keep=self)
        A = torch.empty((n, n), dtype=torch.float32 if refined
                        else torch.float64, device=dev).mT
        rowsum = torch.zeros(n, dtype=torch.float64, device=dev)
        step = max(1, DECODE_CHUNK // n)
        with device_span("decode:minor", cat=_SPLIT,
                         args={"route": self.route}) as fence:
            for i in range(0, n, step):
                rows = ops.counter_parity_rows(
                    self.lin.pkey, self.lin.L, self.ctrs[i:i + step],
                    cols=self.unk)
                A[i:i + step] = rows
                if refined:
                    rowsum[i:i + step] = rows.abs().sum(1, dtype=torch.float64)
                del rows
            fence(A)
        self.anorm = float(rowsum.max())
        self.lu = bk.lu_factor_torch(A)
        ROUTES[self.route] += 1
        _FACTORED[id(self)] = weakref.ref(self)

    def known_term(self, sys_y: torch.Tensor) -> torch.Tensor:
        """``R[par, known] @ y_known`` with float64 accumulation, in one
        kernel on the card (``R[par, known]`` is never formed); on the
        CPU in row chunks of ≤ :data:`DECODE_CHUNK` entries."""
        from ..kernels import ops
        return ops.parity_contract(self.lin.pkey, self.lin.L, self.ctrs,
                                   sys_y, cols=self.sys_rows,
                                   chunk=DECODE_CHUNK)

    def _minor_product(self, z: torch.Tensor) -> torch.Tensor:
        """``R[par, unk] @ z`` in float64 from the counters (the minor's
        float64 product, in one kernel on the card)."""
        from ..kernels import ops
        return ops.parity_contract(self.lin.pkey, self.lin.L, self.ctrs,
                                   z.contiguous(), cols=self.unk,
                                   chunk=DECODE_CHUNK)

    def solve(self, y0: torch.Tensor, z0: torch.Tensor) -> None:
        if id(self) in _FACTORED:
            _FACTORED.move_to_end(id(self))     # most recently used
        sys_y = y0[self.sys_pos]
        with device_span("decode:known_term", cat=_SPLIT,
                         args={"rows": int(self.ctrs.numel()),
                               "cols": int(self.sys_rows.numel())}) as fence:
            rhs = y0[self.par_pos] - fence(self.known_term(sys_y))
        if self.lu is None:
            n = int(self.ctrs.numel())
            route = minor_route(n, self.ctrs.device, keep=self)
            with device_span("decode:factor", cat=_SPLIT,
                             args={"n": n, "route": route}) as fence:
                self.factor(route)
                fence(self.lu)
        with device_span("decode:lu_solve", cat=_SPLIT,
                         args={"route": self.route}) as fence:
            if self.route == "refined":
                sol, sweeps = refine_solve(
                    self.lu, rhs, self._minor_product, self.anorm)
                SWEEPS.append(sweeps)
            else:
                sol = bk.lu_solve_torch(self.lu, rhs)
            fence(sol)
        if not self.checked:
            if not bool(torch.isfinite(sol).all()):
                raise np.linalg.LinAlgError("Singular matrix")
            self.checked = True
        z0[self.sys_rows] = sys_y                            # exact pins
        z0[self.unk] = sol


class DeviceRowsDecode:
    """An exactly-L decode of one coded layer from the rows ``rows``, on
    the card — the fault layer's recovery decode for virtual parity on the
    torch backend, in place of :func:`repro_torch.stream.backend
    .plan_decode` over a lazy generator, which gathers the parity rows'
    dense (s, L) float64 block on the host (tens of GB at an output head's
    L).  The same substitution solve the batched engine runs
    (:class:`_DeviceMember`: the minor from the counter-rows kernel, the
    known term from the contraction kernel, a float64 LU or a refined
    float32 one); a prefix of
    systematic rows alone is a scatter.  ``apply`` takes and returns the
    host (1, L[, C]) layout of :meth:`DecodePlan.apply`."""

    def __init__(self, lin: CodedLinear, rows: np.ndarray):
        self.rows = np.asarray(rows)
        self.lin = lin
        self.member = _DeviceMember(lin, self.rows) \
            if (self.rows >= lin.L).any() else None

    def apply(self, y: np.ndarray, **_kw) -> np.ndarray:
        y = np.asarray(y, dtype=np.float64)
        dev = self.lin.device
        y0 = bk.as_f64(y[0].reshape(self.lin.L, -1), dev)
        z0 = torch.empty_like(y0)
        if self.member is None:
            z0[bk._idx_t(self.rows, dev)] = y0
        else:
            self.member.solve(y0, z0)
        return z0.cpu().numpy().reshape(y.shape)


def device_verify_residuals(lin: CodedLinear, rows: np.ndarray,
                            x_hat: np.ndarray, y: np.ndarray) -> np.ndarray:
    """:meth:`repro_torch.stream.backend.VerifyPlan.residuals` of the
    delivered ``rows`` (S,) of one virtual-parity layer, with the parity
    rows' predictions R[par] @ x̂ from the contraction kernel on the card
    (R never formed; a systematic row predicts x̂[r]).  ``x_hat`` (L[, C])
    and ``y`` (S[, C]) host arrays → (S,)."""
    x = np.asarray(x_hat, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    par = rows >= lin.L
    pred = np.empty(y.shape)
    pred[~par] = x[rows[~par]]
    if par.any():
        from ..kernels import ops
        xt = bk.as_f64(x.reshape(lin.L, -1), lin.device)
        p = ops.parity_contract(lin.pkey, lin.L,
                                lin.parity_ctrs(rows[par] - lin.L), xt)
        pred[par] = p.cpu().numpy().reshape(pred[par].shape)
    res = np.abs(y - pred) / (1.0 + np.abs(y))
    return res.max(axis=-1) if res.ndim == 2 else res


class _DeviceDecodeGroup:
    """The torch twin of :class:`_DecodeGroup`: the same substitution
    decode, run on the card in float64.

    Each member's unknown-column minor ``R[par, unk]`` is derived by the
    counter-rows kernel in row chunks into one column-major float64
    buffer (float32 on the refined route, :func:`minor_route`) and
    LU-factored in place on first use (once per frozen plan, again if
    its factors were released to make room for another minor);
    each step contracts the known-column entries against the pinned values
    in float64 in one kernel per 8 columns — neither the dense parity rows
    nor the known-column block ever exists."""

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
                product_dtype: torch.dtype = torch.float64,
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
            y = self.pack.products_device(X, out_dtype=product_dtype)
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
                # no copy when the device products are already float64
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
