"""Launch plans of the port's kernels: the GEMMs (``csrc/matmul.cu``,
``csrc/mds_encode_gemm.cu``: which tile configuration runs a product, its
grid, and how far K is split, or the encode's skinny float32 stream), the
skinny products of ``csrc/coded_matvec.cu`` (route, grid, rows per block,
X slab or copy, K slabs), the counter-derived parity contraction of
``csrc/mds_encode.cu`` (route, grid, column slabs), the
WKV recurrence of ``csrc/wkv6.cu`` (route, chunk, grid) and the blockwise
attention of ``csrc/attention.cu`` / ``csrc/attention_bwd.cu`` (tiles,
shared bytes, residency).

Plain Python, so the CPU tests can check a plan at the path's shapes; the
C entry points take the plan's numbers as arguments, check them and derive
the same grid from them.

A configuration is built for a residency (blocks per SM, set by its
registers and shared memory).  When a product has fewer than ``2 * sms``
output tiles, K is split into ``splits`` slabs of ``k_span`` (a multiple
of the configuration's BK): each slab is one block's work, written to a
workspace of ``splits * batch * M * N`` elements and summed in a fixed
order by a second pass (deterministic, no atomics).  The split count is
the largest whose grid fits a whole number of waves of resident blocks,
taking the fewest waves that give at least ``2 * sms`` blocks (or slabs of
``MIN_K_SPAN``).  One rule serves every dtype: the count whose blocks fill
their waves best measured 2% faster at the serving matmul (33 slabs for
12) and slower at the float64 verify encode (10 for 6).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

__all__ = ["TileConfig", "GemmPlan", "CONFIGS", "gemm_plan", "StreamPlan",
           "encode_plan", "MatvecPlan", "matvec_plan", "matvec_launches",
           "ContractPlan", "contract_plan", "contract_launches",
           "Wkv6Plan", "wkv6_plan", "Wkv6BwdPlan", "wkv6_bwd_plan",
           "wkv6_ops", "wkv6_bwd_ops", "AttentionPlan", "attention_plan",
           "AttentionMmaPlan", "attention_mma_plan", "attention_block_range",
           "attention_pairs", "attention_masked_pairs", "attention_flops"]

#: no slab shorter than this many K elements (the second pass and the
#: pipeline's fill cost more than a shorter slab saves)
MIN_K_SPAN = 512
MAX_SPLITS = 64


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One compiled tile configuration (the C side's ``config`` code)."""
    name: str
    code: int
    dtype: str              # "f32" | "f64"
    bm: int
    bn: int
    bk: int
    threads: int
    blocks_per_sm: int      # residency its registers and shared memory allow


CONFIGS = {
    # float32 SIMT (sgemm.cuh): 128 x 128 tiles, 8 x 8 a thread, 4-stage
    # cp.async ring of BK = 32
    "sgemm": TileConfig("sgemm", 0, "f32", 128, 128, 32, 256, 1),
    # float64 DMMA (mma.sync m16n8k8): 128 x 128 tiles, 8 mma warps of
    # 64 x 32 and a producer warpgroup
    "dgemm_wide": TileConfig("dgemm_wide", 1, "f64", 128, 128, 16, 384, 1),
    # float64 DMMA for S <= 64 columns: 128-row tiles, 4 mma warps of
    # 32 x 64 (only ceil(S / 8) n8 tiles computed) and a producer warpgroup
    "dgemm_skinny": TileConfig("dgemm_skinny", 2, "f64", 128, 64, 16, 256,
                               2),
}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    config: TileConfig
    grid: Tuple[int, int, int]      # (N tiles, M tiles, batch * splits)
    splits: int
    k_span: int                     # K elements per slab (multiple of BK)
    n_tile: int                     # columns a block computes
    ws_elems: int                   # workspace elements (0 when unsplit)
    route: str = "gemm"

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _splits(tiles: int, K: int, slots: int, sms: int) -> int:
    """Largest split count whose blocks fit ``waves`` whole waves of
    ``slots`` resident blocks, for the fewest waves that give ``2 * sms``
    blocks; 1 when the tiles alone do, or K is too short to split."""
    max_by_k = max(1, K // MIN_K_SPAN)
    if tiles >= 2 * sms or max_by_k == 1:
        return 1
    waves = 1
    while True:
        s = max(1, (waves * slots) // tiles)
        if s >= max_by_k or s >= MAX_SPLITS or tiles * s >= 2 * sms:
            return min(s, max_by_k, MAX_SPLITS)
        waves += 1


@functools.lru_cache(maxsize=256)
def gemm_plan(dtype: str, M: int, N: int, K: int, batch: int = 1,
              sms: int = 132) -> GemmPlan:
    """The launch of ``batch`` products (M x K) @ (K x N) in ``dtype``
    ("f32" or "f64") on a card of ``sms`` multiprocessors."""
    if dtype == "f32":
        cfg = CONFIGS["sgemm"]
    elif dtype == "f64":
        cfg = CONFIGS["dgemm_skinny" if N <= 64 else "dgemm_wide"]
    else:
        raise ValueError(f"gemm_plan: unknown dtype {dtype!r}")
    M, N, K = max(M, 0), max(N, 0), max(K, 0)
    gx, gy = _cdiv(N, cfg.bn), _cdiv(M, cfg.bm)
    tiles = gx * gy * batch
    splits = _splits(tiles, K, cfg.blocks_per_sm * sms, sms) if tiles else 1
    k_span = _cdiv(_cdiv(max(K, 1), splits), cfg.bk) * cfg.bk
    splits = max(1, _cdiv(K, k_span))       # no empty trailing slab
    n_tile = min(cfg.bn, _cdiv(N, 8) * 8) if cfg.name == "dgemm_skinny" \
        else cfg.bn
    return GemmPlan(cfg, (gx, gy, batch * splits), splits, k_span, n_tile,
                    splits * batch * M * N if splits > 1 else 0)


# -- the encode's skinny float32 stream (csrc/mds_encode_gemm.cu) ----------
#
# A float32 encode with at most ENC_STREAM_MAX_ROWS computed rows against
# at most ENC_STREAM_MAX_K rows of A (the coded-gradient encode: 2 parity
# rows of 4) is a stream: each thread reads the K rows of A at its columns
# once, writes them to the systematic rows and the computed rows beside
# them.  The grid is (blocks per task, tasks), blocks of
# ENC_STREAM_THREADS threads walking the columns in a grid-stride loop,
# ENC_STREAM_BLOCKS_PER_SM blocks an SM in all.  Every other float32 shape
# (the executor's 1e4 x 1e4, the float32 matmul core's) takes sgemm.

ENC_STREAM_MAX_ROWS = 8
ENC_STREAM_MAX_K = 8
ENC_STREAM_THREADS = 256
ENC_STREAM_BLOCKS_PER_SM = 8


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    rows: int               # computed rows (the parity rows when systematic)
    k: int                  # rows of A
    grid: Tuple[int, int]   # (blocks per task, tasks)
    threads: int
    route: str = "stream"

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=256)
def encode_plan(dtype: str, M: int, N: int, K: int, batch: int = 1,
                sms: int = 132):
    """The launch of an encode's ``batch`` products (M x K) @ (K x N) in
    ``dtype`` ("f32" or "f64"), M the rows the product computes (the
    parity rows of a systematic encode): the stream route for a float32
    product of at most ENC_STREAM_MAX_ROWS x ENC_STREAM_MAX_K, else
    :func:`gemm_plan`'s tiles."""
    if dtype == "f32" and 1 <= M <= ENC_STREAM_MAX_ROWS \
            and 1 <= K <= ENC_STREAM_MAX_K and N >= 1 and batch >= 1:
        if batch > 65535:
            raise ValueError(f"encode_plan: {batch} tasks, at most 65535")
        per_task = max(1, min(_cdiv(_cdiv(N, 4), ENC_STREAM_THREADS),
                              ENC_STREAM_BLOCKS_PER_SM * sms // batch))
        return StreamPlan(M, K, (per_task, batch), ENC_STREAM_THREADS)
    return gemm_plan(dtype, M, N, K, batch, sms)


# -- coded_matvec (csrc/coded_matvec.cu) ------------------------------------
#
# Narrow routes (C <= 8 columns, or float32 sums): a block of MV_WARPS
# warps owns a contiguous range of one task's rows and its warps take the
# range's groups of 2 rows in turn.  "staged": X[:, chunk] whole in shared
# memory (at most MV_STAGE_MAX bytes); "direct": X read through L1/L2 in
# 16-byte vectors, no shared memory -- in place where C is 1 or a row of
# the chunk is at most 4 whole vectors' worth of columns, else from a
# [cc][K] copy of the chunk that the launch writes first (``x_copy``).
# The grid is a whole number of waves of MV_BLOCKS_PER_SM
# blocks an SM (the residency the kernel's launch bounds hold it to) where
# the rows allow, and every block's rows are within one of the others'.
# One launch computes MV_COLS columns.
#
# "wide" (C > 8 columns summed in float64): up to MV_WIDE_COLS columns a
# launch on the FP64 tensor cores, blocks of MV_WIDE_ROWS rows, K split
# into ``splits`` slabs of ``k_span`` -- a function of K and the element
# size only, never of R, the task count or the card -- summed in slab
# order inside a thread-block cluster.  The grid is (row blocks, splits,
# tasks).  The float32 -> float32 product (the reference's float32 sums)
# keeps the narrow routes at any C.

MV_WARPS = 8
MV_BLOCKS_PER_SM = 2
MV_STAGE_MAX = 64 * 1024    # largest X slab the staged route takes, bytes
MV_COLS = 8                 # columns of X one narrow launch computes
MV_MIN_ROWS = 16            # fewest rows a block takes (2 a warp)
MV_WIDE_COLS = 64           # columns of X one wide launch computes
MV_WIDE_WARPS = 8
MV_WIDE_ROWS = 128          # rows a block
MV_WIDE_ROW_BYTES = 128     # bytes of an A row a stage holds
MV_WIDE_MAX_SPLITS = 8      # K slabs: one cluster of at most 8 blocks
MV_WIDE_MIN_SPAN = 256      # K elements a slab takes before K splits more


@dataclasses.dataclass(frozen=True)
class MatvecPlan:
    route: str              # "staged" | "direct" | "wide"
    cc: int                 # columns this launch computes
    grid: Tuple[int, int]   # (row blocks per task, tasks); the wide
                            # route's launch grid is (grid[0], splits,
                            # grid[1])
    rows_per_block: int
    slab_bytes: int         # the staged X slab (0 when direct or wide)
    blocks_per_sm: int      # residency the grid is sized for
    threads: int
    splits: int = 1         # K slabs (the wide route's cluster size)
    k_span: int = 0         # K elements a slab (the wide route)
    x_copy: bool = False    # the direct route reads a [cc][K] copy of X

    @property
    def route_code(self) -> int:
        return 0 if self.route == "staged" else 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.splits


def _wide_slabs(esz: int, K: int) -> Tuple[int, int]:
    """(splits, k_span) of the wide route: slabs of at least
    MV_WIDE_MIN_SPAN elements, at most MV_WIDE_MAX_SPLITS of them, each a
    whole number of stage rows, none empty -- from K and the element size
    alone."""
    bk = MV_WIDE_ROW_BYTES // esz
    splits = min(MV_WIDE_MAX_SPLITS, max(1, _cdiv(K, MV_WIDE_MIN_SPAN)))
    k_span = max(bk, _cdiv(_cdiv(max(K, 1), splits), bk) * bk)
    return max(1, _cdiv(K, k_span)), k_span


@functools.lru_cache(maxsize=256)
def matvec_plan(esz: int, R: int, K: int, C: int, batch: int = 1,
                sms: int = 132, out_esz: int = None,
                c0: int = 0) -> MatvecPlan:
    """The launch computing the columns from ``c0`` of ``batch`` products
    (R x K) @ (K x C) with ``esz``-byte inputs (4 or 8) summed and written
    in ``out_esz``-byte floats (default ``esz``) on a card of ``sms``
    multiprocessors: the wide route for C > 8 columns with a float64 sum
    (``min(C - c0, 64)`` columns), else a narrow one (``min(C - c0, 8)``);
    the next launch starts at ``c0 + cc``."""
    out_esz = esz if out_esz is None else out_esz
    if esz not in (4, 8) or out_esz not in (4, 8) or out_esz < esz:
        raise ValueError(f"matvec_plan: element sizes {esz} -> {out_esz}, "
                         f"expected 4 -> 4, 4 -> 8 or 8 -> 8")
    if min(R, C, batch) <= 0 or K < 0 or K % (16 // esz) \
            or not 0 <= c0 < C:
        raise ValueError(f"matvec_plan: bad shape batch={batch} R={R} K={K} "
                         f"C={C} c0={c0} (K a multiple of {16 // esz})")
    if C > MV_COLS and out_esz == 8:
        if batch > 65535:
            raise ValueError(f"matvec_plan: {batch} tasks, at most 65535 "
                             f"for the wide route's grid")
        splits, k_span = _wide_slabs(esz, K)
        return MatvecPlan("wide", min(C - c0, MV_WIDE_COLS),
                          (_cdiv(R, MV_WIDE_ROWS), batch), MV_WIDE_ROWS, 0,
                          MV_BLOCKS_PER_SM, 32 * MV_WIDE_WARPS, splits,
                          k_span)
    cc = min(C - c0, MV_COLS)
    slab = cc * K * esz
    staged = slab <= MV_STAGE_MAX
    slots = MV_BLOCKS_PER_SM * sms
    per_task = max(1, min(slots // batch, _cdiv(R, MV_MIN_ROWS)))
    rows = _cdiv(R, per_task)
    per_task = _cdiv(R, rows)               # no block without rows
    # X in place where a lane's rows of the chunk are whole 16-byte vectors
    # and span at most 64 bytes (cc <= 4): at 8 float32 columns the rows'
    # loads touch 4x the L1 lines of the copy's and took twice its time
    vec = 16 // esz
    in_place = C == 1 or (cc <= 4 and C % vec == 0 and c0 % vec == 0
                          and cc % vec == 0)
    return MatvecPlan("staged" if staged else "direct", cc, (per_task, batch),
                      rows, slab if staged else 0, MV_BLOCKS_PER_SM,
                      32 * MV_WARPS, x_copy=not (staged or in_place))


@functools.lru_cache(maxsize=256)
def matvec_launches(esz: int, R: int, K: int, C: int, batch: int = 1,
                    sms: int = 132, out_esz: int = None) -> tuple:
    """Every launch of one product, in order: ``((c0, plan), ...)`` whose
    column chunks cover ``0 .. C - 1`` once."""
    out, c0 = [], 0
    while c0 < C:
        p = matvec_plan(esz, R, K, C, batch, sms, out_esz, c0)
        out.append((c0, p))
        c0 += p.cc
    return tuple(out)


# -- parity_contract (csrc/mds_encode.cu) ------------------------------------
#
# "narrow" (at most CT_COLS columns of Z, or float32): blocks of CT_ROWS
# rows whose threads stride over the m columns, one launch per CT_COLS
# columns (the narrow kernel takes Z and Y whole, so a chunk of a wider Z
# is a copy).  "wide" (more than CT_COLS float64 columns): up to
# CT_WIDE_COLS columns a launch, each R entry derived once a launch into a
# CT_WIDE_ROWS x CT_WIDE_BK tile and contracted on the FP64 tensor cores;
# the m columns in ``splits`` slabs of ``m_span`` -- a function of m
# alone, never of n, C or the card -- summed in slab order inside a
# thread-block cluster.  The grid is (row blocks, splits).

CT_COLS = 8
CT_ROWS = 8
CT_WIDE_COLS = 64
CT_WIDE_ROWS = 32
CT_WIDE_BK = 64             # columns of R a stage
CT_WIDE_MAX_SPLITS = 8      # column slabs: one cluster of at most 8 blocks
CT_WIDE_MIN_SPAN = 128      # columns a slab takes before m splits more


@dataclasses.dataclass(frozen=True)
class ContractPlan:
    route: str              # "narrow" | "wide"
    cc: int                 # columns of Z this launch computes
    grid: Tuple[int, int]   # (row blocks, splits)
    splits: int = 1         # column slabs (the wide route's cluster size)
    m_span: int = 0         # columns a slab (the wide route)


def _contract_slabs(m: int) -> Tuple[int, int]:
    """(splits, m_span) of the wide contraction: slabs of at least
    CT_WIDE_MIN_SPAN columns, at most CT_WIDE_MAX_SPLITS of them, each a
    whole number of stages, none empty -- from m alone."""
    splits = min(CT_WIDE_MAX_SPLITS, max(1, _cdiv(m, CT_WIDE_MIN_SPAN)))
    span = max(CT_WIDE_BK,
               _cdiv(_cdiv(max(m, 1), splits), CT_WIDE_BK) * CT_WIDE_BK)
    return max(1, _cdiv(m, span)), span


@functools.lru_cache(maxsize=256)
def contract_plan(n: int, m: int, C: int, c0: int = 0,
                  route: Optional[str] = None) -> ContractPlan:
    """The launch computing the columns from ``c0`` of ``R[n rows, m
    columns] @ Z (m, C)``: ``route`` "wide" or "narrow", or None for the
    wide route exactly when C > CT_COLS (a float64 Z: a float32 one takes
    "narrow"); the next launch starts at ``c0 + cc``."""
    if min(n, C) <= 0 or m < 0 or not 0 <= c0 < C:
        raise ValueError(f"contract_plan: bad shape n={n} m={m} C={C} "
                         f"c0={c0}")
    if route not in (None, "narrow", "wide"):
        raise ValueError(f"contract_plan: unknown route {route!r}")
    if route == "wide" or (route is None and C > CT_COLS):
        splits, span = _contract_slabs(m)
        return ContractPlan("wide", min(C - c0, CT_WIDE_COLS),
                            (_cdiv(n, CT_WIDE_ROWS), splits), splits, span)
    return ContractPlan("narrow", min(C - c0, CT_COLS),
                        (_cdiv(n, CT_ROWS), 1))


@functools.lru_cache(maxsize=256)
def contract_launches(n: int, m: int, C: int,
                      route: Optional[str] = None) -> tuple:
    """Every launch of one contraction, in order: ``((c0, plan), ...)``
    whose column chunks cover ``0 .. C - 1`` once."""
    out, c0 = [], 0
    while c0 < C:
        p = contract_plan(n, m, C, c0, route)
        out.append((c0, p))
        c0 += p.cc
    return tuple(out)


# -- wkv6 (csrc/wkv6.cu) ----------------------------------------------------
#
# "decode" (T <= 1): a block streams one row's state, up to WKV_DEC_COLS
# columns, WKV_DEC_THREADS threads, ``vec`` columns a thread (16-byte rows
# when V is a multiple of 4 and the state is 16-byte aligned).  "chunked"
# (T > 1): a block of 8 producer and 8 consumer warps per (row, WKV_VB
# state columns) walks time in chunks of WKV_CHUNK steps, the producers one
# chunk ahead; pairs of steps in different sub-chunks of WKV_SUB steps
# factor through a reference step between them (levels 8 and 4, on the
# tensor cores), the pairs inside one are FMA terms of the prep.  The head
# size is padded to ``kk`` = 64 or 128 (the compiled sizes), which sets
# the block's shared memory; one block an SM.

WKV_CHUNK = 16
WKV_SUB = 4
WKV_VB = 32
WKV_THREADS = 512
WKV_DEC_THREADS = 256
WKV_DEC_COLS = 256
WKV_DEC_BLOCKS_PER_SM = 4
WKV_K_MAX = 128


@dataclasses.dataclass(frozen=True)
class Wkv6Plan:
    route: str              # "decode" | "chunked"
    chunk: int              # steps a chunk (1 for decode)
    sub: int                # steps a sub-chunk (1 for decode)
    kk: int                 # head size the kernel is compiled for
    vb: int                 # state columns a block
    vec: int                # state columns a decode thread (1 for chunked)
    grid: Tuple[int, int]   # (column blocks, rows B * H)
    threads: int
    smem_bytes: int
    blocks_per_sm: int      # residency the grid is sized for

    @property
    def route_code(self) -> int:
        return 0 if self.route == "decode" else 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _wkv6_chunked_smem(kk: int) -> int:
    """Bytes of the chunked block's shared tiles (csrc/wkv6.cu): two chunk
    buffers (six [kk] x [chunk + 8] operand tiles, v, Aᵀ, the bonus, the
    chunk's decays and the producer warps' FMA partial sums) and two copies
    of the state slice."""
    c = WKV_CHUNK
    cbuf = (6 * kk * (c + 8) + c * (WKV_VB + 4) + c * (c + 4) + c + kk
            + 8 * WKV_SUB * (6 + WKV_SUB))
    return 4 * (2 * cbuf + 2 * kk * (WKV_VB + 8))


@functools.lru_cache(maxsize=256)
def wkv6_plan(T: int, K: int, V: int, BH: int, vec: int = 4) -> Wkv6Plan:
    """The launch of WKV6 over ``BH`` rows of ``T`` steps, head size K,
    V state columns.  ``vec`` is the widest state access the caller's
    layout allows a decode thread (4 when V is a multiple of 4 and the
    state 16-byte aligned, else 1).  One plan serves both input types:
    float32 inputs take the same route with their products split three
    ways."""
    if K <= 0 or K % 8 or K > WKV_K_MAX or BH <= 0 or BH > 65535 or V <= 0 \
            or T < 0:
        raise ValueError(f"wkv6_plan: bad shape T={T} K={K} V={V} BH={BH} "
                         f"(K a multiple of 8 up to {WKV_K_MAX}, BH at most "
                         f"65535)")
    if T <= 1:
        vec = 4 if vec == 4 and V % 4 == 0 else 1
        cols = min(_cdiv(V, vec) * vec, WKV_DEC_COLS if vec == 4 else 64)
        while WKV_DEC_THREADS % (cols // vec):
            cols -= vec
        groups = WKV_DEC_THREADS // (cols // vec)
        return Wkv6Plan("decode", 1, 1, K, cols, vec, (_cdiv(V, cols), BH),
                        WKV_DEC_THREADS, 4 * (4 * K + cols + groups * cols),
                        WKV_DEC_BLOCKS_PER_SM)
    kk = 64 if K <= 64 else 128
    return Wkv6Plan("chunked", WKV_CHUNK, WKV_SUB, kk, WKV_VB, 1,
                    (_cdiv(V, WKV_VB), BH), WKV_THREADS,
                    _wkv6_chunked_smem(kk), 1)


def wkv6_ops(T: int, K: int, V: int, BH: int, esz: int) -> Tuple[float, str]:
    """(operations, pipe) of one WKV call on the route :func:`wkv6_plan`
    gives T: the least work the kernel does, which its bound
    (``chip_smoke.py::_wkv6_bound``) and its FLOP formula (the dry-run's
    count) both read.  The decode step (T <= 1) runs about 6 K V float32
    operations per (bh, t) outside the tensor cores ("fp32").  The chunked
    route (T > 1) runs its two K x V products a step, the carry-in (r ⊙ F)
    S and the state update (k ⊙ G)ᵀ v, 2 K V operations each, on the TF32
    tensor cores ("tf32"), once for each product its precision route takes:
    the state update two for bf16 inputs (``esz`` 2: v exact, the float32
    factor split) and three for float32, the output products one for bf16
    and three for float32.  The chunk's strict-causal products and the
    FMA-pipe work are left out."""
    if T <= 1:
        return 6.0 * BH * T * K * V, "fp32"
    products = 2 + 1 if esz == 2 else 3 + 3
    return 2.0 * products * BH * T * K * V, "tf32"

# -- wkv6 backward (csrc/wkv6_bwd.cu) -----------------------------------------
#
# Two launches.  Level 1 steps the state S forward and the cotangent state
# D backward through chunks of WKV_BWD_CHUNK steps on the tensor cores and
# writes them at every chunk boundary (S at a chunk's start, D at its end)
# to a float32 scratch: one block of 4 kk threads per (row, direction).
# Level 2 runs every chunk of every row at once, one block of 512 threads
# per (chunk, row), the state padded to kk x vv (64 or 128 each).

WKV_BWD_CHUNK = 16
WKV_BWD_V_MAX = 128
WKV_BWD_THREADS = 512       # a level-2 block


@dataclasses.dataclass(frozen=True)
class Wkv6BwdPlan:
    kk: int                 # head size the kernels are compiled for
    vv: int                 # state columns the kernels are compiled for
    chunk: int              # steps a chunk (both levels)
    sub: int                # steps of S a level-2 thread keeps
    n_chunks: int           # chunks a row
    states_grid: Tuple[int, int]        # level 1: (rows B * H, 2)
    states_threads: int
    states_smem: int
    grid: Tuple[int, int]   # level 2: (chunks, rows B * H)
    threads: int
    smem_bytes: int         # level 2's
    blocks_per_sm: int      # level 2's residency the grid is sized for
    scratch_bytes: int      # S_c and D_{c+1}: (2, BH, n_chunks, kk, vv) f32

    @property
    def launches(self) -> int:
        """CUDA launches a call: level 2 has nothing to do without steps."""
        return 2 if self.n_chunks else 1


def _wkv6_bwd_states_smem(kk: int, vv: int) -> int:
    """Bytes of a level-1 block's two chunk buffers: the (x ⊙ factor)
    tile [kk][chunk + 4], the v or do tile [chunk][vv + 8], the chunk's
    decay products [kk]."""
    c = WKV_BWD_CHUNK
    return 4 * 2 * (kk * (c + 4) + c * (vv + 8) + kk)


def _wkv6_bwd_sub(kk: int, vv: int) -> int:
    """Steps of S a level-2 thread keeps in registers: 32 floats of
    history over its kk vv / 512 entries."""
    return 32 * WKV_BWD_THREADS // (kk * vv)


def _wkv6_bwd_chunk_smem(kk: int, vv: int) -> int:
    """Bytes of a level-2 block's shared arrays (rows padded by 4 floats):
    r, k, w, the decay products F and G, the products X and Y [chunk][kk];
    v, do and Z [chunk][vv]; B and A [chunk][chunk + 1]; two dot products a
    step and u; then one region that holds S_c and D_e for the tensor cores,
    and
    after them S every ``sub`` steps (at 64 x 64 only) and the walk's
    partial sums of dw by four column blocks [chunk][4][kk]."""
    c = WKV_BWD_CHUNK
    sub = _wkv6_bwd_sub(kk, vv)
    nck = c // sub - 1 if kk * vv == 4096 else 0
    fixed = (7 * c * (kk + 4) + 3 * c * (vv + 4) + 2 * c * (c + 1) + 2 * c
             + kk)
    region = max(2 * kk * (vv + 4), nck * kk * vv + c * 4 * kk)
    return 4 * (fixed + region)


@functools.lru_cache(maxsize=256)
def wkv6_bwd_plan(T: int, K: int, V: int, BH: int) -> Wkv6BwdPlan:
    """The launches of the WKV6 backward over ``BH`` rows of ``T`` steps,
    head size K, V state columns (both input types)."""
    if K <= 0 or K % 8 or K > WKV_K_MAX or V <= 0 or V > WKV_BWD_V_MAX \
            or BH <= 0 or BH > 65535 or T < 0:
        raise ValueError(f"wkv6_bwd_plan: bad shape T={T} K={K} V={V} "
                         f"BH={BH} (K a multiple of 8 up to {WKV_K_MAX}, V "
                         f"up to {WKV_BWD_V_MAX}, BH at most 65535)")
    kk = 64 if K <= 64 else 128
    vv = 64 if V <= 64 else 128
    c = WKV_BWD_CHUNK
    nc = _cdiv(T, c)
    return Wkv6BwdPlan(kk, vv, c, _wkv6_bwd_sub(kk, vv), nc, (BH, 2),
                       4 * kk, _wkv6_bwd_states_smem(kk, vv), (nc, BH),
                       WKV_BWD_THREADS, _wkv6_bwd_chunk_smem(kk, vv),
                       2 if kk * vv <= 4096 else 1,
                       4 * 2 * BH * nc * kk * vv)


def wkv6_bwd_ops(T: int, K: int, V: int, BH: int, esz: int,
                 chunk: int) -> Dict[str, float]:
    """Operations of one WKV backward call on its two-level route by pipe
    (the tensor cores' "tf32", the FMA pipe's "fp32"), per (bh, t) in units
    of K V (read by ``chip_smoke.py::_wkv6_bwd_bound`` and the FLOP
    formula):

    * on the TF32 tensor cores, 2 operations a product term, once for each
      product its precision route takes (a float32 factor split into head
      + tail takes 2 against an exact bf16 operand, 3 against a float32
      one; two bf16 operands 1): level 1's state updates of S and D, 2 K V
      each, 2 / 3 products (bf16 / f32); level 2's X = S_c dOᵀ and Y = D_e
      Vᵀ, 2 K V each, 2 / 3; Z = (K ⊙ G) D_e, 2 K V, 3 (both float32); B =
      dO Vᵀ, 2 chunk V, 1 / 3; dv's (A + diag)ᵀ dO, 2 chunk V, 2 / 3;
    * on the FMA pipe at the FP32 rate, the direct dw walk: S stepped
      forward, D stepped backward and Σ_v S ⊙ D, 2 K V each.

    The in-chunk pairs, the decay products and the states' scaling are
    left out."""
    split, exact = (3, 3) if esz == 4 else (2, 1)
    tc = (2 * 2 * split + 2 * 2 * split + 2 * 3
          + 2 * chunk / K * exact + 2 * chunk / K * split)
    steps = BH * T * K * V
    return {"tf32": tc * steps, "fp32": 6 * steps}

# -- attention (csrc/attention.cu, csrc/attention_bwd.cu) ---------------------
#
# A tile is ATTN_ROWS query rows of one kv head's group: ``gt`` of its G
# query heads x ``bq`` query positions, so K and V are read once for the
# group.  The forward and dQ blocks (one per tile) step through the keys
# the tile's masks leave, ``bk`` a step; a dK / dV block holds ``bn`` keys
# and steps through the tiles that see them.  Every operand tile is float32
# in shared memory, ``width`` + 4 floats a row; 256 threads, each a 4-row
# (dK / dV: bn / 16-row) strip of 16-column-strided entries.  Head sizes D
# (queries and keys) and Dv (values) are multiples of 4 up to 256, any
# pair; they run at the compiled ``width``, the smallest of ATTN_WIDTHS
# that holds both (a tile's columns past its head size are zero).  The
# rows of K, V, Q and dO are read four elements at a time.

ATTN_WIDTHS = (32, 64, 128, 192, 256)
ATTN_ROWS = 64
ATTN_THREADS = 256
#: shared memory of one SM, and the most one block can take
ATTN_SM_SMEM = 233472
ATTN_BLOCK_SMEM = 232448
#: the residency the kernels' registers are built for: the forward and dQ
#: kernels ``__launch_bounds__(256, 2)`` (at most 128 registers a thread),
#: the dK / dV kernel, whose two accumulators take twice as many, (256, 1)
ATTN_MAX_BLOCKS = 2
ATTN_DKDV_MAX_BLOCKS = 1


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    width: int              # the compiled head width (ATTN_WIDTHS)
    gt: int                 # query heads of the group a tile
    bq: int                 # query positions a tile (gt * bq <= ATTN_ROWS)
    bk: int                 # keys a step of the forward and dQ blocks
    bn: int                 # keys a dK / dV block
    threads: int
    smem_bytes: int         # the forward block's
    dq_smem: int
    dkdv_smem: int
    blocks_per_sm: int      # the forward's residency
    dq_blocks_per_sm: int
    dkdv_blocks_per_sm: int

    def grid(self, B: int, Tq: int, Hkv: int, G: int) -> Tuple[int, int, int]:
        """The forward's and dQ's grid: (query tiles, kv heads x head
        chunks, batch)."""
        return (_cdiv(Tq, self.bq), Hkv * _cdiv(G, self.gt), B)

    def dkdv_grid(self, B: int, Tk: int, Hkv: int) -> Tuple[int, int, int]:
        return (_cdiv(Tk, self.bn), Hkv, B)


def _attn_resident(smem: int, cap: int = ATTN_MAX_BLOCKS) -> int:
    """Blocks an SM holds: its shared memory (1 KB reserved a block) and
    the kernel's registers (``cap``)."""
    return min(cap, ATTN_SM_SMEM // (smem + 1024))


@functools.lru_cache(maxsize=256)
def attention_plan(D: int, Dv: int, G: int, esz: int = 2) -> AttentionPlan:
    """The attention kernels' launch plan for head sizes D (queries, keys)
    and Dv (values), G query heads a kv head, inputs of ``esz`` bytes
    (float32 4, bfloat16 2: every tile is float32 in shared memory, so the
    type sets no tile)."""
    if not all(0 < d <= ATTN_WIDTHS[-1] and d % 4 == 0 for d in (D, Dv)) \
            or G < 1 or esz not in (2, 4):
        raise ValueError(f"attention_plan: head sizes D={D} Dv={Dv} must be "
                         f"multiples of 4 up to {ATTN_WIDTHS[-1]}, G={G} at "
                         f"least 1, esz={esz} 2 or 4")
    w = next(x for x in ATTN_WIDTHS if x >= max(D, Dv))
    gt = min(G, ATTN_ROWS)
    bq = ATTN_ROWS // gt
    bk = 64 if w <= 64 else 32
    bn = 64 if w <= 128 else 32
    r, ld = ATTN_ROWS, w + 4
    fwd = 4 * (r * ld + 2 * bk * ld + r * (bk + 4))
    dq = 4 * (2 * r * ld + 2 * bk * ld + r * (bk + 4) + 2 * r)
    dkdv = 4 * (2 * bn * ld + 2 * r * ld + 2 * bn * (r + 4) + 2 * r)
    return AttentionPlan(w, gt, bq, bk, bn, ATTN_THREADS, fwd, dq, dkdv,
                         _attn_resident(fwd), _attn_resident(dq),
                         _attn_resident(dkdv, ATTN_DKDV_MAX_BLOCKS))


# -- attention on the tensor cores (csrc/attention_mma.cu) --------------------
#
# The bf16 forward's route: a tile is ``rows`` query rows, 64 a consumer
# warpgroup, ``gt`` of a kv head's G query heads x ``bq`` positions,
# position-major; a producer warpgroup brings K and V into a ring of
# ``stages`` with TMA, ``bk`` keys a stage.  Head sizes run in 64-column
# chunks, ``dc`` of D and ``vc`` of Dv: MLA's 192 / 128 as (3, 2), every
# other pair at the square of the larger (its extra columns zero).  Up to
# 64 columns (llama3.2-1b's 64) a block has three consumer warpgroups and
# 96-key stages (a thread's 160 registers hold S, P's two parts and O);
# wider heads two, and 128-key stages up to 128 columns, else 64.  The attention
# backward stays on :func:`attention_plan`.

#: shared bytes the ring may fill (Q, the stages, 1 KB for alignment)
ATTN_MMA_SMEM_BUDGET = 204800
ATTN_MMA_MAX_STAGES = 4
#: the producers keep this many registers a thread; ``setmaxnreg`` hands
#: the rest of their share to the consumers
ATTN_MMA_PRODUCER_REGS = 24


@dataclasses.dataclass(frozen=True)
class AttentionMmaPlan:
    dc: int                 # 64-column chunks of D (queries, keys)
    vc: int                 # 64-column chunks of Dv (values)
    rows: int               # query rows a tile: 64 a consumer warpgroup
    gt: int                 # query heads of the group a tile
    bq: int                 # query positions a tile (gt * bq <= rows)
    bk: int                 # keys a stage
    stages: int             # stages of the K / V ring
    threads: int            # the consumers and a producer warpgroup
    smem_bytes: int
    regs: int               # registers a thread at launch (ptxas's grant)
    consumer_regs: int      # a consumer's after ``setmaxnreg``
    blocks_per_sm: int

    def blocks(self, B: int, Tq: int, Hkv: int, G: int) -> int:
        """The launch's one-dimensional grid: query tiles x kv heads x head
        chunks x batch rows."""
        return _cdiv(Tq, self.bq) * Hkv * _cdiv(G, self.gt) * B


def attention_mma_plan(D: int, Dv: int, G: int,
                       esz: int = 2) -> AttentionMmaPlan:
    """The tensor-core forward's launch plan for bf16 (``esz`` 2) head sizes
    D and Dv, multiples of 16 up to 256 with the larger above 32, and G
    query heads a kv head.  Raises ValueError for what the kernel does not
    take (float32, width 32, a head size not a multiple of 16): those calls
    run on :func:`attention_plan`'s SIMT kernel."""
    if esz != 2 or G < 1 or not all(16 <= d <= 256 and d % 16 == 0
                                    for d in (D, Dv)) or max(D, Dv) <= 32:
        raise ValueError(f"attention_mma_plan: bf16 head sizes D={D} Dv={Dv} "
                         f"must be multiples of 16 up to 256, the larger "
                         f"above 32, G={G} at least 1, esz={esz} 2")
    dc, vc = _cdiv(D, 64), _cdiv(Dv, 64)
    if (dc, vc) != (3, 2):
        dc = vc = max(dc, vc)
    nwg = 3 if dc == 1 else 2
    bk = {1: 96, 2: 128}.get(dc, 64)
    rows, threads = 64 * nwg, 128 * (nwg + 1)
    q_bytes = dc * rows * 128
    stage = (dc + vc) * bk * 128
    stages = min(ATTN_MMA_MAX_STAGES,
                 (ATTN_MMA_SMEM_BUDGET - 1024 - q_bytes) // stage)
    smem = 1024 + q_bytes + stages * stage
    regs = 65536 // threads // 8 * 8
    consumer = ((regs * threads - 128 * ATTN_MMA_PRODUCER_REGS)
                // (128 * nwg) // 8 * 8)
    gt = min(G, rows)
    resident = min(ATTN_SM_SMEM // (smem + 1024), 65536 // (threads * regs))
    return AttentionMmaPlan(dc, vc, rows, gt, rows // gt, bk, stages,
                            threads, smem, regs, consumer, resident)


def _visible(Tq: int, Tk: int, causal: bool, window: Optional[int],
             q_offset: int, kv: int):
    """(first, end) visible key of every query row, numpy int64 arrays."""
    import numpy as np
    p = q_offset + np.arange(Tq, dtype=np.int64)
    end = np.full(Tq, min(Tk, kv), dtype=np.int64)
    if causal:
        end = np.minimum(end, p + 1)
    first = np.zeros(Tq, dtype=np.int64)
    if window is not None:
        first = np.maximum(first, p - window + 1)
    return first, end


def attention_masked_pairs(Tq: int, Tk: int, causal: bool,
                           window: Optional[int] = None, q_offset: int = 0,
                           kv_valid=None) -> int:
    """The (query, key) pairs a batch row's masks leave, summed over the
    batch when ``kv_valid`` is a sequence (one count a row), else for one
    row: the exact work, which the card's bound reads."""
    import numpy as np
    kvs = [Tk] if kv_valid is None else list(np.atleast_1d(kv_valid))
    total = 0
    for kv in kvs:
        first, end = _visible(Tq, Tk, causal, window, q_offset, int(kv))
        total += int(np.maximum(end - first, 0).sum())
    return total


def attention_block_range(i: int, bq: int, bk: int, nk: int, causal: bool,
                          window: Optional[int], q_offset: int
                          ) -> Tuple[int, int]:
    """The reference's static key-block range of query block i (blocks of
    bq queries and bk keys, nk key blocks): (j_lo, steps), its scan over
    ``j_lo .. j_lo + steps``."""
    j_hi = min(nk, (q_offset + (i + 1) * bq + bk - 1) // bk) if causal \
        else nk
    j_lo = max(0, (q_offset + i * bq - window) // bk) \
        if window is not None else 0
    return j_lo, max(j_hi - j_lo, 1)


def attention_pairs(Tq: int, Tk: int, causal: bool,
                    window: Optional[int] = None, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 512) -> int:
    """The (query, key) pairs the reference's blockwise ``flash_attention``
    visits for one batch row and head: each query block's whole key blocks
    over its static range ``j_lo .. j_lo + max(j_hi - j_lo, 1)``, as its
    compiled FLOPs count them."""
    if Tq == 0 or Tk == 0:
        return 0
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    nk = _cdiv(Tk, bk)
    return bq * bk * sum(
        attention_block_range(i, bq, bk, nk, causal, window, q_offset)[1]
        for i in range(_cdiv(Tq, bq)))


def attention_flops(B: int, Tq: int, Tk: int, Hq: int, D: int, Dv: int,
                    causal: bool, window: Optional[int], q_offset: int,
                    block_q: int, block_k: int, backward: bool = False
                    ) -> int:
    """FLOPs of the attention over the pairs the reference's block range
    visits (:func:`attention_pairs`): the forward's two products, 2 (D +
    Dv) a pair, and the backward's four (dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K,
    dK = dSᵀ Q), 2 (2 D + 2 Dv) a pair, as the reference's autodiff runs
    them.  The FLOP formulas of the ``attention`` operators read this."""
    pairs = B * Hq * attention_pairs(Tq, Tk, causal, window, q_offset,
                                     block_q, block_k)
    return 2 * pairs * ((2 * D + 2 * Dv) if backward else (D + Dv))
