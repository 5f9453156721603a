// Skinny coded product Y_b = A_b @ X_b for Hopper (sm_90a).
//
// Replaces repro/kernels/coded_matvec.py::coded_matvec_pallas
// (_matvec_kernel): the 128x128-block matvec with the B columns kept whole
// that runs a serving step's packed shard tiles in one launch
// (repro/kernels/ops.py:303), the W @ X half of the generated-parity
// product, and -- with the task axis -- the per-task coded products of the
// static executor and the streaming verify (ops.coded_matvec_batch, the
// reference's vmap of the Pallas call).
//
// Types: the input type TI (float or double) and the accumulator/output
// type TA.  Products that feed an MDS decode take float in and double out:
// a float x float product is exact in double and the sum keeps 53 bits,
// so the decode no longer amplifies float32 rounding.  float -> float is
// the reference's numerics; double -> double is the executor's.
//
// What bounds it on this card: A is (R, K) and X is (K, C) with C a step
// batch (<= a few slots), so the kernel does 2*C FLOP per element of A --
// far below the ridge.  It is bound by reading A from HBM once: the
// executor's 4 x (2e4 x 1e4) float64 tasks are 6.4 GB, 1.91 ms at
// 3.35 TB/s; the llama3.2-1b head (R ~ 128512, K = 2048, float) ~1.05 GB,
// ~0.31 ms.  The wider accumulator adds no bytes.
//
// Design, for what limits a stream of A on this card:
//  * Bytes in flight.  A warp reduces RPW = 2 rows at once; each lane
//    issues U trips of RPW 16-byte read-only loads of A (U = 8 for one or
//    two columns, 256 B a lane; 4 for up to four, 128 B; 2 beyond) before
//    the FMAs that consume them.  Two blocks of 8 warps an SM (the launch
//    bounds hold the registers to that residency) keep 32-128 KB of A in
//    flight an SM.  (PERF.md records the other RPW, U, load hints and
//    residencies that were timed against these.)
//  * Residency.  Two routes, chosen by kernels/plan.py's matvec_plan from
//    the size of one launch's X: "staged" copies X[:, c0:c0+cc] whole into
//    shared memory, transposed to [c][k] so that each lane's 16-byte read
//    is conflict-free and serves RPW rows (the serving tiles: a 32 KB
//    slab); "direct", for a long K (the executor and the verify: 80 KB a
//    task at K = 1e4 doubles; the coded heads and the trunk's down past K
//    4096 at C = 4: 114-128 KB), reads X through L1/L2 and uses no shared
//    memory, so registers alone bound the residency and L1 takes the
//    whole carveout.
//  * X on the direct route, 16-byte vectors a lane.  A lane needs, for its
//    vector q of A, the NV elements k = q NV .. q NV + NV - 1 of each of
//    the launch's columns.  C = 1: X's vector q itself (XV).  Where a row
//    of the launch's columns is a whole number of 16-byte vectors (C, c0
//    and cc multiples of the vector, X aligned) and the lane's rows span
//    at most 64 bytes (cc <= 4), the lane loads its NV rows whole (XROWS:
//    C = 4 float32, C = 2 or 4 float64).  Elsewhere -- and at 8 float32
//    columns, where the rows' loads touch 4x the L1 lines and took twice
//    the time -- the launch first copies X[:, c0:c0+cc] of
//    every task into a [cc][K] scratch -- the staged route's layout, in
//    global memory -- and a lane's 16-byte load of column c's vector q
//    sits beside its neighbours' (XCOPY; a second, tiny kernel of the same
//    launch).  The parent read X element by element, 64 bytes apart
//    across a warp at C = 4 float32 (XELEM, still run by route 2 to time
//    the two on the same inputs): ~16 L1 lines an instruction, which held
//    the DeepSeek head to ~1 TB/s.
//  * Balance.  The grid is (blocks per task, tasks), a whole wave of
//    resident blocks where the rows allow; block x of a task owns the
//    contiguous rows [x * rows_per_block, (x + 1) * rows_per_block), so
//    every block does the same work to within a row and no block is left
//    with a partial round; its warps take the range's groups of RPW rows
//    in turn.
//  * Determinism.  Lane l sums the 16-byte vectors q = l, l + 32, ... of a
//    row in increasing order, each vector's elements in order, and the
//    lanes are combined by a fixed butterfly: a row's sum has one order
//    whatever the plan or the way X is read (every X path is bit-equal to
//    the others), and repeated calls are bit-equal (no atomics).
// float -> float with C > 8 is split into 8-column chunks by the host, one
// launch each (the reference's float32 sums); the C entry point checks the
// plan and the residency it assumes.
//
// The wide route (C > 8 columns, double out: the trunk stages' prefill at
// C = 32, the W @ X half of the generated-parity product at a prefill).
// There the product is a skinny GEMM: at C = 32 a float32 element of A
// feeds 64 FLOP, so A's bytes (down: 2048 x 8192 floats, 67 MB, 20 us at
// 3.35 TB/s) and the FP64 tensor cores (1.07 GFLOP, 16 us at 67 TFLOP/s)
// bound it about equally, and a SIMT loop over 8-column chunks reads A
// four times.  Design:
//  * One launch computes up to 64 columns (plan.MV_WIDE_COLS; the host
//    splits wider C into chunks of 64): A is read once a chunk.
//  * Products on the FP64 tensor cores, mma.sync m16n8k8: a block of 8
//    warps owns 128 rows, each warp one m16 tile against every n8 tile
//    of the chunk (NT = 2, 4 or 8 compiled; the tiles past the chunk's
//    columns are skipped).  A float32 element is widened once, in
//    registers, when its fragment is read; a float x float product is
//    exact in double, so the numerics are the narrow route's: exact
//    products, double sums.
//  * A 4-stage cp.async ring of 128-byte rows of A (32 floats or 16
//    doubles a row; 16-byte copies that have L2 fetch 256 bytes) and the
//    matching rows of X (16-byte copies where C allows: element copies
//    cost down 10 us).  Each stage's X is widened once into a double tile
//    [k][c] that every warp of the block reads: X is staged once a block
//    and stage, never re-read per row pair.  A's 16-byte chunks are
//    swapped on odd rows so that a fragment's reads are free of bank
//    conflicts; the widened X rows are padded by one double for its
//    8-byte reads.  Two blocks an SM (112 KB of shared memory at 64
//    columns).
//  * K is split into at most 8 slabs of a length that is a function of K
//    and the element size alone (plan.matvec_plan): the blocks of one row
//    range form a thread-block cluster along the slabs, each writes its
//    128 x 8NT partial tile to its shared memory, and block z of the
//    cluster sums the tile's rows [128 z, 128 (z + 1)) / splits over the
//    cluster's shared memory (DSMEM) in slab order 0, 1, ... .  No atomics
//    and no workspace: a row's sum has one order whatever R, the task
//    count or the card, so a row computed among 2048 is the row computed
//    alone and repeated calls are bit-equal.  At R = 2048 the grid is 16
//    row blocks x 8 slabs.
// What bounds it as built (PERF.md, row 2t): a warp spends ~1240 clocks a
// stage on its 16 mmas and ~930 on the stage's wait, copies and X widening
// between the two block barriers; the card fits 30 clusters of 8 at two
// blocks an SM but only 15 at one, so a 16-cluster grid packs two blocks
// onto some SMs and the cluster waits for them (without clusters the same
// work took 41 us at down, against 53).  Measured slower: a producer
// warpgroup feeding the mma warps through mbarriers (one block an SM), a
// ring of 8 stages at one block an SM, two m16 tiles a warp with two k
// groups, two accumulator sets a warp, and 64-row blocks (better at o and
// down, worse at q/k/v and up/gate).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace {

// plan.MV_WARPS, plan.MV_BLOCKS_PER_SM, rows a warp reduces at once
constexpr int WARPS = 8, THREADS = WARPS * 32, MINB = 2, RPW = 2;
// plan.MV_STAGE_MAX: the largest X slab the staged route takes
constexpr int STAGE_MAX = 64 * 1024;

// How a launch of the narrow routes reads X (see above)
enum XMode { STAGED, XV, XROWS, XCOPY, XELEM };

// 16-byte trips of RPW loads a lane issues before its FMAs; half as many
// where X is read element by element (XELEM), whose registers spill at the
// full depth
template <int CC, bool XG>
__host__ __device__ constexpr int trips() {
  return (CC <= 2 ? 8 : CC <= 4 ? 4 : 2) / (XG ? 2 : 1);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// element e of a 16-byte vector (e is a compile-time constant after
// unrolling, so these fold to register moves)
__device__ __forceinline__ float vget(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double vget(const double2& v, int e) {
  return e == 0 ? v.x : v.y;
}
__device__ __forceinline__ void vset(float4& v, int e, float x) {
  if (e == 0) v.x = x; else if (e == 1) v.y = x; else if (e == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void vset(double2& v, int e, double x) {
  if (e == 0) v.x = x; else v.y = x;
}

// A is read once: read-only loads that allocate no L1 line and have L2
// fetch 256 bytes at a time (the lanes of a warp read 512 contiguous
// bytes of a row, and the next trip the 512 after them)
__device__ __forceinline__ float4 load_a(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ double2 load_a(const double2* p) {
  double2 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.f64 {%0, %1}, [%2];"
      : "=d"(v.x), "=d"(v.y) : "l"(p));
  return v;
}

// X's columns [c0, c0 + CC) of every task as [task][CC][K] (XCOPY's
// scratch): written coalesced, read with a stride of C
template <typename TI>
__global__ void __launch_bounds__(256)
copy_columns_kernel(const TI* __restrict__ X, TI* __restrict__ XT, int B,
                    int K, int C, int c0, int cc) {
  const size_t per = (size_t)cc * K, n = per * B;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / per, r = i % per;
    XT[i] = X[(b * K + r % K) * C + c0 + r / K];
  }
}

// XM selects how X is read (XMode): STAGED, X[:, c0:c0+CC] in shared
// memory as [CC][K]; XV, C == 1 and X 16-byte aligned, X's vector q in one
// load; XROWS, a row's CC columns as CC / NV whole vectors; XCOPY, X is
// the launch's [task][CC][K] copy; XELEM, element by element.
template <typename TI, typename TA, int CC, int XM>
__global__ void __launch_bounds__(THREADS, MINB)
coded_matvec_kernel(const TI* __restrict__ A, const TI* __restrict__ X,
                    TA* __restrict__ Y, int R, int K, int C, int c0,
                    int rows_per_block) {
  using V = typename Vec16<TI>::type;
  constexpr int NV = 16 / sizeof(TI);      // elements per 16-byte load
  constexpr int U = trips<CC, XM == XELEM>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int task = blockIdx.y;
  A += (size_t)task * R * K;
  X += (size_t)task * K * (XM == XCOPY ? CC : C);
  Y += (size_t)task * R * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KV = K / NV;
  const int b_begin = blockIdx.x * rows_per_block;
  const int b_end = min(R, b_begin + rows_per_block);

  const V* xsv = reinterpret_cast<const V*>(smem);     // [CC][KV]
  if constexpr (XM == STAGED) {
    TI* xs = reinterpret_cast<TI*>(smem);
    for (int i = threadIdx.x; i < K * CC; i += THREADS) {
      const int k = i / CC, c = i % CC;
      xs[c * K + k] = X[(size_t)k * C + c0 + c];
    }
    __syncthreads();
  }
  // X's 16-byte vector q of column c (zero past K)
  auto load_x = [&](int c, int q) -> V {
    if (q >= KV) return V{};
    if constexpr (XM == STAGED) {
      return xsv[c * KV + q];
    } else if constexpr (XM == XV) {
      return __ldg(reinterpret_cast<const V*>(X) + q);
    } else if constexpr (XM == XCOPY) {
      return __ldg(reinterpret_cast<const V*>(X) + (size_t)c * KV + q);
    } else {
      V v;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        vset(v, e, __ldg(X + (size_t)(q * NV + e) * C + c0 + c));
      return v;
    }
  };

  // the block's warps take its groups of RPW rows in turn: together they
  // stream neighbouring rows, front to back
  for (int r0 = b_begin + warp * RPW; r0 < b_end; r0 += WARPS * RPW) {
    const int nr = min(RPW, b_end - r0);
    const V* arow[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      arow[r] = reinterpret_cast<const V*>(A + (size_t)(r0 + min(r, nr - 1))
                                                   * K);
    TA acc[RPW][CC];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = TA(0);
    for (int q0 = lane; q0 < KV; q0 += 32 * U) {
      V a[U][RPW];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int q = q0 + 32 * u;
          a[u][r] = (q < KV && r < nr) ? load_a(arow[r] + q) : V{};
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + 32 * u;
        if constexpr (XM == XROWS) {
          // element e of the vector, column c: the NV rows of X the
          // vector spans, each CC / NV whole 16-byte vectors
          TI xr[NV][CC];
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            const V* xrow = reinterpret_cast<const V*>(
                X + (size_t)(q * NV + e) * C + c0);
#pragma unroll
            for (int v = 0; v < CC / NV; ++v) {
              const V w = q < KV ? __ldg(xrow + v) : V{};
#pragma unroll
              for (int t = 0; t < NV; ++t) xr[e][v * NV + t] = vget(w, t);
            }
          }
#pragma unroll
          for (int c = 0; c < CC; ++c)
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int e = 0; e < NV; ++e)
                acc[r][c] = fma_t(TA(vget(a[u][r], e)), TA(xr[e][c]),
                                  acc[r][c]);
        } else {
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            const V xv = load_x(c, q);
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int e = 0; e < NV; ++e)
                acc[r][c] = fma_t(TA(vget(a[u][r], e)), TA(vget(xv, e)),
                                  acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        TA v = acc[r][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][c] = v;
      }
      if (r < nr && lane < CC) {
        TA v = TA(0);
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (c == lane) v = acc[r][c];
        Y[(size_t)(r0 + r) * C + c0 + lane] = v;
      }
    }
  }
}

template <typename TI, typename TA, int CC, int XM>
int launch(const TI* A, const TI* X, TA* Y, int B, int R, int K, int C,
           int c0, int blocks, int rows_per_block, int slab_bytes,
           int per_sm, cudaStream_t st) {
  auto kern = coded_matvec_kernel<TI, TA, CC, XM>;
  // the attribute and the residency are looked up once per instantiation
  // and slab size (host work a call, not device work)
  static int cached_slab = -1, resident = 0;
  if (slab_bytes != cached_slab) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_MAX);
    if (err == cudaSuccess && XM != STAGED)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxL1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, kern, THREADS, slab_bytes);
    if (err != cudaSuccess) return (int)err;
    cached_slab = slab_bytes;
  }
  // the plan's grid is sized for per_sm blocks an SM
  if (resident < per_sm) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(blocks, B);
  kern<<<grid, THREADS, slab_bytes, st>>>(A, X, Y, R, K, C, c0,
                                          rows_per_block);
  return (int)cudaGetLastError();
}

// XCOPY's prologue: X[:, c0:c0+cc] of every task into `xt`
template <typename TI>
int copy_columns(const TI* X, TI* xt, int B, int K, int C, int c0, int cc,
                 cudaStream_t st) {
  const long long n = (long long)B * cc * K;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  if (n > 0)
    copy_columns_kernel<TI><<<blocks, 256, 0, st>>>(X, xt, B, K, C, c0, cc);
  return (int)cudaGetLastError();
}

template <typename TI, typename TA, int CC>
int run_cc(int xm, const TI* a, const TI* x, TA* y, int B, int R, int K,
           int C, int c0, int blocks, int rows_per_block, int slab_bytes,
           int per_sm, cudaStream_t st) {
#define REPRO_MV(XM)                                                       \
  return launch<TI, TA, CC, XM>(a, x, y, B, R, K, C, c0, blocks,           \
                                rows_per_block, slab_bytes, per_sm, st)
  switch (xm) {
    case STAGED: REPRO_MV(STAGED);
    case XCOPY: REPRO_MV(XCOPY);
    case XELEM: REPRO_MV(XELEM);
    case XROWS:
      if constexpr (CC * sizeof(TI) % 16 == 0) REPRO_MV(XROWS);
      return (int)cudaErrorInvalidValue;
    case XV:
      if constexpr (CC == 1) REPRO_MV(XV);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MV
}

// route 0 staged, 1 direct, 2 the parent's direct route (X read element
// by element unless C == 1); `xcopy` the direct route's [B][cc][K]
// scratch, or null where X is read in place (aligned, and C == 1 or whole
// 16-byte vectors a row)
template <typename TI, typename TA>
int run(int route, const void* A, const void* X, void* Y, int B, int R,
        int K, int C, int c0, int blocks, int rows_per_block,
        int slab_bytes, int per_sm, void* xcopy, cudaStream_t st) {
  constexpr int NV = 16 / (int)sizeof(TI);
  const int cc = C - c0 < 8 ? C - c0 : 8;
  if (K % NV) return (int)cudaErrorInvalidValue;
  const TI* a = static_cast<const TI*>(A);
  const TI* x = static_cast<const TI*>(X);
  TA* y = static_cast<TA*>(Y);
  int xm;
  if (route == 0) {
    if ((long long)slab_bytes != (long long)cc * K * (long long)sizeof(TI) ||
        slab_bytes > STAGE_MAX || xcopy != nullptr)
      return (int)cudaErrorInvalidValue;
    xm = STAGED;
  } else if (route == 2) {
    if (slab_bytes != 0 || xcopy != nullptr) return (int)cudaErrorInvalidValue;
    xm = C == 1 && gemm::aligned16(X) ? XV : XELEM;
  } else if (route == 1 && slab_bytes == 0) {
    if (xcopy != nullptr) {
      TI* xt = static_cast<TI*>(xcopy);
      const int err = copy_columns<TI>(x, xt, B, K, C, c0, cc, st);
      if (err != 0) return err;
      x = xt;
      xm = XCOPY;
    } else if (!gemm::aligned16(X)) {
      return (int)cudaErrorInvalidValue;
    } else if (C == 1) {
      xm = XV;
    } else if (C % NV == 0 && c0 % NV == 0 && cc % NV == 0) {
      xm = XROWS;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_CC(CC)                                                     \
  return run_cc<TI, TA, CC>(xm, a, x, y, B, R, K, C, c0, blocks,         \
                            rows_per_block, slab_bytes, per_sm, st)
  switch (cc) {
    case 1: REPRO_CC(1);
    case 2: REPRO_CC(2);
    case 3: REPRO_CC(3);
    case 4: REPRO_CC(4);
    case 5: REPRO_CC(5);
    case 6: REPRO_CC(6);
    case 7: REPRO_CC(7);
    default: REPRO_CC(8);
  }
#undef REPRO_CC
}

// -- the wide route ---------------------------------------------------------
namespace wide {

namespace cg = cooperative_groups;

// plan.MV_WIDE_WARPS (rows a block: a warp's m16 tile each),
// plan.MV_WIDE_COLS, plan.MV_WIDE_MAX_SPLITS
constexpr int WARPS = 8, THREADS = WARPS * 32, BM = WARPS * 16;
constexpr int COLS = 64, MAX_SPLITS = 8, STAGES = 4;
// bytes of one row of A a stage holds: BK = 32 floats or 16 doubles
constexpr int ROW_BYTES = 128;

// NT n8 tiles of columns.  XV: X's rows are copied 16 bytes at a time (C
// and c0 multiples of the vector, X aligned), else element by element.
template <typename TI, int NT, bool XV>
struct Tile {
  static constexpr int BK = ROW_BYTES / (int)sizeof(TI);
  static constexpr int CW = 8 * NT;                 // the n8 tiles' columns
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int X_ELEMS = BK * CW;           // X's stage [BK][CW], raw
  static constexpr int STAGE_BYTES = A_BYTES + X_ELEMS * (int)sizeof(TI);
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int XD_LD = CW + 1;              // doubles a widened X row
  static constexpr int SMEM = RING + BK * XD_LD * 8;
  static constexpr int RED_LD = CW + 2;             // doubles a partial row
  // a 16-byte chunk c of an odd row sits at c ^ SW
  static constexpr int SW = sizeof(TI) == 4 ? 4 : 1;
  static constexpr int EPC = 16 / (int)sizeof(TI);  // elements a chunk
  static_assert(BM * RED_LD * 8 <= RING, "the partial tile reuses the ring");
  static_assert(X_ELEMS % THREADS == 0 && A_BYTES % (16 * THREADS) == 0,
                "a stage's copies split evenly over the threads");
};

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// a 16-byte copy of A into the ring, read once: L2 fetches 256 bytes
__device__ __forceinline__ void cp_async_a(void* smem, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(src_bytes));
}

// Stage of slab step k0: A rows [row0, row0 + BM) x [k0, k0 + BK) and X
// rows [k0, k0 + BK) x columns [c0, c0 + CW), zero past R, k_end and cc.
template <typename TI, int NT, bool XV>
__device__ __forceinline__ void load_stage(unsigned char* st, const TI* A,
                                           const TI* X, int R, int K, int C,
                                           int c0, int cc, int row0, int k0,
                                           int k_end, int tid) {
  using T = Tile<TI, NT, XV>;
  constexpr int CPR = ROW_BYTES / 16;
#pragma unroll
  for (int i = 0; i < T::A_BYTES / 16 / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CPR, ch = e % CPR;
    const int gr = row0 + r, gk = k0 + ch * T::EPC;
    const bool ok = gr < R && gk < k_end;
    cp_async_a(st + r * ROW_BYTES + ((ch ^ ((r & 1) * T::SW)) << 4),
               ok ? A + (size_t)gr * K + gk : A, ok ? 16 : 0);
  }
  TI* xs = reinterpret_cast<TI*>(st + T::A_BYTES);
  // a 16-byte vector past cc holds X's next columns, which no row keeps
  constexpr int V = XV ? T::EPC : 1;
#pragma unroll
  for (int e = tid * V; e < T::X_ELEMS; e += THREADS * V) {
    const int k = e / T::CW, c = e % T::CW;
    const bool ok = k0 + k < k_end && c < cc;
    gemm::cp_async<V * (int)sizeof(TI)>(
        xs + e, ok ? X + (size_t)(k0 + k) * C + c0 + c : X,
        ok ? V * (int)sizeof(TI) : 0);
  }
}

// A's elements k = 4 kq .. 4 kq + 3 of stage row r, widened
template <typename TI, int SW>
__device__ __forceinline__ void load4(const unsigned char* as, int r, int kq,
                                      double (&v)[4]) {
  const unsigned char* row = as + r * ROW_BYTES;
  if constexpr (sizeof(TI) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(
        row + ((kq ^ ((r & 1) * SW)) << 4));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const double2 d0 = *reinterpret_cast<const double2*>(
        row + (((2 * kq) ^ ((r & 1) * SW)) << 4));
    const double2 d1 = *reinterpret_cast<const double2*>(
        row + (((2 * kq + 1) ^ ((r & 1) * SW)) << 4));
    v[0] = d0.x; v[1] = d0.y; v[2] = d1.x; v[3] = d1.y;
  }
}

// Y_b[:, c0:c0+cc] of rows [128 x, 128 x + 128) over K slab y; the
// cluster of a row block's slabs sums them.  Fragment k slots: lane (g, t)
// holds k = 16 s + 4 t .. + 3 of k16 step s -- slots t and t + 4 of the
// first k8 step are its k and k + 1, of the second k + 2 and k + 3.
template <typename TI, int NT, bool XV>
__global__ void __launch_bounds__(THREADS, 2)
coded_matvec_wide_kernel(const TI* __restrict__ A, const TI* __restrict__ X,
                         double* __restrict__ Y, int R, int K, int C, int c0,
                         int cc, int splits, int k_span) {
  using T = Tile<TI, NT, XV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int task = blockIdx.z, row0 = blockIdx.x * BM, z = blockIdx.y;
  A += (size_t)task * R * K;
  X += (size_t)task * K * C;
  Y += (size_t)task * R * C;
  const int k_begin = z * k_span, k_end = min(K, k_begin + k_span);
  const int n_slabs = k_end > k_begin ? (k_end - k_begin + T::BK - 1) / T::BK
                                      : 0;
  const int n_live = min(NT, (cc + 7) / 8);        // warp-uniform
  double* xd = reinterpret_cast<double*>(smem + T::RING);

  double acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs)
      load_stage<TI, NT, XV>(smem + s * T::STAGE_BYTES, A, X, R, K, C, c0,
                             cc, row0, k_begin + s * T::BK, k_end, tid);
    gemm::cp_async_commit();
  }
  const int r_lo = warp * 16 + g;
  for (int kt = 0; kt < n_slabs; ++kt) {
    gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();          // stage kt landed; every warp is done with kt-1
    const int next = kt + STAGES - 1;
    if (next < n_slabs)
      load_stage<TI, NT, XV>(smem + (next % STAGES) * T::STAGE_BYTES, A, X,
                             R, K, C, c0, cc, row0, k_begin + next * T::BK,
                             k_end, tid);
    gemm::cp_async_commit();
    const unsigned char* as = smem + (kt % STAGES) * T::STAGE_BYTES;
    const TI* xs = reinterpret_cast<const TI*>(as + T::A_BYTES);
#pragma unroll
    for (int i = 0; i < T::X_ELEMS / THREADS; ++i) {
      const int e = tid + i * THREADS;
      xd[(e / T::CW) * T::XD_LD + e % T::CW] = static_cast<double>(xs[e]);
    }
    __syncthreads();          // the widened X of stage kt is whole
#pragma unroll
    for (int s = 0; s < T::BK / 16; ++s) {
      double lo[4], hi[4];
      load4<TI, T::SW>(as, r_lo, 4 * s + t, lo);
      load4<TI, T::SW>(as, r_lo + 8, 4 * s + t, hi);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double a[4] = {lo[2 * h], hi[2 * h], lo[2 * h + 1],
                             hi[2 * h + 1]};
        const double* xk = xd + (16 * s + 4 * t + 2 * h) * T::XD_LD + g;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < n_live) {
            const double b[2] = {xk[8 * j], xk[T::XD_LD + 8 * j]};
            dmma(acc[j], a, b);
          }
      }
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r_lo + 8 * h;
      if (row >= R) continue;
      double* yrow = Y + (size_t)row * C + c0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < cc) yrow[c] = acc[j][2 * h];
        if (c + 1 < cc) yrow[c + 1] = acc[j][2 * h + 1];
      }
    }
    return;
  }
  // the slab's partial tile into this block's shared memory, then the
  // cluster's sum of every slab's tile in slab order
  gemm::cp_async_wait<0>();
  __syncthreads();
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<double2*>(red + (r_lo + 8 * h) * T::RED_LD + 8 * j +
                                  2 * t) =
          make_double2(acc[j][2 * h], acc[j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (BM + splits - 1) / splits;
  const int rb = z * per, re = min(BM, rb + per);
  for (int e = tid; e < (re - rb) * cc; e += THREADS) {
    const int r = rb + e / cc, c = e % cc;
    const int off = r * T::RED_LD + c;
    double sum = cluster.map_shared_rank(red, 0)[off];
    for (int q = 1; q < splits; ++q)
      sum += cluster.map_shared_rank(red, q)[off];
    if (row0 + r < R) Y[(size_t)(row0 + r) * C + c0 + c] = sum;
  }
  cluster.sync();             // no block leaves while its tile is read
}

template <typename TI, int NT, bool XV>
int launch(const TI* A, const TI* X, double* Y, int B, int R, int K, int C,
           int c0, int cc, int row_blocks, int splits, int k_span,
           cudaStream_t st) {
  using T = Tile<TI, NT, XV>;
  auto kern = coded_matvec_wide_kernel<TI, NT, XV>;
  static bool ready = false;          // the attribute, once an instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, splits, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, A, X, Y, R, K, C,
                                             c0, cc, splits, k_span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TI, bool XV>
int run_nt(const TI* a, const TI* x, double* y, int B, int R, int K, int C,
           int c0, int cc, int row_blocks, int splits, int k_span,
           cudaStream_t st) {
  if (cc <= 16)
    return launch<TI, 2, XV>(a, x, y, B, R, K, C, c0, cc, row_blocks,
                             splits, k_span, st);
  if (cc <= 32)
    return launch<TI, 4, XV>(a, x, y, B, R, K, C, c0, cc, row_blocks,
                             splits, k_span, st);
  return launch<TI, 8, XV>(a, x, y, B, R, K, C, c0, cc, row_blocks, splits,
                           k_span, st);
}

template <typename TI>
int run(const void* A, const void* X, void* Y, int B, int R, int K, int C,
        int c0, int row_blocks, int splits, int k_span, cudaStream_t st) {
  constexpr int EPC = 16 / (int)sizeof(TI);
  const int cc = C - c0 < COLS ? C - c0 : COLS;
  if (K % EPC ||
      !gemm::plan_ok(K, splits, k_span, ROW_BYTES / (int)sizeof(TI)))
    return (int)cudaErrorInvalidValue;
  const TI* a = static_cast<const TI*>(A);
  const TI* x = static_cast<const TI*>(X);
  double* y = static_cast<double*>(Y);
  // X's rows in 16-byte copies: every row start and c0 on the vector
  if (C % EPC == 0 && c0 % EPC == 0 && gemm::aligned16(X))
    return run_nt<TI, true>(a, x, y, B, R, K, C, c0, cc, row_blocks, splits,
                            k_span, st);
  return run_nt<TI, false>(a, x, y, B, R, K, C, c0, cc, row_blocks, splits,
                           k_span, st);
}

}  // namespace wide

}  // namespace

extern "C" {

// Y (B, R, C) = A (B, R, K) @ X (B, K, C), row-major and contiguous per
// task: one kernel launch computes the columns [c0, min(c0 + 8, C)), so the
// caller loops over 8-column chunks.  `types` selects the instantiation:
// 0 = float in, float out; 1 = float in, double accumulation and out;
// 2 = double in and out.  K must be a multiple of the 16-byte vector width
// and A 16-byte aligned (the wrapper checks both).  The launch runs on the
// plan of kernels/plan.py's matvec_plan for this chunk: `route` (0 staged,
// 1 direct; 2 the parent's direct route, to time the two), `blocks` per
// task of `rows_per_block` rows (covering R with none empty), the staged X
// slab `slab_bytes` (0 when direct), the residency `per_sm` the grid was
// sized for, which the card must hold, and the direct route's X copy
// `xcopy` (B x cc x K elements of the input type, or null: see run()).
int repro_coded_matvec(int types, const void* A, const void* X, void* Y,
                       int B, int R, int K, int C, int c0, int route,
                       int blocks, int rows_per_block, int slab_bytes,
                       int per_sm, void* xcopy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || c0 < 0 || c0 >= C) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (blocks < 1 || rows_per_block < 1 || per_sm < 1 ||
      (long long)blocks * rows_per_block < R ||
      (long long)(blocks - 1) * rows_per_block >= R)
    return (int)cudaErrorInvalidValue;
  switch (types) {
    case 0: return run<float, float>(route, A, X, Y, B, R, K, C, c0, blocks,
                                     rows_per_block, slab_bytes, per_sm,
                                     xcopy, st);
    case 1: return run<float, double>(route, A, X, Y, B, R, K, C, c0,
                                      blocks, rows_per_block, slab_bytes,
                                      per_sm, xcopy, st);
    case 2: return run<double, double>(route, A, X, Y, B, R, K, C, c0,
                                       blocks, rows_per_block, slab_bytes,
                                       per_sm, xcopy, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide route: Y (B, R, C) double = A (B, R, K) @ X (B, K, C), row-major
// and contiguous per task, columns [c0, min(c0 + 64, C)) in one launch
// (the caller loops over 64-column chunks).  `types` 1 = float in, 2 =
// double in.  The plan of kernels/plan.py's matvec_plan (route "wide"):
// `row_blocks` = ceil(R / 128) blocks of 128 rows, `splits` <= 8 K slabs
// of `k_span` (a multiple of 128 bytes of A's row) that cover K with none
// empty, one cluster of `splits` blocks a row block.
int repro_coded_matvec_wide(int types, const void* A, const void* X,
                            void* Y, int B, int R, int K, int C, int c0,
                            int row_blocks, int splits, int k_span,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || c0 < 0 || c0 >= C) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (row_blocks != (R + wide::BM - 1) / wide::BM || splits < 1 ||
      splits > wide::MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (types == 1)
    return wide::run<float>(A, X, Y, B, R, K, C, c0, row_blocks, splits,
                            k_span, st);
  if (types == 2)
    return wide::run<double>(A, X, Y, B, R, K, C, c0, row_blocks, splits,
                             k_span, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
