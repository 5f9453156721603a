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
//    two columns, 256 B a lane; 4 for up to four, 128 B; 2 beyond; half
//    that where X is read element by element, so nothing spills) before
//    the FMAs that consume them.  Two blocks of 8 warps an SM (the launch
//    bounds hold the registers to that residency) keep 32-128 KB of A in
//    flight an SM.  (PERF.md records the other RPW, U, load hints and
//    residencies that were timed against these.)
//  * Residency.  Two routes, chosen by kernels/plan.py's matvec_plan from
//    the size of one launch's X: "staged" copies X[:, c0:c0+cc] whole into
//    shared memory, transposed to [c][k] so that each lane's 16-byte read
//    is conflict-free and serves RPW rows (the serving tiles: a 32 KB
//    slab); "direct", for a long K with few columns (the executor and the
//    verify: 80 KB a task at K = 1e4 doubles), reads X through L1/L2 and
//    uses no shared memory, so registers alone bound the residency.
//  * Balance.  The grid is (blocks per task, tasks), a whole wave of
//    resident blocks where the rows allow; block x of a task owns the
//    contiguous rows [x * rows_per_block, (x + 1) * rows_per_block), so
//    every block does the same work to within a row and no block is left
//    with a partial round; its warps take the range's groups of RPW rows
//    in turn.
//  * Determinism.  Lane l sums the 16-byte vectors q = l, l + 32, ... of a
//    row in increasing order and the lanes are combined by a fixed
//    butterfly: a row's sum has one order whatever the plan, and repeated
//    calls are bit-equal (no atomics).
// C > 8 is split into column chunks by the host, one launch each; the C
// entry point checks the plan and the residency it assumes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// plan.MV_WARPS, plan.MV_BLOCKS_PER_SM, rows a warp reduces at once
constexpr int WARPS = 8, THREADS = WARPS * 32, MINB = 2, RPW = 2;
// plan.MV_STAGE_MAX: the largest X slab the staged route takes
constexpr int STAGE_MAX = 64 * 1024;

// 16-byte trips of RPW loads a lane issues before its FMAs; half as many
// where X is read element by element from global memory (XG), whose
// registers spill at the full depth
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

// STAGED: X[:, c0:c0+CC] in shared memory as [CC][K].  Else X from global
// memory; XV: C == 1 and X 16-byte aligned, so a lane reads X's vector q
// in one load.
template <typename TI, typename TA, int CC, bool STAGED, bool XV>
__global__ void __launch_bounds__(THREADS, MINB)
coded_matvec_kernel(const TI* __restrict__ A, const TI* __restrict__ X,
                    TA* __restrict__ Y, int R, int K, int C, int c0,
                    int rows_per_block) {
  using V = typename Vec16<TI>::type;
  constexpr int NV = 16 / sizeof(TI);      // elements per 16-byte load
  constexpr int U = trips<CC, !STAGED && !XV>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int task = blockIdx.y;
  A += (size_t)task * R * K;
  X += (size_t)task * K * C;
  Y += (size_t)task * R * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int KV = K / NV;
  const int b_begin = blockIdx.x * rows_per_block;
  const int b_end = min(R, b_begin + rows_per_block);

  const V* xsv = reinterpret_cast<const V*>(smem);     // [CC][KV]
  if constexpr (STAGED) {
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
    if constexpr (STAGED) {
      return xsv[c * KV + q];
    } else if constexpr (XV) {
      return __ldg(reinterpret_cast<const V*>(X) + q);
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
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const V xv = load_x(c, q0 + 32 * u);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int e = 0; e < NV; ++e)
              acc[r][c] = fma_t(TA(vget(a[u][r], e)), TA(vget(xv, e)),
                                acc[r][c]);
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

template <typename TI, typename TA, int CC, bool STAGED, bool XV>
int launch(const TI* A, const TI* X, TA* Y, int B, int R, int K, int C,
           int c0, int blocks, int rows_per_block, int slab_bytes,
           int per_sm, cudaStream_t st) {
  auto kern = coded_matvec_kernel<TI, TA, CC, STAGED, XV>;
  // the attribute and the residency are looked up once per instantiation
  // and slab size (host work a call, not device work)
  static int cached_slab = -1, resident = 0;
  if (slab_bytes != cached_slab) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_MAX);
    if (err == cudaSuccess && !STAGED)
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

template <typename TI, typename TA, bool STAGED>
int run_route(const void* A, const void* X, void* Y, int B, int R, int K,
              int C, int c0, int cc, int blocks, int rows_per_block,
              int slab_bytes, int per_sm, cudaStream_t st) {
  const TI* a = static_cast<const TI*>(A);
  const TI* x = static_cast<const TI*>(X);
  TA* y = static_cast<TA*>(Y);
#define REPRO_MV(CC, XV)                                                   \
  return launch<TI, TA, CC, STAGED, XV>(a, x, y, B, R, K, C, c0, blocks,   \
                                        rows_per_block, slab_bytes,        \
                                        per_sm, st)
  if constexpr (!STAGED) {
    if (C == 1 && (reinterpret_cast<uintptr_t>(X) & 15) == 0)
      REPRO_MV(1, true);
  }
  switch (cc) {
    case 1: REPRO_MV(1, false);
    case 2: REPRO_MV(2, false);
    case 3: REPRO_MV(3, false);
    case 4: REPRO_MV(4, false);
    case 5: REPRO_MV(5, false);
    case 6: REPRO_MV(6, false);
    case 7: REPRO_MV(7, false);
    default: REPRO_MV(8, false);
  }
#undef REPRO_MV
}

template <typename TI, typename TA>
int run(int route, const void* A, const void* X, void* Y, int B, int R,
        int K, int C, int c0, int blocks, int rows_per_block,
        int slab_bytes, int per_sm, cudaStream_t st) {
  const int cc = C - c0 < 8 ? C - c0 : 8;
  if (K % (16 / (int)sizeof(TI))) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if ((long long)slab_bytes != (long long)cc * K * (long long)sizeof(TI) ||
        slab_bytes > STAGE_MAX)
      return (int)cudaErrorInvalidValue;
    return run_route<TI, TA, true>(A, X, Y, B, R, K, C, c0, cc, blocks,
                                   rows_per_block, slab_bytes, per_sm, st);
  }
  if (route != 1 || slab_bytes != 0) return (int)cudaErrorInvalidValue;
  return run_route<TI, TA, false>(A, X, Y, B, R, K, C, c0, cc, blocks,
                                  rows_per_block, 0, per_sm, st);
}

}  // namespace

extern "C" {

// Y (B, R, C) = A (B, R, K) @ X (B, K, C), row-major and contiguous per
// task: one kernel launch computes the columns [c0, min(c0 + 8, C)), so the
// caller loops over 8-column chunks.  `types` selects the instantiation:
// 0 = float in, float out; 1 = float in, double accumulation and out;
// 2 = double in and out.  K must be a multiple of the 16-byte vector width
// and A 16-byte aligned (the wrapper checks both).  The launch runs on the
// plan of kernels/plan.py's matvec_plan for this chunk: `route` (0 staged,
// 1 direct), `blocks` per task of `rows_per_block` rows (covering R with
// none empty), the staged X slab `slab_bytes` (0 when direct), and the
// residency `per_sm` the grid was sized for, which the card must hold.
int repro_coded_matvec(int types, const void* A, const void* X, void* Y,
                       int B, int R, int K, int C, int c0, int route,
                       int blocks, int rows_per_block, int slab_bytes,
                       int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || c0 < 0 || c0 >= C) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  if (blocks < 1 || rows_per_block < 1 || per_sm < 1 ||
      (long long)blocks * rows_per_block < R ||
      (long long)(blocks - 1) * rows_per_block >= R)
    return (int)cudaErrorInvalidValue;
  switch (types) {
    case 0: return run<float, float>(route, A, X, Y, B, R, K, C, c0, blocks,
                                     rows_per_block, slab_bytes, per_sm, st);
    case 1: return run<float, double>(route, A, X, Y, B, R, K, C, c0,
                                      blocks, rows_per_block, slab_bytes,
                                      per_sm, st);
    case 2: return run<double, double>(route, A, X, Y, B, R, K, C, c0,
                                       blocks, rows_per_block, slab_bytes,
                                       per_sm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
