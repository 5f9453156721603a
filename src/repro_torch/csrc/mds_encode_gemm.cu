// MDS encode A~_b = G_b @ A_b for Hopper (sm_90a), one call per stack.
//
// Replaces repro/kernels/mds_encode.py::mds_encode_pallas (which runs the
// tiled matmul_pallas) together with its wrappers ops.mds_encode /
// ops.mds_encode_batch (repro/kernels/ops.py:59-86): the reference skips the
// identity prefix of a systematic generator, multiplies only the L~ - L
// parity rows, concatenates A in front, and vmaps the Pallas call over the
// task axis.  Here the task axis is in the grid, and in systematic mode a
// copy kernel writes A's rows into the output bit-exact while the GEMM
// writes the parity rows below them -- the concatenate's extra pass over
// the output never happens.  G is one shared (L~, L) generator (stride 0)
// or one per task.
//
// Types: float runs the port's float32 GEMM core (sgemm.cuh, the
// reference's numerics); double (the static executor and the streaming
// verify, whose results feed an MDS decode held to 1e-6) runs on the FP64
// tensor cores below.
//
// What bounds it on this card: at the executor's shape (4 tasks x parity
// (1e4 x 1e4) @ (1e4 x 1e4), double) 8e12 FLOP against 4.8 GB moved --
// ~1700 FLOP/byte, far above the ridge, so it is bound by the FP64 tensor
// cores (67 TFLOP/s; 34 outside them).  At the verify path's skinny shape
// ((1e4 x 1e4) @ (1e4 x ~50)) it moves G once, 0.8 GB, and is bound by HBM
// bytes; the 1e10 FLOP would take 0.29 ms on the SIMT pipes alone, above
// that bound, so it needs the tensor cores too.
//
// Design (double): mma.sync.aligned.m16n8k8.row.col.f64 (DMMA; one of the
// m16n8k* shapes that sm_90 adds to sm_80's m8n8k4), warp-specialized.  A
// producer warpgroup fills a 4-stage ring of BK = 16 slabs of G and A --
// with TMA (one thread, two tensor maps, zero fill past the edges) when the
// operands' bases and strides are 16-byte aligned, else with masked 8-byte
// cp.async copies into the same layout -- and hands each stage to the mma
// warps through mbarriers, so they issue no copies and meet no block-wide
// barrier; setmaxnreg moves the producers' registers to them (at most two
// warps an SM sub-partition fit the 64 float64 accumulators a thread of the
// wide tiling, and one warp alone does not keep an FP64 tensor pipe busy,
// so every instruction taken off the mma warps counts).  Lane (g, t) reads
// its fragments with 8-byte loads straight into the mma's operand
// registers (16-byte loads of adjacent k make ptxas copy every fragment
// before each mma); the k of each mma slot is chosen so that those loads
// are free of bank conflicts under TMA's 128-byte swizzle (kslot below).
// Two tile configurations (kernels/plan.py picks one from the shape):
//   wide   (S > 64): 128 x 128 tiles, 8 mma warps of 64 x 32, one block an
//          SM; a warp loads all of a k-step's fragments, then issues its
//          16 mmas;
//   skinny (S <= 64): 128 x 64 tiles, 4 mma warps of 32 x 64 of which only
//          the ceil(S / 8) live n8 tiles are computed, two blocks an SM; a
//          warp holds its G fragments and streams A's one n8 tile at a
//          time.  K is split deterministically until the grid has at least
//          two blocks an SM, so the whole stream of G stays in flight while
//          the right operand (1e4 x 50 doubles, 4 MB) is read from L2.
// (Each loop order was the faster of the two at its shape.)  Blocks walk
// output tiles in groups of eight tile rows (blocks resident together
// share panels of G and A in L2).  Each output element is a float64 sum of
// exact float64 products in another order than a sequential loop.
//
// The float32 stream (kernels/plan.py's encode_plan: at most 8 computed
// rows against at most 8 rows of A -- the coded-gradient encode, 2 parity
// rows of 4 over D = 1.24e9 columns).  There the GEMM's 128 x 128 tile
// computes 64x the rows it needs and reads A twice (the prefix copy, the
// product); the function itself moves (K + L~) S floats and does 2 M K S
// FLOP, ~1 FLOP a byte, so it is bound by HBM bytes alone: 49.5 GB, 14.8
// ms at 3.35 TB/s.  One pass: each thread reads 16-byte vectors of the K
// rows of A at its columns (read-once loads), writes them unchanged to the
// systematic rows and the computed rows beside them, each output element
// fmaf'd in k order from 0 -- the per-element order of the sgemm core at
// K <= its BK, so the result equals the GEMM route's.  G's computed rows
// sit in shared memory (one broadcast read a k), shared or one per task;
// every element offset is 64-bit (K S is 4.9e9 floats at that shape).  S
// not a multiple of 4, or an A or output base not 16-byte aligned, takes
// the same kernel with 4-byte accesses, so no load reads past a row.
#include "gemm_common.cuh"
#include "hopper.cuh"
#include "sgemm.cuh"

namespace {

using namespace hopper;

constexpr int BK = 16, STAGES = 4, GROUP_M = 8;

__device__ __forceinline__ void dmma_16x8x8(double (&c)[4],
                                            const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ double lds64(unsigned addr) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
  return v;
}
// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mb_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               ::"r"(saddr(bar)) : "memory");
}

template <int BM, int BN, int WM, int WN, int MIN_BLOCKS>
struct Tiles {
  static constexpr int WARPS_N = BN / WN;
  static constexpr int CONSUMERS = 32 * (BM / WM) * WARPS_N;  // mma threads
  static constexpr int THREADS = CONSUMERS + 128;   // + producer warpgroup
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int G_BYTES = BM * BK * 8, A_BYTES = BK * BN * 8;
  static constexpr int STAGE_BYTES = G_BYTES + A_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + align
  // The launch grants REGS registers a thread; the producer warpgroup keeps
  // PRODUCER_REGS and hands the rest of its share to the mma warps.
  static constexpr int REGS = 65536 / (THREADS * MIN_BLOCKS) / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS =
      (THREADS * REGS - 128 * PRODUCER_REGS) / CONSUMERS / 8 * 8;
  static_assert(CONSUMERS % 128 == 0, "setmaxnreg acts on warpgroups");
  static_assert(CONSUMER_REGS <= 256, "no more than 256 registers");
  static_assert(BN % 16 == 0, "A arrives in boxes of 16 columns");
};

// Byte offsets in a stage of element (m, k) of its G tile and (k, n) of its
// A tile, as TMA's 128-byte swizzle lays them out: the 16-byte chunk c of a
// 128-byte row r sits at c ^ (r % 8); A arrives as BN / 16 boxes of 16
// columns.  (Written with m & 7 and k & 7 apart: the fragment rows' m & 7
// is the lane's g, which the compiler then folds; the equivalent
// ((k >> 1) ^ m) & 7 measured slower.)
__device__ __forceinline__ int g_off(int m, int k) {
  return m * 128 + (((k >> 1) ^ (m & 7)) << 4) + ((k & 1) << 3);
}
__device__ __forceinline__ int a_off(int k, int n) {
  return (n >> 4) * (16 * BK * 8) + k * 128 +
         ((((n & 15) >> 1) ^ (k & 7)) << 4) + ((n & 1) << 3);
}

// The k of mma slot t (lo) and t + 4 (hi) in k-step kk of a slab.  Each
// group of four k differs in bits 1-2 (the A reads of a half-warp, rows k
// at one column pair, hit distinct chunks) and in bits 0 and 3 (the G
// reads, rows g = 0..3 at k, hit distinct chunks and halves): {0, 3, 12,
// 15}, {1, 2, 13, 14}, {4, 7, 8, 11}, {5, 6, 9, 10}.
__device__ __forceinline__ int kslot(int kk, bool hi, int t) {
  const int a = t & 1, c = t >> 1;
  return kk == 0 ? (hi ? 1 + a + 12 * c : 3 * a + 12 * c)
                 : (hi ? 5 + a + 4 * c : 4 + 3 * a + 4 * c);
}

// C (+ slab z) = G_b rows [row0, row0 + BM) @ A_b, one output tile a block.
// Warps 0 .. CONSUMERS/32 - 1 run the mmas; the last warpgroup fills the
// ring: with TMA (one thread, two tensor maps) when the operands allow it,
// else every producer thread with masked 8-byte cp.async copies into the
// same swizzled layout.  Stage s is handed over through mbarriers full[s]
// (filled) and empty[s] (read by every mma thread): no block-wide barrier
// inside the loop.
template <int BM, int BN, int WM, int WN, int MIN_BLOCKS, bool TMA>
__global__ void __launch_bounds__(Tiles<BM, BN, WM, WN, MIN_BLOCKS>::THREADS,
                                  MIN_BLOCKS)
dgemm_kernel(const __grid_constant__ CUtensorMap tG,
             const __grid_constant__ CUtensorMap tA,
             const double* __restrict__ G, long long g_bstride, int ldg,
             const double* __restrict__ A, long long a_bstride, int lda,
             double* __restrict__ C, long long c_bstride,
             long long c_zstride, int ldc, int M, int N, int K, int batch,
             int k_span) {
  using T = Tiles<BM, BN, WM, WN, MIN_BLOCKS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  unsigned char* ring = smem + ((1024 - (saddr(smem) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z % batch, z = blockIdx.z / batch;
  int tm, tn;
  gemm::grouped_tile<GROUP_M>(tm, tn);
  const int row0 = tm * BM, col0 = tn * BN;
  const int k_begin = z * k_span, k_end = min(K, k_begin + k_span);
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mb_init(&full[s], TMA ? 1 : 128);
      mb_init(&empty[s], T::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {                          // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(T::PRODUCER_REGS));
    const int p = tid - T::CONSUMERS;
    if (TMA && p != 0) return;
    const double* Gb = G + b * g_bstride;
    const double* Ab = A + b * a_bstride;
    for (int kt = 0; kt < n_slabs; ++kt) {
      const int s = kt % STAGES, k0 = k_begin + kt * BK;
      unsigned char* st = ring + s * T::STAGE_BYTES;
      if (kt >= STAGES) mb_wait(&empty[s], (kt / STAGES - 1) & 1);
      if constexpr (TMA) {
        mb_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load(st, &tG, &full[s], k0, row0, g_bstride ? b : 0);
#pragma unroll
        for (int nb = 0; nb < BN / 16; ++nb)
          tma_load(st + T::G_BYTES + nb * 16 * BK * 8, &tA, &full[s],
                   col0 + 16 * nb, k0, b);
      } else {
        for (int e = p; e < BM * BK; e += 128) {
          const int gr = row0 + e / BK, gk = k0 + e % BK;
          const bool ok = gr < M && gk < k_end;
          gemm::cp_async<8>(st + g_off(e / BK, e % BK),
                            ok ? Gb + (size_t)gr * ldg + gk : Gb, ok ? 8 : 0);
        }
        for (int e = p; e < BK * BN; e += 128) {
          const int gk = k0 + e / BN, gc = col0 + e % BN;
          const bool ok = gk < k_end && gc < N;
          gemm::cp_async<8>(st + T::G_BYTES + a_off(e / BN, e % BN),
                            ok ? Ab + (size_t)gk * lda + gc : Ab, ok ? 8 : 0);
        }
        mb_arrive_cp_async(&full[s]);
      }
    }
    if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(T::CONSUMER_REGS));
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  // n8 tiles of this warp with at least one column inside N (warp-uniform)
  const int n_live = min(T::NT, max(0, (N - col0 - wn * WN + 7) / 8));
  double acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0;

  for (int kt = 0; kt < n_slabs; ++kt) {
    const int s = kt % STAGES;
    mb_wait(&full[s], (kt / STAGES) & 1);
    const unsigned gs = saddr(ring + s * T::STAGE_BYTES);
    const unsigned as = gs + T::G_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int klo = kslot(kk, false, t), khi = kslot(kk, true, t);
      // G fragment of m16 tile i: (g, lo), (g + 8, lo), (g, hi), (g + 8, hi);
      // A fragment of n8 tile j: (lo, g), (hi, g)
      auto g_frag = [&](int i, double (&a)[4]) {
        const int r = wm * WM + i * 16 + g;
        a[0] = lds64(gs + g_off(r, klo));
        a[1] = lds64(gs + g_off(r + 8, klo));
        a[2] = lds64(gs + g_off(r, khi));
        a[3] = lds64(gs + g_off(r + 8, khi));
      };
      auto a_frag = [&](int j, double (&f)[2]) {
        const int n = wn * WN + j * 8 + g;
        f[0] = lds64(as + a_off(klo, n));
        f[1] = lds64(as + a_off(khi, n));
      };
      double af[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) g_frag(i, af[i]);
      if constexpr (T::NT > T::MT) {
        // skinny: stream A's fragments one n8 tile at a time
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          if (j < n_live) {
            double bf[2];
            a_frag(j, bf);
#pragma unroll
            for (int i = 0; i < T::MT; ++i) dmma_16x8x8(acc[i][j], af[i], bf);
          }
      } else {
        // wide: every fragment of the step first (unpredicated: a dead
        // tile's loads read the zero-filled ring), then its mmas
        double bf[T::NT][2];
#pragma unroll
        for (int j = 0; j < T::NT; ++j) a_frag(j, bf[j]);
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
          if (j < n_live)
#pragma unroll
            for (int i = 0; i < T::MT; ++i)
              dmma_16x8x8(acc[i][j], af[i], bf[j]);
      }
    }
    // the stage's next fill comes from the async proxy (TMA): order this
    // thread's shared reads of it before that, then release it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mb_arrive(&empty[s]);
  }

  C += b * c_bstride + z * c_zstride;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * WM + i * 16 + g + 8 * h;
      if (r >= M) continue;
      double* crow = C + (size_t)r * ldc;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int c = col0 + wn * WN + j * 8 + 2 * t;
        if (c < N) crow[c] = acc[i][j][2 * h];
        if (c + 1 < N) crow[c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// A 3-D float64 tensor (d0 innermost; row strides s1, s2 in elements) read
// in boxes of b0 x b1 x 1 with the 128-byte swizzle; elements outside the
// tensor arrive as zeros.
bool tensor_map(CUtensorMap* map, const double* base, long long d0,
                long long d1, long long d2, long long s1, long long s2,
                int b0, int b1) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 8, (cuuint64_t)s2 * 8};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3,
            const_cast<double*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int WM, int WN, int MIN_BLOCKS>
int dgemm(const double* G, long long g_bstride, int ldg, const double* A,
          long long a_bstride, int lda, double* C, long long c_bstride,
          int ldc, double* ws, int M, int N, int K, int batch, int splits,
          int k_span, cudaStream_t st) {
  using T = Tiles<BM, BN, WM, WN, MIN_BLOCKS>;
  if (!gemm::plan_ok(K, splits, k_span, BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  double* out = splits > 1 ? ws : C;
  const long long o_bstride = splits > 1 ? (long long)M * N : c_bstride;
  const int o_ld = splits > 1 ? N : ldc;
  // TMA needs 16-byte aligned bases and row and task strides
  const bool tma = gemm::aligned16(G) && gemm::aligned16(A) &&
                   ldg % 2 == 0 && lda % 2 == 0 && g_bstride % 2 == 0 &&
                   a_bstride % 2 == 0;
  CUtensorMap mg{}, ma{};
  if (tma && !(tensor_map(&mg, G, K, M, g_bstride ? batch : 1, ldg,
                          g_bstride ? g_bstride : (long long)ldg * M, BK,
                          BM) &&
               tensor_map(&ma, A, N, K, batch, lda, a_bstride, 16, BK)))
    return (int)cudaErrorInvalidValue;
  auto kern = tma ? dgemm_kernel<BM, BN, WM, WN, MIN_BLOCKS, true>
                  : dgemm_kernel<BM, BN, WM, WN, MIN_BLOCKS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, T::THREADS, T::SMEM_BYTES, st>>>(
      mg, ma, G, g_bstride, ldg, A, a_bstride, lda, out, o_bstride,
      (long long)M * N * batch, o_ld, M, N, K, batch, k_span);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return gemm::sum_splits<double>(ws, C, batch, M, N, splits, ldc, c_bstride,
                                  st);
}

// out_b[i] = A_b[i] for i < L * S: the systematic prefix, bit for bit
template <typename T>
__global__ void copy_prefix_kernel(const T* __restrict__ A,
                                   T* __restrict__ out, size_t n,
                                   size_t out_bstride) {
  const T* src = A + blockIdx.y * n;
  T* dst = out + blockIdx.y * out_bstride;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

template <typename T>
int copy_prefix(const T* A, T* out, int B, size_t n, size_t out_bstride,
                cudaStream_t st) {
  const size_t want = (n + 255) / 256;
  dim3 grid((unsigned)(want < 1024 ? want : 1024), B);
  copy_prefix_kernel<T><<<grid, 256, 0, st>>>(A, out, n, out_bstride);
  return (int)cudaGetLastError();
}

// -- the float32 stream route ----------------------------------------------
namespace stream_route {

// plan.ENC_STREAM_THREADS, plan.ENC_STREAM_MAX_ROWS, plan.ENC_STREAM_MAX_K
constexpr int THREADS = 256, MAX_ROWS = 8, MAX_K = 8;

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ T fmadd(float g, T a, T c) {
    return make_float4(fmaf(g, a.x, c.x), fmaf(g, a.y, c.y),
                       fmaf(g, a.z, c.z), fmaf(g, a.w, c.w));
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    __stcs(p, v);
  }
  static __device__ __forceinline__ T fmadd(float g, T a, T c) {
    return fmaf(g, a, c);
  }
};

// out_b rows [0, copy) = A_b's rows (copy = L or 0), rows [copy, copy + M)
// = G_b's rows [copy, copy + M) @ A_b; VEC columns a step of a thread
template <int VEC>
__global__ void __launch_bounds__(THREADS)
encode_stream_kernel(const float* __restrict__ G, long long g_bstride,
                     const float* __restrict__ A, float* __restrict__ out,
                     int Lt, int L, long long S, int copy, int M) {
  using V = Vec<VEC>;
  __shared__ float gs[MAX_ROWS * MAX_K];
  const int b = blockIdx.y;
  const float* gb = G + b * g_bstride + (long long)copy * L;
  for (int i = threadIdx.x; i < M * L; i += THREADS) gs[i] = gb[i];
  __syncthreads();
  const float* ab = A + (long long)b * L * S;
  float* ob = out + (long long)b * Lt * S;
  const long long n = S / VEC;
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x; q < n;
       q += (long long)gridDim.x * THREADS) {
    const long long col = q * VEC;
    typename V::T a[MAX_K];
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < L) a[k] = V::load(ab + k * S + col);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < copy) V::store(ob + k * S + col, a[k]);
#pragma unroll
    for (int m = 0; m < MAX_ROWS; ++m) {
      if (m >= M) break;
      typename V::T acc{};
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < L) acc = V::fmadd(gs[m * L + k], a[k], acc);
      V::store(ob + (copy + m) * S + col, acc);
    }
  }
}

}  // namespace stream_route

}  // namespace

extern "C" {

// out (B, L~, S) = G (L~, L) or (B, L~, L) @ A (B, L, S), all row-major and
// contiguous; `g_stride` is 0 for a shared G, L~ * L for per-task G.  With
// `systematic` (and L~ > L) the top L rows of G are taken to be I_L: out's
// first L rows are copies of A and only G's parity rows are multiplied.
// `f64` selects double (else float) for every operand and the accumulator.
// The product (M = L~ - L parity rows, or L~) runs on the plan from
// kernels/plan.py: `config` (0 sgemm for float; 1 wide or 2 skinny for
// double), `splits` K slabs of `k_span`, and `ws` of splits * B * M * S
// elements when splits > 1.
int repro_mds_encode(int f64, const void* G, long long g_stride,
                     const void* A, void* out, int B, int Lt, int L, int S,
                     int systematic, int config, int splits, int k_span,
                     void* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lt <= 0 || S <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool sys = systematic && Lt > L;
  const int row_off = sys ? L : 0, M = Lt - row_off;
  const long long a_bstride = (long long)L * S, c_bstride = (long long)Lt * S;
  const size_t off_g = (size_t)row_off * L, off_c = (size_t)row_off * S;
  int err = 0;
  if (f64) {
    const double* g = static_cast<const double*>(G) + off_g;
    const double* a = static_cast<const double*>(A);
    double* o = static_cast<double*>(out);
    double* w = static_cast<double*>(ws);
    if (sys) err = copy_prefix(a, o, B, (size_t)L * S, (size_t)c_bstride, st);
    if (err) return err;
    if (config == 1)
      return dgemm<128, 128, 64, 32, 1>(g, g_stride, L, a, a_bstride, S,
                                        o + off_c, c_bstride, S, w, M, S, L,
                                        B, splits, k_span, st);
    if (config == 2)
      return dgemm<128, 64, 32, 64, 2>(g, g_stride, L, a, a_bstride, S,
                                       o + off_c, c_bstride, S, w, M, S, L,
                                       B, splits, k_span, st);
    return (int)cudaErrorInvalidValue;
  }
  if (config != 0) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(G) + off_g;
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(out);
  if (sys) err = copy_prefix(a, o, B, (size_t)L * S, (size_t)c_bstride, st);
  if (err) return err;
  return sgemm::launch(g, g_stride, L, a, a_bstride, S, o + off_c, c_bstride,
                       S, static_cast<float*>(ws), M, S, L, B, splits,
                       k_span, st);
}

// The float32 stream route of the same encode (kernels/plan.py's
// encode_plan, route "stream"): out (B, L~, S) from G (L~, L) or (B, L~, L)
// and A (B, L, S) as above, at most 8 computed rows (L~ - L when
// systematic, else L~) and at most 8 rows of A, in one pass over A.  The
// grid is `blocks` x B.
int repro_mds_encode_stream(const void* G, long long g_stride, const void* A,
                            void* out, int B, int Lt, int L, long long S,
                            int systematic, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lt <= 0 || S <= 0) return 0;
  if (B > 65535 || blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const int copy = systematic && Lt > L ? L : 0, M = Lt - copy;
  namespace sr = stream_route;
  if (L < 1 || L > sr::MAX_K || M < 1 || M > sr::MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(G);
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(out);
  const dim3 grid(blocks, B);
  if (S % 4 == 0 && gemm::aligned16(a) && gemm::aligned16(o))
    sr::encode_stream_kernel<4><<<grid, sr::THREADS, 0, st>>>(
        g, g_stride, a, o, Lt, L, S, copy, M);
  else
    sr::encode_stream_kernel<1><<<grid, sr::THREADS, 0, st>>>(
        g, g_stride, a, o, Lt, L, S, copy, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
