// MDS encode A~_b = G_b @ A_b for Hopper (sm_90a), one launch per stack.
//
// Replaces repro/kernels/mds_encode.py::mds_encode_pallas (which runs the
// tiled matmul_pallas) together with its wrappers ops.mds_encode /
// ops.mds_encode_batch (repro/kernels/ops.py:59-86): the reference skips the
// identity prefix of a systematic generator, multiplies only the L~ - L
// parity rows, concatenates A in front, and vmaps the Pallas call over the
// task axis.  Here the task axis is gridDim.z, and in systematic mode the
// first ceil(L / BM) row tiles of the grid copy A's rows into the output
// bit-exact while the others compute the parity rows -- the concatenate's
// extra pass over the output never happens.  G is one shared (L~, L)
// generator (stride 0) or one per task.
//
// Types: T = float accumulates in float (the reference's numerics);
// T = double accumulates in double (the static executor and the streaming
// verify, whose results feed an MDS decode held to 1e-6).
//
// What bounds it on this card: at the executor's shape (4 tasks x parity
// (1e4 x 1e4) @ (1e4 x 1e4), double) 8e12 FLOP against 4.8 GB moved --
// ~1700 FLOP/byte, far above the ridge, so it is bound by the float64
// pipes (34 TFLOP/s outside the tensor cores, 67 with DMMA).  At the
// verify path's skinny shape ((1e4 x 1e4) @ (1e4 x ~50)) it moves G once,
// 0.8 GB, and is bound by HBM bytes.
//
// Design: a plain SIMT GEMM, right first.  128 x 128 output tiles, 256
// threads each holding an 8 x 8 register tile, BK = 8 slabs of G
// (transposed) and A in shared memory, double-buffered, with the next slab
// prefetched into registers while the current one is consumed -- one
// __syncthreads per slab.  A thread owns rows ty + 16 i and columns
// tx + 16 j, so a half-warp reads 16 consecutive shared words (no bank
// conflicts) and the epilogue stores are coalesced.  8 x 8 is what keeps
// the float64 FMAs fed from shared memory (16 loads per 64 FMAs).  Ragged
// edges are masked; no operand padding and no alignment is assumed.
// FP64 mma.sync (DMMA) is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int THREADS = 256;                 // 16 x 16 threads
constexpr int LOADS = BM * BK / THREADS;     // per thread per operand slab

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mds_encode_kernel(const T* __restrict__ G, long long g_stride,
                  const T* __restrict__ A, T* __restrict__ out, int Lt,
                  int L, int S, int copy_tiles, int row_off) {
  const int task = blockIdx.z;
  A += (size_t)task * L * S;
  out += (size_t)task * Lt * S;
  G += (size_t)task * g_stride;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;

  if ((int)blockIdx.y < copy_tiles) {
    // systematic prefix: out[r] = A[r], bit-exact
    const int r0 = blockIdx.y * BM;
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = r0 + e / BN, c = col0 + e % BN;
      if (r < L && c < S) out[(size_t)r * S + c] = A[(size_t)r * S + c];
    }
    return;
  }
  // output rows [row0, row0 + BM) of out, from G rows of the same index
  const int row0 = row_off + (blockIdx.y - copy_tiles) * BM;
  const int K = L;

  __shared__ T Gs[2][BK][BM + 1];     // G slab, transposed: Gs[k][m]
  __shared__ T As[2][BK][BN];
  const int tx = tid % 16, ty = tid / 16;

  T g_reg[LOADS], a_reg[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + q * THREADS;
      const int m = e / BK, k = e % BK;        // G: 8 consecutive k per row
      const int gr = row0 + m, gk = k0 + k;
      g_reg[q] = (gr < Lt && gk < K) ? G[(size_t)gr * K + gk] : T(0);
      const int ak = e / BN, n = e % BN;       // A: 128 consecutive cols
      const int gak = k0 + ak, gc = col0 + n;
      a_reg[q] = (gak < K && gc < S) ? A[(size_t)gak * S + gc] : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + q * THREADS;
      Gs[buf][e % BK][e / BK] = g_reg[q];
      As[buf][e / BN][e % BN] = a_reg[q];
    }
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  fetch(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Gs[buf][k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = As[buf][k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_t(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= Lt) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < S) out[(size_t)r * S + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* G, long long g_stride, const void* A, void* out,
           int B, int Lt, int L, int S, int systematic, cudaStream_t st) {
  if (B <= 0 || Lt <= 0 || S <= 0) return 0;
  const bool sys = systematic && Lt > L;
  const int copy_tiles = sys ? (L + BM - 1) / BM : 0;
  const int row_off = sys ? L : 0;
  const int gemm_tiles = (Lt - row_off + BM - 1) / BM;
  dim3 grid((S + BN - 1) / BN, copy_tiles + gemm_tiles, B);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  mds_encode_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(G), g_stride, static_cast<const T*>(A),
      static_cast<T*>(out), Lt, L, S, copy_tiles, row_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, L~, S) = G (L~, L) or (B, L~, L) @ A (B, L, S), all row-major and
// contiguous; `g_stride` is 0 for a shared G, L~ * L for per-task G.  With
// `systematic` (and L~ > L) the top L rows of G are taken to be I_L: out's
// first L rows are copies of A and only G's parity rows are multiplied.
// `f64` selects double (else float) for every operand and the accumulator.
int repro_mds_encode(int f64, const void* G, long long g_stride,
                     const void* A, void* out, int B, int Lt, int L, int S,
                     int systematic, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(G, g_stride, A, out, B, Lt, L, S, systematic,
                              st)
             : launch<float>(G, g_stride, A, out, B, Lt, L, S, systematic,
                             st);
}

}  // extern "C"
