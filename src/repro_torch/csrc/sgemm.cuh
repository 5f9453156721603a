// The port's one float32 GEMM core (IEEE FMAs, no TF32), shared by
// matmul.cu (C = A @ B, split-K) and mds_encode_gemm.cu (the float32
// encode: a task axis, G's parity rows from a row offset).
//
// C_b[m][n] (+ slab z) = sum_{k in slab z} A_b[m][k] B_b[k][n] for a batch
// of row-major operands given by base, batch stride and row stride.  Block
// (x, y, z): output tile (y, x) of 128 x 128 after a grouped raster (eight
// tile rows per group, so the blocks resident together share operand
// panels in L2), task z % batch, K slab z / batch of `k_span` elements.
//
// 256 threads, each an 8 x 8 register tile: rows ty*4 + i and 64 + ty*4 + i,
// columns tx*4 + j and 64 + tx*4 + j.  A 4-stage ring of BK = 32 slabs of A
// (As[m][k]) and B (Bs[k][n]) fills through cp.async, one __syncthreads a
// slab.  Each group of four k reads eight float4 of A (one row each; the
// half-warps broadcast) and, per k, two float4 of B (a quarter-warp reads
// 128 contiguous bytes): 4 shared loads per 64 FMAs, no bank conflicts.
// One block an SM (128 KB of ring, up to 255 registers): measured faster
// than two blocks held to 128 registers or than BK = 8 or 16, than A
// transposed in shared memory at two blocks an SM, and than a ring fed by
// a producer warp or warpgroup (those spilled); fragments double-buffered
// in registers were no faster beyond the spread (PERF.md).
// VEC = 16 copies 16-byte chunks (every row start and base 16-byte
// aligned); VEC = 4 copies single floats -- ragged or unaligned operands
// take the same pipeline with masked 4-byte copies.
#pragma once
#include "gemm_common.cuh"

namespace sgemm {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int A_TILE = BM * BK, B_TILE = BK * BN, STAGE = A_TILE + B_TILE;
constexpr int SMEM_BYTES = STAGES * STAGE * (int)sizeof(float);
constexpr int GROUP_M = 8;

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
sgemm_kernel(const float* __restrict__ A, long long a_bstride, int lda,
             const float* __restrict__ B, long long b_bstride, int ldb,
             float* __restrict__ C, long long c_bstride, long long c_zstride,
             int ldc, int M, int N, int K, int batch, int k_span) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z % batch, z = blockIdx.z / batch;
  A += b * a_bstride;
  B += b * b_bstride;
  C += b * c_bstride + z * c_zstride;
  int tm, tn;
  gemm::grouped_tile<GROUP_M>(tm, tn);
  const int row0 = tm * BM, col0 = tn * BN;
  const int k_begin = z * k_span, k_end = min(K, k_begin + k_span);
  const int n_slabs = (k_end - k_begin + BK - 1) / BK;

  auto load = [&](int slot, int kt) {
    float* As = smem + slot * STAGE;
    float* Bs = As + A_TILE;
    const int k0 = k_begin + kt * BK;
    if constexpr (VEC == 16) {
#pragma unroll
      for (int q = 0; q < A_TILE / 4 / THREADS; ++q) {
        const unsigned e = tid + q * THREADS;
        const int m = e / (BK / 4), c = e % (BK / 4);
        const int gr = row0 + m, gk = k0 + 4 * c;
        const bool ok = gr < M && gk < k_end;
        gemm::cp_async<16>(As + m * BK + 4 * c,
                           ok ? A + (size_t)gr * lda + gk : A, ok ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < B_TILE / 4 / THREADS; ++q) {
        const unsigned e = tid + q * THREADS;
        const int k = e / (BN / 4), c = e % (BN / 4);
        const int gk = k0 + k, gc = col0 + 4 * c;
        const bool ok = gk < k_end && gc < N;
        gemm::cp_async<16>(Bs + k * BN + 4 * c,
                           ok ? B + (size_t)gk * ldb + gc : B, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < A_TILE / THREADS; ++q) {
        const unsigned e = tid + q * THREADS;
        const int m = e / BK, k = e % BK;
        const int gr = row0 + m, gk = k0 + k;
        const bool ok = gr < M && gk < k_end;
        gemm::cp_async<4>(As + m * BK + k,
                          ok ? A + (size_t)gr * lda + gk : A, ok ? 4 : 0);
      }
#pragma unroll
      for (int q = 0; q < B_TILE / THREADS; ++q) {
        const unsigned e = tid + q * THREADS;
        const int k = e / BN, n = e % BN;
        const int gk = k0 + k, gc = col0 + n;
        const bool ok = gk < k_end && gc < N;
        gemm::cp_async<4>(Bs + k * BN + n,
                          ok ? B + (size_t)gk * ldb + gc : B, ok ? 4 : 0);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slabs) load(s, s);
    gemm::cp_async_commit();
  }
  for (int kt = 0; kt < n_slabs; ++kt) {
    gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < n_slabs) load(next % STAGES, next);
    gemm::cp_async_commit();
    const float* As = smem + (kt % STAGES) * STAGE;
    const float* Bs = As + A_TILE;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        a4[i] = *reinterpret_cast<const float4*>(As + r * BK + 4 * kq);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (4 * kq + kk) * BN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y
                        : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= M) continue;
    float* crow = C + (size_t)r * ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (VEC == 16 && c + 3 < N) {
        *reinterpret_cast<float4*>(crow + c) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
            acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) crow[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// Launch one plan: `splits` slabs of `k_span` (checked against K); with
// splits > 1 the slabs go to `ws` (splits * batch * M * N floats) and a
// second pass sums them into C.  Returns a cudaError_t.
inline int launch(const float* A, long long a_bstride, int lda,
                  const float* B, long long b_bstride, int ldb, float* C,
                  long long c_bstride, int ldc, float* ws, int M, int N,
                  int K, int batch, int splits, int k_span, cudaStream_t st) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (!gemm::plan_ok(K, splits, k_span, BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  float* out = splits > 1 ? ws : C;
  const long long o_bstride = splits > 1 ? (long long)M * N : c_bstride;
  const long long o_zstride = (long long)M * N * batch;
  const int o_ld = splits > 1 ? N : ldc;
  // 16-byte copies and stores need every row start and base aligned
  const bool vec = gemm::aligned16(A) && gemm::aligned16(B) &&
                   gemm::aligned16(out) && lda % 4 == 0 && ldb % 4 == 0 &&
                   K % 4 == 0 && N % 4 == 0 && o_ld % 4 == 0 &&
                   a_bstride % 4 == 0 &&
                   b_bstride % 4 == 0 && o_bstride % 4 == 0;
  auto kern = vec ? sgemm_kernel<16> : sgemm_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, SMEM_BYTES, st>>>(A, a_bstride, lda, B, b_bstride,
                                          ldb, out, o_bstride, o_zstride,
                                          o_ld, M, N, K, batch, k_span);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return gemm::sum_splits<float>(ws, C, batch, M, N, splits, ldc, c_bstride,
                                 st);
}

}  // namespace sgemm
