// Tiled float32 GEMM C = A @ B for Hopper (sm_90a).
//
// Replaces repro/kernels/matmul.py::matmul_pallas (_matmul_kernel): the
// 128^3-block VMEM matmul with f32 accumulation that encodes parity rows
// (R_block @ W, repro/serve_coded/coded_linear.py:391).
//
// What bounds it on this card: at the serving shape (256 x 128512) @
// (128512 x 2048) the product does 1.35e11 FLOP on 1.05 GB of W, i.e.
// ~128 FLOP/byte -- above the f32 SIMT ridge (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP/byte), so it is bound by the f32 pipes (the port keeps IEEE f32,
// no TF32, to match the reference encode).
//
// Design: the TPU grid walks K sequentially with an accumulator in VMEM;
// here 64x64 output tiles run in parallel blocks, each thread holding a
// 4x4 register tile, with 16-deep A/B slabs staged through shared memory.
// The serving shape has only 4x32 output tiles for 132 SMs and a very long
// K, so K is split across gridDim.z slabs written to a workspace and summed
// in a fixed order by a second kernel (deterministic, no atomics).  Ragged
// M/N/K edges are masked in the loads and stores, so no operand padding is
// needed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ out, int M, int N, int K, int k_span) {
  __shared__ float As[BK][BM + 4];   // A slab, transposed: As[k][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_span;
  const int k_end = min(K, k_begin + k_span);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int gr = row0 + m, gk = k0 + k;
      As[k][m] = (gr < M && gk < k_end) ? A[(size_t)gr * K + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int gk = k0 + k, gc = col0 + n;
      Bs[k][n] = (gk < k_end && gc < N) ? B[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < N) dst[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// C[i] = sum_z ws[z][i], z in increasing order (fixed reduction order).
__global__ void sum_slabs_kernel(const float* __restrict__ ws,
                                 float* __restrict__ C, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(size_t)z * n + i];
    C[i] = s;
  }
}

}  // namespace

extern "C" {

// Number of K slabs the launch will use for an (M, N, K) product on a card
// with `sms` multiprocessors; the wrapper sizes the workspace with it.
int repro_matmul_splits(int M, int N, int K, int sms) {
  const long tiles = (long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const long want = (4L * sms + tiles - 1) / tiles;     // ~4 blocks per SM
  const long max_by_k = (K + 1023) / 1024;               // >= 1024-deep slabs
  long s = want < max_by_k ? want : max_by_k;
  if (s < 1) s = 1;
  if (s > 64) s = 64;
  return (int)s;
}

// C (M, N) = A (M, K) @ B (K, N), all float32 row-major.  `ws` holds
// splits * M * N floats when splits > 1 (unused otherwise).
int repro_matmul_f32(const float* A, const float* B, float* C, float* ws,
                     int M, int N, int K, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  int k_span = (K + splits - 1) / splits;
  k_span = ((k_span + BK - 1) / BK) * BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  matmul_f32_kernel<<<grid, THREADS, 0, st>>>(A, B, splits > 1 ? ws : C, M,
                                              N, K, k_span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)M * N;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  sum_slabs_kernel<<<blocks, 256, 0, st>>>(ws, C, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
