// Pieces shared by the port's GEMM kernels (matmul.cu, mds_encode_gemm.cu):
// cp.async copies into shared memory, the grouped tile raster, the
// fixed-order sum of split-K slabs, and the launch-side checks of a plan.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

// One asynchronous global -> shared copy of BYTES (4, 8 or 16) bytes, of
// which the first `src_bytes` are read and the rest zero-filled (0 for a
// masked element: nothing is read, `src` need only be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Output tile (row, column) of block (blockIdx.x, blockIdx.y) when blocks
// walk GROUP consecutive tile rows column by column: the blocks resident
// together share operand panels in L2.
template <int GROUP>
__device__ __forceinline__ void grouped_tile(int& tm, int& tn) {
  const int gx = gridDim.x, gy = gridDim.y;
  const int pid = blockIdx.y * gx + blockIdx.x;
  const int first = (pid / (GROUP * gx)) * GROUP;
  const int rows = min(gy - first, GROUP);
  const int in = pid % (GROUP * gx);
  tm = first + in % rows;
  tn = in / rows;
}

// C[b][m * ldc + n] = sum_z ws[z][b][m][n], z in increasing order: the
// second pass of a split-K product (deterministic, no atomics).
template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ ws, T* __restrict__ C,
                                  int batch, int M, int N, int splits,
                                  int ldc, long long c_bstride) {
  const size_t per = (size_t)M * N, n_all = per * batch;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_all;
       i += (size_t)gridDim.x * blockDim.x) {
    T s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(size_t)z * n_all + i];
    const size_t b = i / per, r = i % per;
    C[b * c_bstride + (r / N) * (size_t)ldc + r % N] = s;
  }
}

template <typename T>
int sum_splits(const T* ws, T* C, int batch, int M, int N, int splits,
               int ldc, long long c_bstride, cudaStream_t st) {
  const size_t n = (size_t)M * N * batch;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_splits_kernel<T><<<blocks, 256, 0, st>>>(ws, C, batch, M, N, splits,
                                               ldc, c_bstride);
  return (int)cudaGetLastError();
}

// A plan from the Python side (kernels/plan.py): `splits` slabs of
// `k_span` K elements (a multiple of bk) that cover K with none empty.
inline bool plan_ok(int K, int splits, int k_span, int bk) {
  if (splits < 1 || k_span < bk || k_span % bk) return false;
  return (long long)splits * k_span >= K &&
         (long long)(splits - 1) * k_span < (K > 0 ? K : 1);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace gemm
