// Skinny coded product Y = A @ X for Hopper (sm_90a).
//
// Replaces repro/kernels/coded_matvec.py::coded_matvec_pallas
// (_matvec_kernel): the 128x128-block matvec with the B columns kept whole
// that runs a serving step's packed shard tiles in one launch
// (repro/kernels/ops.py:303), and the W @ X half of the generated-parity
// product.
//
// What bounds it on this card: A is (R, K) float32 and X is (K, C) with C a
// step batch (<= a few slots), so the kernel does 2*C FLOP per 4-byte
// element of A -- far below the ridge.  It is bound by reading A from HBM
// once: at the llama3.2-1b head (R ~ 128512, K = 2048) that is ~1.05 GB,
// ~0.31 ms at 3.35 TB/s.
//
// Design: X is staged once per block into shared memory, transposed to
// [c][k] so that each lane's float4 read of X is conflict-free, and the
// block then streams rows of A with 16-byte coalesced loads (each warp owns
// 4 rows and keeps 4 loads in flight per lane), reducing each row with warp
// shuffles.  Blocks are persistent (about 4 per SM) and walk row groups, so
// X is staged once per block, not once per row tile as on the TPU grid.  A
// K longer than the shared-memory slab is walked in slabs, restaged per
// row group.  C > 8 is split into column chunks by the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, RPW = 4, THREADS = WARPS * 32;
constexpr int ROWS_PER_GROUP = WARPS * RPW;
constexpr int SMEM_BYTES = 96 * 1024;

template <int CC>
__global__ void __launch_bounds__(THREADS)
coded_matvec_kernel(const float* __restrict__ A, const float* __restrict__ X,
                    float* __restrict__ Y, int R, int K, int C, int c0,
                    int KT) {
  extern __shared__ float4 xs4[];          // [CC][KT / 4]
  float* xs = reinterpret_cast<float*>(xs4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_groups = (R + ROWS_PER_GROUP - 1) / ROWS_PER_GROUP;
  const bool single = KT >= K;
  const int KT4 = KT / 4;

  auto stage = [&](int k0, int kt) {
    for (int i = threadIdx.x; i < kt * CC; i += THREADS) {
      const int k = i / CC, c = i % CC;
      xs[c * KT + k] = X[(size_t)(k0 + k) * C + c0 + c];
    }
  };
  if (single) {
    stage(0, K);
    __syncthreads();
  }
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int rbase = g * ROWS_PER_GROUP + warp * RPW;
    float acc[RPW][CC];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kt = min(KT, K - k0);
      if (!single) {
        __syncthreads();
        stage(k0, kt);
        __syncthreads();
      }
      for (int q = lane; q < kt / 4; q += 32) {
        float4 a[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = rbase + r;
          a[r] = row < R ? __ldcs(reinterpret_cast<const float4*>(
                               A + (size_t)row * K + k0) + q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float4 x = xs4[c * KT4 + q];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            acc[r][c] = fmaf(a[r].x, x.x, acc[r][c]);
            acc[r][c] = fmaf(a[r].y, x.y, acc[r][c]);
            acc[r][c] = fmaf(a[r].z, x.z, acc[r][c]);
            acc[r][c] = fmaf(a[r].w, x.w, acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[r][c] = v;
      }
      const int row = rbase + r;
      if (row < R && lane < CC) {
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (c == lane) v = acc[r][c];
        Y[(size_t)row * C + c0 + lane] = v;
      }
    }
  }
}

template <int CC>
int launch(const float* A, const float* X, float* Y, int R, int K, int C,
           int c0, cudaStream_t st) {
  int KT = SMEM_BYTES / (CC * 4);
  KT = (KT / 4) * 4;
  if (KT > K) KT = K;
  const size_t smem = (size_t)CC * KT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      coded_matvec_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_groups = (R + ROWS_PER_GROUP - 1) / ROWS_PER_GROUP;
  const int grid = n_groups < 4 * sms ? n_groups : 4 * sms;
  coded_matvec_kernel<CC><<<grid, THREADS, smem, st>>>(A, X, Y, R, K, C, c0,
                                                      KT);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (R, C) = A (R, K) @ X (K, C), float32 row-major; K % 4 == 0 and A
// 16-byte aligned (the wrapper checks both).
int repro_coded_matvec_f32(const float* A, const float* X, float* Y, int R,
                           int K, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || C <= 0) return 0;
  for (int c0 = 0; c0 < C; c0 += 8) {
    const int cc = C - c0 < 8 ? C - c0 : 8;
    int err = 0;
    switch (cc) {
      case 1: err = launch<1>(A, X, Y, R, K, C, c0, st); break;
      case 2: err = launch<2>(A, X, Y, R, K, C, c0, st); break;
      case 3: err = launch<3>(A, X, Y, R, K, C, c0, st); break;
      case 4: err = launch<4>(A, X, Y, R, K, C, c0, st); break;
      case 5: err = launch<5>(A, X, Y, R, K, C, c0, st); break;
      case 6: err = launch<6>(A, X, Y, R, K, C, c0, st); break;
      case 7: err = launch<7>(A, X, Y, R, K, C, c0, st); break;
      default: err = launch<8>(A, X, Y, R, K, C, c0, st); break;
    }
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
