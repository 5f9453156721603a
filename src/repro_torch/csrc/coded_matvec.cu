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
// far below the ridge.  It is bound by reading A from HBM once: at the
// llama3.2-1b head (R ~ 128512, K = 2048, float) ~1.05 GB, ~0.31 ms at
// 3.35 TB/s; the wider accumulator adds no bytes.
//
// Design: X is staged once per block into shared memory, transposed to
// [c][k] so that each lane's 16-byte read of X is conflict-free, and the
// block then streams rows of A with 16-byte coalesced loads (each warp owns
// 4 rows and keeps 4 loads in flight per lane), reducing each row with warp
// shuffles.  Blocks are persistent (one wave: as many per SM as registers
// and the X slab allow, shared out over the tasks of gridDim.y) and walk
// row groups, so X is staged once per block, not once per row tile as on
// the TPU grid.  A K longer than the shared-memory slab is walked in
// slabs, restaged per row group.  C > 8 is split into column chunks by the
// host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, RPW = 4, THREADS = WARPS * 32;
constexpr int ROWS_PER_GROUP = WARPS * RPW;
constexpr int SMEM_BYTES = 96 * 1024;

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

template <typename TI, typename TA, int CC>
__global__ void __launch_bounds__(THREADS)
coded_matvec_kernel(const TI* __restrict__ A, const TI* __restrict__ X,
                    TA* __restrict__ Y, int R, int K, int C, int c0,
                    int KT) {
  using V = typename Vec16<TI>::type;
  constexpr int NV = 16 / sizeof(TI);      // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  TI* xs = reinterpret_cast<TI*>(smem);    // [CC][KT]
  const V* xsv = reinterpret_cast<const V*>(smem);
  const int task = blockIdx.y;
  A += (size_t)task * R * K;
  X += (size_t)task * K * C;
  Y += (size_t)task * R * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_groups = (R + ROWS_PER_GROUP - 1) / ROWS_PER_GROUP;
  const bool single = KT >= K;
  const int KTV = KT / NV;

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
    TA acc[RPW][CC];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = TA(0);
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kt = min(KT, K - k0);
      if (!single) {
        __syncthreads();
        stage(k0, kt);
        __syncthreads();
      }
      for (int q = lane; q < kt / NV; q += 32) {
        V a[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int row = rbase + r;
          a[r] = row < R ? __ldcs(reinterpret_cast<const V*>(
                                      A + (size_t)row * K + k0) + q)
                         : V{};
        }
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const V xv = xsv[c * KTV + q];
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int e = 0; e < NV; ++e)
              acc[r][c] = fma_t(TA(vget(a[r], e)), TA(vget(xv, e)),
                                acc[r][c]);
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
      const int row = rbase + r;
      if (row < R && lane < CC) {
        TA v = TA(0);
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (c == lane) v = acc[r][c];
        Y[(size_t)row * C + c0 + lane] = v;
      }
    }
  }
}

template <typename TI, typename TA, int CC>
int launch(const TI* A, const TI* X, TA* Y, int B, int R, int K, int C,
           int c0, cudaStream_t st) {
  constexpr int NV = 16 / sizeof(TI);
  int KT = SMEM_BYTES / (CC * (int)sizeof(TI));
  KT = (KT / NV) * NV;
  if (KT > K) KT = K;
  const size_t smem = (size_t)CC * KT * sizeof(TI);
  cudaError_t err = cudaFuncSetAttribute(
      coded_matvec_kernel<TI, TA, CC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // one wave of persistent blocks: as many as fit on the card at once
  // (registers and the X slab bound it), shared out over the tasks
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, coded_matvec_kernel<TI, TA, CC>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int n_groups = (R + ROWS_PER_GROUP - 1) / ROWS_PER_GROUP;
  int per_task = (per_sm * sms + B - 1) / B;
  if (per_task > n_groups) per_task = n_groups;
  dim3 grid(per_task, B);
  coded_matvec_kernel<TI, TA, CC><<<grid, THREADS, smem, st>>>(
      A, X, Y, R, K, C, c0, KT);
  return (int)cudaGetLastError();
}

template <typename TI, typename TA>
int run(const void* A, const void* X, void* Y, int B, int R, int K, int C,
        int c0, cudaStream_t st) {
  const TI* a = static_cast<const TI*>(A);
  const TI* x = static_cast<const TI*>(X);
  TA* y = static_cast<TA*>(Y);
  switch (C - c0 < 8 ? C - c0 : 8) {
    case 1: return launch<TI, TA, 1>(a, x, y, B, R, K, C, c0, st);
    case 2: return launch<TI, TA, 2>(a, x, y, B, R, K, C, c0, st);
    case 3: return launch<TI, TA, 3>(a, x, y, B, R, K, C, c0, st);
    case 4: return launch<TI, TA, 4>(a, x, y, B, R, K, C, c0, st);
    case 5: return launch<TI, TA, 5>(a, x, y, B, R, K, C, c0, st);
    case 6: return launch<TI, TA, 6>(a, x, y, B, R, K, C, c0, st);
    case 7: return launch<TI, TA, 7>(a, x, y, B, R, K, C, c0, st);
    default: return launch<TI, TA, 8>(a, x, y, B, R, K, C, c0, st);
  }
}

}  // namespace

extern "C" {

// Y (B, R, C) = A (B, R, K) @ X (B, K, C), row-major and contiguous per
// task: one kernel launch computes the columns [c0, min(c0 + 8, C)), so the
// caller loops over 8-column chunks.  `types` selects the instantiation:
// 0 = float in, float out; 1 = float in, double accumulation and out;
// 2 = double in and out.  K must be a multiple of the 16-byte vector width
// and A 16-byte aligned (the wrapper checks both).
int repro_coded_matvec(int types, const void* A, const void* X, void* Y,
                       int B, int R, int K, int C, int c0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || R <= 0 || c0 < 0 || c0 >= C) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  switch (types) {
    case 0: return run<float, float>(A, X, Y, B, R, K, C, c0, st);
    case 1: return run<float, double>(A, X, Y, B, R, K, C, c0, st);
    case 2: return run<double, double>(A, X, Y, B, R, K, C, c0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
