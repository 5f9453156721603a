// Counter-derived MDS parity for Hopper (sm_90a): the virtual-parity
// generator and the fused generated-parity product.
//
// Replaces repro/kernels/mds_encode.py::
//   * counter_parity_rows_pallas (_rows_kernel, _parity_tile) -- parity
//     generator rows R[ctrs] from packed (row | draw << 24) counters, and
//   * gen_parity_matvec_pallas (_gen_matvec_kernel) -- y = R_gen @ (W @ x)
//     with the encoded parity rows WR never stored.
//
// Every entry is two threefry2x32-20 calls, four 24-bit uniforms summed in
// the fixed order (u(a0)+u(a1)) + (u(b0)+u(b1)) - 2, times sqrt(3/L)
// (repro/core/mds.py:81-149).  The rows must be bit-identical to the host
// derivation, so the arithmetic uses uint32 wrap-around, the exact
// (bits >> 8) -> float conversion, and explicitly rounded single-precision
// intrinsics (__fadd_rn/__fmul_rn), which the compiler never contracts
// into FMAs.
//
// What bounds them on this card: ~160 integer ALU operations per generated
// entry against 4 bytes written (counter rows) or a 2*C-FLOP contraction
// (fused product) -- both are bound by the integer pipes, not by HBM.  The
// contraction's float64 instantiation (the serving default: its products
// feed a decode) adds C double FMAs per entry, well under the threefry
// cost.
//
// Design.  counter_parity_rows takes an explicit column-index operand, so
// decode minors derive only the columns they need (R[par, unk],
// R[par, known]) instead of whole rows; each thread derives a column for 8
// rows, stores coalesced along the row.  The fused product gets WX = W @ X
// precomputed once per call by the coded_matvec kernel (the Pallas kernel
// recomputed W_tile @ x in every row block); each block then owns 8 parity
// rows, its threads stride over the L columns deriving R entries in
// registers and contracting them against WX rows read through L2, and the
// per-row sums are reduced across the block.  R never touches memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r); \
  x1 ^= x0;
  // rotations (13,15,26,6) on even groups, (17,29,16,24) on odd groups;
  // key schedule (k1, ks2, k0) injected after every 4 rounds
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += ks2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += ks2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += ks2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += ks2; x1 += k0 + 5u;
#undef TF_ROUND
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  // (bits >> 8) < 2^24 converts exactly; the 2^-24 scale is exact too
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ float parity_entry(uint32_t k0, uint32_t k1,
                                              uint32_t ctr, uint32_t col,
                                              float scale) {
  uint32_t a0, a1, b0, b1;
  threefry2x32(k0, k1, ctr, col * 2u, a0, a1);
  threefry2x32(k0, k1, ctr, col * 2u + 1u, b0, b1);
  const float g = __fsub_rn(
      __fadd_rn(__fadd_rn(uniform24(a0), uniform24(a1)),
                __fadd_rn(uniform24(b0), uniform24(b1))),
      2.0f);
  return __fmul_rn(g, scale);
}

constexpr int ROWS_PER_THREAD = 8;

__global__ void __launch_bounds__(256)
counter_rows_kernel(uint32_t k0, uint32_t k1, float scale,
                    const uint32_t* __restrict__ ctrs, int n,
                    const uint32_t* __restrict__ cols, int m,
                    float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const uint32_t col = cols[j];
  const int r0 = blockIdx.y * ROWS_PER_THREAD;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int i = r0 + r;
    if (i < n)
      out[(size_t)i * m + j] = parity_entry(k0, k1, ctrs[i], col, scale);
  }
}

constexpr int GP_ROWS = 8, GP_THREADS = 256, GP_WARPS = GP_THREADS / 32;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// T is the type of WX, of the accumulator and of Y.  With T = double each
// float32 R entry is widened exactly and contracted against the float64
// WX in double: the products feed an MDS decode, which would amplify any
// float32 rounding they carried.
template <typename T, int CC>
__global__ void __launch_bounds__(GP_THREADS)
gen_parity_kernel(uint32_t k0, uint32_t k1, float scale,
                  const uint32_t* __restrict__ ctrs, int n,
                  const T* __restrict__ WX, int L, T* __restrict__ Y) {
  __shared__ T red[GP_WARPS][GP_ROWS * CC];
  const int r0 = blockIdx.x * GP_ROWS;
  const int nr = min(GP_ROWS, n - r0);          // rows of this block
  uint32_t ctr[GP_ROWS];
#pragma unroll
  for (int r = 0; r < GP_ROWS; ++r) ctr[r] = r < nr ? ctrs[r0 + r] : 0u;
  T acc[GP_ROWS][CC];
#pragma unroll
  for (int r = 0; r < GP_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = T(0);

  for (int j = threadIdx.x; j < L; j += GP_THREADS) {
    T wx[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) wx[c] = WX[(size_t)j * CC + c];
#pragma unroll
    for (int r = 0; r < GP_ROWS; ++r) {
      if (r < nr) {                               // uniform across the block
        const T v = T(parity_entry(k0, k1, ctr[r], (uint32_t)j, scale));
#pragma unroll
        for (int c = 0; c < CC; ++c) acc[r][c] = fma_t(v, wx[c], acc[r][c]);
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < GP_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      T v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * CC + c] = v;
    }
  __syncthreads();
  for (int t = threadIdx.x; t < GP_ROWS * CC; t += GP_THREADS) {
    const int r = t / CC;
    if (r >= nr) continue;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < GP_WARPS; ++w) s += red[w][t];
    Y[(size_t)(r0 + r) * CC + (t % CC)] = s;
  }
}

template <typename T, int CC>
int launch_gen(uint32_t k0, uint32_t k1, float scale, const uint32_t* ctrs,
               int n, const T* WX, int L, T* Y, cudaStream_t st) {
  const int blocks = (n + GP_ROWS - 1) / GP_ROWS;
  gen_parity_kernel<T, CC><<<blocks, GP_THREADS, 0, st>>>(k0, k1, scale,
                                                         ctrs, n, WX, L, Y);
  return (int)cudaGetLastError();
}

template <typename T>
int contract(uint32_t k0, uint32_t k1, float scale, const uint32_t* ctrs,
             int n, const void* WXv, int L, int C, void* Yv,
             cudaStream_t st) {
  const T* WX = static_cast<const T*>(WXv);
  T* Y = static_cast<T*>(Yv);
  switch (C) {
    case 1: return launch_gen<T, 1>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 2: return launch_gen<T, 2>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 3: return launch_gen<T, 3>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 4: return launch_gen<T, 4>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 5: return launch_gen<T, 5>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 6: return launch_gen<T, 6>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 7: return launch_gen<T, 7>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    case 8: return launch_gen<T, 8>(k0, k1, scale, ctrs, n, WX, L, Y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (n, m) float32: out[i, j] = R(ctrs[i], cols[j]).
int repro_counter_parity_rows(uint32_t k0, uint32_t k1, float scale,
                              const uint32_t* ctrs, int n,
                              const uint32_t* cols, int m, float* out,
                              void* stream) {
  if (n <= 0 || m <= 0) return 0;
  dim3 grid((m + 255) / 256, (n + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  counter_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, scale, ctrs, n, cols, m, out);
  return (int)cudaGetLastError();
}

// Y (n, C) = R(ctrs, 0..L-1) @ WX, WX (L, C) row-major, 1 <= C <= 8;
// `f64` selects float64 WX, accumulation and Y (else float32 throughout).
int repro_gen_parity_contract(int f64, uint32_t k0, uint32_t k1, float scale,
                              const uint32_t* ctrs, int n, const void* WX,
                              int L, int C, void* Y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  return f64 ? contract<double>(k0, k1, scale, ctrs, n, WX, L, C, Y, st)
             : contract<float>(k0, k1, scale, ctrs, n, WX, L, C, Y, st);
}

}  // extern "C"
