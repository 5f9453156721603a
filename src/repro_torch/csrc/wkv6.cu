// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv6.py::wkv6_pallas (_wkv6_kernel), and the
// model's plain twin repro/models/rwkv.py::wkv6_chunked that every RWKV
// layer runs (forward, prefill, and -- with an initial state and T = 1 --
// the one-token decode step).  For each row bh = (b, h) of the flattened
// batch-head axis, from S_0 (given, or zero):
//
//     o_t     = r_tᵀ (S_t + (u_h ⊙ k_t) v_tᵀ)
//     S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
//
// r, k, w (BH, T, K) and v (BH, T, V) in the input type (float or bf16),
// u (H, K) float indexed by head, S (BH, K, V) float; o (BH, T, V) in the
// input type; the final state S_T is always written.  float32 throughout.
//
// Why the sequential recurrence and not the TPU's chunked form: the Pallas
// kernel telescopes the decays through exp(-cumsum(log w)) inside a chunk
// so that the chunk is two MXU matmuls.  That overflows float32 once a
// chunk's mean log w falls below about -1.39 (w < 0.25 at chunk 64): the
// growth factor goes to inf, its partner to 0, and the product to NaN.
// The step-by-step recurrence multiplies by w_t in (0, 1) only, so it is
// right at any decay; the chunked tensor-core form is later work.
//
// What bounds it on this card: per (bh, t) about 6 K V float32 operations
// (k v, u k v + S, r (.), w S + k v) against 2 (3 K + V) bytes of bf16
// input and 2 V of output: at K = V = 64, ~38 FLOP per byte, above the
// float32 ridge of 67e12 / 3.35e12 = 20.  A long prefill (B 1, H 64,
// T 4096) is bound by operations (~6.4 GFLOP, ~0.1 ms at 67 TFLOP/s); a
// decode step (T 1) by reading and writing the float32 state (8 MB at
// B 4); the serving prefill (T 32) moves a few MB and is bound by launch
// latency in practice.  The time axis is sequential: the TPU's sequential
// grid axis becomes a loop inside the block.
//
// Design: one block per (bh, 32 state columns); the thread (c, p), with
// threadIdx.x = c * KP + p and KP = K / 8, owns rows [8p, 8p + 8) of
// column c of S in registers for the whole sequence, so S never leaves
// the SM between steps.  Time is walked in chunks of TC steps: the block
// stages the chunk's r, k, w rows and its v columns into shared memory
// (coalesced, converted to float once), synchronises, then every thread
// runs the TC steps from shared memory with no global access on the
// critical path; each step's partial dot products over a thread's 8 rows
// are summed over the KP lanes of a column with xor shuffles, and the
// chunk's outputs are written back coalesced from a shared buffer.  The
// initial state is read and the final state written by the owning thread
// only, so S_0 and S_T may alias (an in-place decode).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KS = 8;       // state rows one thread owns (of one column)
constexpr int VB = 32;      // state columns per block
constexpr int TC = 32;      // time steps staged per chunk
constexpr int K_MAX = 128;  // KP = K / KS <= 16 lanes, 512 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void wkv6_kernel(const T* __restrict__ R, const T* __restrict__ Kx,
                            const T* __restrict__ Vx,
                            const T* __restrict__ W,
                            const float* __restrict__ U, const float* S0,
                            T* __restrict__ O, float* ST, int H, int T_len,
                            int K, int V, int KP) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;               // [TC][K]
  float* ks = rs + TC * K;        // [TC][K]
  float* ws = ks + TC * K;        // [TC][K]
  float* vs = ws + TC * K;        // [TC][VB]
  float* os = vs + TC * VB;       // [TC][VB]

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int v0 = blockIdx.x * VB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = tid / KP, p = tid % KP;
  const int col = v0 + c;
  const bool live = col < V;
  const int k0 = p * KS;
  const size_t sbase = (size_t)bh * K * V;

  float s[KS], u[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    u[i] = U[(size_t)h * K + k0 + i];
    s[i] = (S0 != nullptr && live) ? S0[sbase + (size_t)(k0 + i) * V + col]
                                   : 0.f;
  }
  const T* r = R + (size_t)bh * T_len * K;
  const T* kk = Kx + (size_t)bh * T_len * K;
  const T* w = W + (size_t)bh * T_len * K;
  const T* vv = Vx + (size_t)bh * T_len * V;
  T* o = O + (size_t)bh * T_len * V;

  for (int t0 = 0; t0 < T_len; t0 += TC) {
    const int tc = min(TC, T_len - t0);
    // stage the chunk (the previous chunk's compute and write-back are
    // behind the barrier at the end of the last iteration).  The block has
    // 4 K threads, so each stages TC / 4 entries of r, k and w; all its
    // loads are issued before its first store, one memory round trip per
    // chunk rather than one per entry.
    const size_t g0 = (size_t)t0 * K;
    float ra[TC / 4], ka[TC / 4], wa[TC / 4];
#pragma unroll
    for (int j = 0; j < TC / 4; ++j) {
      const int i = tid + j * nthr;
      const bool ok = i < tc * K;
      ra[j] = ok ? to_f(r[g0 + i]) : 0.f;
      ka[j] = ok ? to_f(kk[g0 + i]) : 0.f;
      wa[j] = ok ? to_f(w[g0 + i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TC / 4; ++j) {
      const int i = tid + j * nthr;
      if (i < tc * K) {
        rs[i] = ra[j];
        ks[i] = ka[j];
        ws[i] = wa[j];
      }
    }
#pragma unroll 4
    for (int i = tid; i < tc * VB; i += nthr) {
      const int tt = i / VB, cc = i % VB;
      vs[i] = (v0 + cc < V) ? to_f(vv[(size_t)(t0 + tt) * V + v0 + cc])
                            : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const float vt = vs[tt * VB + c];
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * K + k0);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * K + k0);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * K + k0);
      float rt[KS], kt[KS], wt[KS];
#pragma unroll
      for (int q = 0; q < KS / 4; ++q) {
        const float4 a = r4[q], b = k4[q], d = w4[q];
        rt[4 * q] = a.x; rt[4 * q + 1] = a.y;
        rt[4 * q + 2] = a.z; rt[4 * q + 3] = a.w;
        kt[4 * q] = b.x; kt[4 * q + 1] = b.y;
        kt[4 * q + 2] = b.z; kt[4 * q + 3] = b.w;
        wt[4 * q] = d.x; wt[4 * q + 1] = d.y;
        wt[4 * q + 2] = d.z; wt[4 * q + 3] = d.w;
      }
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const float kv = kt[i] * vt;
        acc = fmaf(rt[i], fmaf(u[i], kv, s[i]), acc);
        s[i] = fmaf(wt[i], s[i], kv);
      }
      // the KP lanes of one column are adjacent and KP divides 32
      for (int off = 1; off < KP; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (p == 0) os[tt * VB + c] = acc;
    }
    __syncthreads();
    for (int i = tid; i < tc * VB; i += nthr) {
      const int tt = i / VB, cc = i % VB;
      if (v0 + cc < V) o[(size_t)(t0 + tt) * V + v0 + cc] = from_f<T>(os[i]);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < KS; ++i) ST[sbase + (size_t)(k0 + i) * V + col] = s[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* o, float* sT, int BH,
           int H, int T_len, int K, int V, cudaStream_t st) {
  const int KP = K / KS;
  const size_t smem = sizeof(float) * (3 * (size_t)TC * K + 2 * TC * VB);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((V + VB - 1) / VB, BH);
  wkv6_kernel<T><<<grid, KP * VB, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(o), sT, H, T_len, K, V, KP);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// WKV6 over BH = B * H rows: r, k, w (BH, T, K) and v (BH, T, V) in the
// input type (`types` 0 = float, 1 = bf16), u (H, K) float (row bh uses
// head bh % H), s0 (BH, K, V) float or null for zeros; writes o (BH, T, V)
// in the input type and sT (BH, K, V) float.  All contiguous.  K must be a
// multiple of 8 and at most 128 (the wrapper checks); BH at most 65535.
int repro_wkv6(int types, const void* r, const void* k, const void* v,
               const void* w, const float* u, const float* s0, void* o,
               float* sT, int BH, int H, int T_len, int K, int V,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || V <= 0) return 0;
  if (K <= 0 || K % KS || K > K_MAX || H <= 0 || BH % H || BH > 65535 ||
      T_len < 0)
    return (int)cudaErrorInvalidValue;
  switch (types) {
    case 0:
      return launch<float>(r, k, v, w, u, s0, o, sT, BH, H, T_len, K, V, st);
    case 1:
      return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, BH, H, T_len, K,
                                   V, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
