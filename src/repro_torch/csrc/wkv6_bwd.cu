// RWKV-6 WKV backward for Hopper (sm_90a).
//
// Replaces the gradient that `jax` derives by autodiff of
// repro/models/rwkv.py::wkv6_chunked, the recurrence every RWKV layer's
// training forward runs: the reference has no backward kernel, and
// repro/kernels/wkv6.py::wkv6_pallas none either.  The forward is
// csrc/wkv6.cu; kernels/wkv6.py::Wkv6Fn launches one after the other.
// For each row bh = (b, h), from S_0 (given, or zero), with the decays
// clamped to w >= 1e-12 as the reference's log clamps them:
//
//     o_t = r_tᵀ (S_t + (u ⊙ k_t) v_tᵀ),   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
//
// Given the output's cotangent do and the final state's dS_T (or zero),
// D_T = dS_T and D_t = diag(w_t) D_{t+1} + r_t do_tᵀ:
//
//     dr_t = S_t do_t + u ⊙ k_t (v_t · do_t)
//     dk_t = D_{t+1} v_t + u ⊙ r_t (v_t · do_t)
//     dv_t = D_{t+1}ᵀ k_t + (r_t · (u ⊙ k_t)) do_t
//     dw_t = Σ_v S_t ⊙ D_{t+1}   (0 where w_t < 1e-12)
//     du_h = Σ_{b,t} r_t ⊙ k_t (v_t · do_t),   dS_0 = D_0
//
// dw is taken in this direct form, which needs S_t and D_{t+1} at the same
// step and holds at any decay; the cheaper form through reverse cumulative
// sums divides by w_t and loses float32 accuracy at strong decays.
//
// r, k, w (BH, T, K), v and do (BH, T, V) in the input type (float or
// bf16); u (H, K) float indexed by head; S_0, dS_T (BH, K, V) float or
// null.  Writes dr, dk, dv, dw in the input type, du's per-row partials
// (BH, K) float (the wrapper sums them over the batch in a fixed order,
// so nothing here needs atomics) and dS_0 (BH, K, V) float.  Every sum
// runs in a fixed order: repeated calls give the same bits.
//
// What bounds it on this card: the work is about 12 K V float32
// operations per (bh, t) -- the state step, dr, the D step, dk, dv and dw,
// 2 K V each -- outside the tensor cores, against 2 (3 K + 2 V) bytes of
// bf16 input and as many of output; so at K = V = 64 it is bound by
// operations (a long sequence B 1 x H 64 x T 4096: 12.9 GFLOP, 0.19 ms at
// 67 TFLOP/s).  The recurrence is sequential in t, so a row's steps run in
// one block, and the rows (B x H) are the only parallelism.
//
// Design (a simple kernel that is right first; a tensor-core chunked form
// is later work): one block per row bh holds the whole state, the head
// size padded to KK (64 or 128) and the columns to VV (64 or 128) with
// zero r, k, v, do and a decay of 1, which leave the padded entries 0.
// 4 KK threads: warp (row block rb, column quarter g), lane = the state
// row within the row block, NC = VV / 4 columns a thread, so the state S
// and the cotangent state D live in registers, NC entries a thread.
//   1. A forward sweep steps S through the sequence and writes it at every
//      chunk start to a float32 scratch, ck (BH, n_chunks, KK, VV).
//   2. The reverse sweep takes the chunks from the last: it loads the
//      chunk's inputs into shared memory, reloads S from its checkpoint and
//      steps it through the chunk, keeping every S_t in shared memory (128
//      KB, which sets the chunk: 8 steps at KK = VV = 64), then walks the
//      chunk backwards: per step each thread forms its row's partial sums
//      of S_t do_t, D_{t+1} v_t and S_t ⊙ D_{t+1} over its NC columns and
//      its NC terms of D_{t+1}ᵀ k_t, which a transpose-reduce (the lanes
//      halve the columns at each shuffle level) sums over the warp's 32
//      rows, one column a lane, in NC shuffles; then D steps back.  After
//      the chunk, one barrier, and the threads sum the partials over the
//      column quarters and row blocks in a fixed order, add the bonus
//      terms, apply the clamp's mask to dw and store the chunk's outputs.
// Time steps past T are padded as above and write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HIST_BYTES = 128 * 1024;   // a chunk's states
constexpr int K_MAX = 128;
constexpr int V_MAX = 128;
constexpr float W_MIN = 1e-12f;

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

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// The block's shape for a head padded to KK and columns padded to VV, and
// its shared arrays in floats (kernels/plan.py::_wkv6_bwd_smem).
template <int KK, int VV>
struct Cfg {
  static constexpr int NT = 4 * KK;         // threads
  static constexpr int NC = VV / 4;         // state columns a thread
  static constexpr int RB = KK / 32;        // row blocks (warps a quarter)
  static constexpr int C = HIST_BYTES / (4 * KK * VV);   // steps a chunk
  static constexpr int HIST = C * KK * VV;
  static constexpr int IN = C * (3 * KK + 2 * VV + 2);
  static constexpr int PART = C * (3 * 4 * KK + RB * VV);
  static constexpr int SMEM = HIST + IN + PART + KK;
  static_assert(C >= 1 && C <= NT / 32, "a warp a step for the dots");
};

// q[0..N) summed over the warp's 32 lanes.  At each shuffle level the
// lanes of a pair split their columns, the lane whose bit O is set keeping
// the upper half; after the N > 1 levels lane l holds column l >> (5 -
// log2 N) in q[0], and the levels left sum the lanes that share it.
template <int N, int O, int NQ>
__device__ __forceinline__ void halve(float (&q)[NQ], int lane) {
  if constexpr (N > 1) {
    const bool up = lane & O;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = up ? q[j] : q[j + N / 2];
      const float keep = up ? q[j + N / 2] : q[j];
      q[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    halve<N / 2, O / 2>(q, lane);
  } else if constexpr (O >= 1) {
    q[0] += __shfl_xor_sync(0xffffffffu, q[0], O);
    halve<1, O / 2>(q, lane);
  }
}

template <typename T, int KK, int VV>
__global__ void __launch_bounds__(4 * KK, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const T* __restrict__ dout, const float* __restrict__ dsT,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ck, int H,
                int T_len, int K, int V) {
  using G = Cfg<KK, VV>;
  constexpr int NT = G::NT, NC = G::NC, RB = G::RB, C = G::C;
  constexpr int SH = 5 - log2i(NC);          // a reduced column's lane shift
  extern __shared__ __align__(16) float sm[];
  float* hist = sm;                          // [C][NC][NT]: S_t
  float* sr = hist + G::HIST;                // [C][KK]
  float* sk = sr + C * KK;                   // [C][KK]
  float* sw = sk + C * KK;                   // [C][KK] raw decays
  float* sv = sw + C * KK;                   // [C][VV]
  float* sdo = sv + C * VV;                  // [C][VV]
  float* vdo = sdo + C * VV;                 // [C] v_t · do_t
  float* ruk = vdo + C;                      // [C] r_t · (u ⊙ k_t)
  float* pr = ruk + C;                       // [C][4][KK] S_t do_t
  float* pk = pr + C * 4 * KK;               // [C][4][KK] D_{t+1} v_t
  float* pw = pk + C * 4 * KK;               // [C][4][KK] Σ S_t ⊙ D_{t+1}
  float* pv = pw + C * 4 * KK;               // [C][RB][VV] D_{t+1}ᵀ k_t
  float* su = pv + C * RB * VV;              // [KK]

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rb = wid % RB, g = wid / RB;
  const int row = rb * 32 + lane;            // the state row (k index)
  const int c0 = g * NC;                     // the thread's first column
  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int nc = (T_len + C - 1) / C;
  const bool row_ok = row < K;
  const long long srow = (bh * K + row) * (long long)V;   // S[row, 0]

  for (int i = tid; i < KK; i += NT) su[i] = i < K ? u[(long long)h * K + i]
                                                   : 0.f;
  float S[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    S[j] = s0 != nullptr && row_ok && c0 + j < V ? s0[srow + c0 + j] : 0.f;

  // chunk c's inputs into shared memory, padded past T and past K, V
  auto load = [&](int c, bool all) {
    const int t0 = c * C;
    for (int i = tid; i < C * KK; i += NT) {
      const int s = i / KK, x = i % KK, t = t0 + s;
      const bool ok = t < T_len && x < K;
      const long long o = (bh * T_len + t) * K + x;
      sk[i] = ok ? to_f(k[o]) : 0.f;
      sw[i] = ok ? to_f(w[o]) : 1.f;
      if (all) sr[i] = ok ? to_f(r[o]) : 0.f;
    }
    for (int i = tid; i < C * VV; i += NT) {
      const int s = i / VV, x = i % VV, t = t0 + s;
      const bool ok = t < T_len && x < V;
      const long long o = (bh * T_len + t) * V + x;
      sv[i] = ok ? to_f(v[o]) : 0.f;
      if (all) sdo[i] = ok ? to_f(dout[o]) : 0.f;
    }
  };
  // S <- diag(w_s) S + k_s v_sᵀ for step s of the loaded chunk
  auto step = [&](int s) {
    const float wc = fmaxf(sw[s * KK + row], W_MIN);
    const float kr = sk[s * KK + row];
    const float* vs = sv + s * VV + c0;
#pragma unroll
    for (int j = 0; j < NC; ++j) S[j] = fmaf(wc, S[j], kr * vs[j]);
  };

  // 1. forward sweep: S at every chunk start to the scratch
  float* ckrow = ck + bh * nc * (long long)(NC * NT);
  for (int c = 0; c < nc; ++c) {
    float* dst = ckrow + (long long)c * NC * NT + tid;
#pragma unroll
    for (int j = 0; j < NC; ++j) dst[j * NT] = S[j];
    if (c == nc - 1) break;
    __syncthreads();                 // the last chunk's inputs are read
    load(c, false);
    __syncthreads();
#pragma unroll 1
    for (int s = 0; s < C; ++s) step(s);
  }

  // 2. reverse sweep, chunk by chunk from the last
  float D[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    D[j] = dsT != nullptr && row_ok && c0 + j < V ? dsT[srow + c0 + j] : 0.f;
  float du_acc = 0.f;                        // row tid's du (tid < KK)
  for (int c = nc - 1; c >= 0; --c) {
    __syncthreads();                 // the last chunk's arrays are read
    load(c, true);
    const float* src = ckrow + (long long)c * NC * NT + tid;
#pragma unroll
    for (int j = 0; j < NC; ++j) S[j] = src[j * NT];
    __syncthreads();
    if (wid < C) {                   // warp s: step s's two dot products
      const int s = wid;
      float a = 0.f, b = 0.f;
      for (int x = lane; x < VV; x += 32)
        a = fmaf(sv[s * VV + x], sdo[s * VV + x], a);
      for (int x = lane; x < KK; x += 32)
        b = fmaf(sr[s * KK + x] * su[x], sk[s * KK + x], b);
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane == 0) {
        vdo[s] = a;
        ruk[s] = b;
      }
    }
    // the chunk's states S_t, each thread its own entries
#pragma unroll 1
    for (int s = 0; s < C; ++s) {
      float* hs = hist + s * NC * NT + tid;
#pragma unroll
      for (int j = 0; j < NC; ++j) hs[j * NT] = S[j];
      if (s + 1 < C) step(s);
    }
    // backwards through the chunk: D holds D_{t+1}
#pragma unroll 1
    for (int s = C - 1; s >= 0; --s) {
      const float wc = fmaxf(sw[s * KK + row], W_MIN);
      const float rr = sr[s * KK + row], kr = sk[s * KK + row];
      const float* hs = hist + s * NC * NT + tid;
      const float* vs = sv + s * VV + c0;
      const float* ds = sdo + s * VV + c0;
      float a_r = 0.f, a_k = 0.f, a_w = 0.f, q[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float sj = hs[j * NT], dj = D[j], vj = vs[j], oj = ds[j];
        a_r = fmaf(sj, oj, a_r);
        a_k = fmaf(dj, vj, a_k);
        a_w = fmaf(sj, dj, a_w);
        q[j] = dj * kr;
        D[j] = fmaf(wc, dj, rr * oj);
      }
      const int p = (s * 4 + g) * KK + row;
      pr[p] = a_r;
      pk[p] = a_k;
      pw[p] = a_w;
      halve<NC, 16>(q, lane);
      if ((lane & ((1 << SH) - 1)) == 0)
        pv[(s * RB + rb) * VV + c0 + (lane >> SH)] = q[0];
    }
    __syncthreads();
    // the chunk's outputs: partial sums in a fixed order, bonus terms
    const int t0 = c * C;
    for (int i = tid; i < C * KK; i += NT) {
      const int s = i / KK, x = i % KK, t = t0 + s;
      if (t >= T_len || x >= K) continue;
      float a_r = 0.f, a_k = 0.f, a_w = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        a_r += pr[(s * 4 + q4) * KK + x];
        a_k += pk[(s * 4 + q4) * KK + x];
        a_w += pw[(s * 4 + q4) * KK + x];
      }
      const float ux = su[x], vd = vdo[s];
      const long long o = (bh * T_len + t) * K + x;
      dr[o] = from_f<T>(a_r + ux * sk[i] * vd);
      dk[o] = from_f<T>(a_k + ux * sr[i] * vd);
      dw[o] = from_f<T>(sw[i] >= W_MIN ? a_w : 0.f);
    }
    for (int i = tid; i < C * VV; i += NT) {
      const int s = i / VV, x = i % VV, t = t0 + s;
      if (t >= T_len || x >= V) continue;
      float a = 0.f;
#pragma unroll
      for (int b = 0; b < RB; ++b) a += pv[(s * RB + b) * VV + x];
      dv[(bh * T_len + t) * V + x] = from_f<T>(a + ruk[s] * sdo[i]);
    }
    if (tid < KK) {
      for (int s = C - 1; s >= 0; --s)
        du_acc = fmaf(sr[s * KK + tid] * sk[s * KK + tid], vdo[s], du_acc);
    }
  }
  if (ds0 != nullptr && row_ok) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (c0 + j < V) ds0[srow + c0 + j] = D[j];
  }
  if (tid < K) du_part[bh * K + tid] = du_acc;
}

template <typename T, int KK, int VV>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, const void* dout,
           const float* dsT, void* dr, void* dk, void* dv, void* dw,
           float* du_part, float* ds0, float* ck, int BH, int H, int T_len,
           int K, int V, int chunk, int n_chunks, int threads, int smem,
           int per_sm, cudaStream_t st) {
  using G = Cfg<KK, VV>;
  const size_t bytes = sizeof(float) * (size_t)G::SMEM;
  if (chunk != G::C || n_chunks != (T_len + G::C - 1) / G::C ||
      threads != G::NT || (size_t)smem != bytes)
    return (int)cudaErrorInvalidValue;
  auto kern = wkv6_bwd_kernel<T, KK, VV>;
  // the attribute and the residency, looked up once per instantiation
  static int resident = -1;
  if (resident < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          G::NT, bytes);
    if (err != cudaSuccess) return (int)err;
    resident = blocks;
  }
  if (resident < per_sm) return (int)cudaErrorInvalidConfiguration;
  kern<<<BH, G::NT, bytes, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<const T*>(dout), dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw),
      du_part, ds0, ck, H, T_len, K, V);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int kk, int vv, const void* r, const void* k, const void* v,
        const void* w, const float* u, const float* s0, const void* dout,
        const float* dsT, void* dr, void* dk, void* dv, void* dw,
        float* du_part, float* ds0, float* ck, int BH, int H, int T_len,
        int K, int V, int chunk, int n_chunks, int threads, int smem,
        int per_sm, cudaStream_t st) {
#define REPRO_WKV6_BWD(KK_, VV_)                                            \
  return launch<T, KK_, VV_>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, \
                             du_part, ds0, ck, BH, H, T_len, K, V, chunk,  \
                             n_chunks, threads, smem, per_sm, st)
  if (kk == 64 && vv == 64) REPRO_WKV6_BWD(64, 64);
  if (kk == 128 && vv == 64) REPRO_WKV6_BWD(128, 64);
  if (kk == 64 && vv == 128) REPRO_WKV6_BWD(64, 128);
  if (kk == 128 && vv == 128) REPRO_WKV6_BWD(128, 128);
#undef REPRO_WKV6_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The WKV6 backward over BH = B * H rows: r, k, w (BH, T, K), v and dout
// (BH, T, V) in the input type (`types` 0 = float, 1 = bf16), u (H, K)
// float (row bh uses head bh % H), s0 and dsT (BH, K, V) float or null for
// zeros; writes dr, dk, dw (BH, T, K) and dv (BH, T, V) in the input type,
// du_part (BH, K) and, unless null, ds0 (BH, K, V) float, using ck
// (BH, n_chunks, kk, vv) float as scratch.  All contiguous.  K must be a
// multiple of 8 up to 128, V at most 128.  The launch runs on the plan of
// kernels/plan.py's wkv6_bwd_plan: the padded sizes `kk` and `vv`, the
// `chunk` steps a chunk and `n_chunks`, the block's `threads` and shared
// bytes `smem`, and the residency `per_sm`, which the card must hold.
int repro_wkv6_bwd(int types, const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0,
                   const void* dout, const float* dsT, void* dr, void* dk,
                   void* dv, void* dw, float* du_part, float* ds0, float* ck,
                   int BH, int H, int T_len, int K, int V, int kk, int vv,
                   int chunk, int n_chunks, int threads, int smem,
                   int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || V <= 0) return 0;
  if (K <= 0 || K % 8 || K > K_MAX || V > V_MAX || H <= 0 || BH % H ||
      BH > 65535 || T_len < 0 || per_sm < 1 ||
      kk != (K <= 64 ? 64 : 128) || vv != (V <= 64 ? 64 : 128))
    return (int)cudaErrorInvalidValue;
  switch (types) {
    case 0:
      return run<float>(kk, vv, r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw,
                        du_part, ds0, ck, BH, H, T_len, K, V, chunk,
                        n_chunks, threads, smem, per_sm, st);
    case 1:
      return run<__nv_bfloat16>(kk, vv, r, k, v, w, u, s0, dout, dsT, dr, dk,
                                dv, dw, du_part, ds0, ck, BH, H, T_len, K, V,
                                chunk, n_chunks, threads, smem, per_sm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
