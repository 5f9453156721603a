// RWKV-6 WKV backward for Hopper (sm_90a).
//
// Replaces the gradient that `jax` derives by autodiff of
// repro/models/rwkv.py::wkv6_chunked, the recurrence every RWKV layer's
// training forward runs: the reference has no backward kernel, and
// repro/kernels/wkv6.py::wkv6_pallas none either.  The forward is
// csrc/wkv6.cu; the wkv6 operator (kernels/wkv6.py) launches one after the other.
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
// null.  Writes dr, dk, dv, dw in the input type, du's partial sums by row
// and chunk (BH, n_chunks, K) float (the wrapper sums them over the batch
// and the chunks in a fixed order, so nothing here needs atomics) and dS_0
// (BH, K, V) float.  Every sum runs in a fixed order: repeated calls give
// the same bits.
//
// What bounds it on this card: the function is about 12 K V float32
// operations per (bh, t) -- the state step, dr, the D step, dk, dv and dw,
// 2 K V each -- against 2 (3 K + 2 V) bytes of bf16 input and as many of
// output.  The route below runs most of them on the TF32 tensor cores
// (each product taken 2 or 3 times for float32 accuracy) and leaves 6 K V
// on the FMA pipe, the direct dw walk; at K = V = 64 in bf16 that walk
// bounds a long sequence (B 1 x H 64 x T 4096: 6.4 GFLOP, 0.096 ms at 67
// TFLOP/s) and the bytes a short one (chip_smoke.py::_wkv6_bwd_bound
// counts both).  The recurrence is
// sequential in t; the design splits it in two levels so that the
// sequential part is short and runs on the tensor cores, and the rest runs
// on every SM at once.
//
// Level 1 (wkv6_bwd_states_kernel), sequential over chunks of C = 16
// steps, in parallel over rows and the two directions: the state at every
// chunk start in forward time and the cotangent state at every chunk end
// in reverse time,
//
//     S_{c+1} = diag(Π_chunk w) S_c     + (K ⊙ G)ᵀ V
//     D_c     = diag(Π_chunk w) D_{c+1} + (R ⊙ F)ᵀ dO
//
// (G_s = Π_{s<τ<C} w_τ, F_s = Π_{0<=τ<s} w_τ inside the chunk; with r for
// k, do for v and time reversed the second is the first), written to a
// float32 scratch (2, BH, n_chunks, kk, vv), and D_0 to dS_0.  This is the
// state half of csrc/wkv6.cu's chunked route with its conventions: the
// product on the TF32 tensor cores (mma.sync m16n8k8), the float32 factor
// split into its TF32 head + tail (and v, do too when they are float32), so
// the states keep float32 accuracy; every decay factor a product of clamped
// decays, each <= 1, never the exp of a cumulative log sum, so a w of 0 or
// below 1e-12 stays finite.  A block of kk / 8 warps owns one direction's
// whole state in its mma accumulators; per chunk two threads of each head
// index turn their halves of the chunk into the factors of the x ⊙ factor
// tile while the other warps stage v or do, the inputs two chunks ahead in
// registers, one barrier a chunk (double-buffered tiles).  The chain of a
// chunk (a load two chunks back, the prep, the barrier, the products, the
// state's store) is what it waits on: ~1.3 us a chunk on an H100.
//
// Level 2 (wkv6_bwd_chunk_kernel), every chunk of every row at once: one
// block of 512 threads per (chunk, row), two an SM, from S_c and D_e =
// D_{c+1}.  With B[t, s] = do_t · v_s, Q[t, s] = Π_{s<τ<t} w_τ and A[t, s]
// = Σ_k r_t k_s Q[t, s]:
//
//     dr_t = F_t ⊙ S_c do_t + Σ_{s<t} B[t, s] Q[t, s] ⊙ k_s + bonus
//     dk_t = G_t ⊙ D_e v_t  + Σ_{s>t} B[s, t] Q[s, t] ⊙ r_s + bonus
//     dv_t = D_eᵀ (G_t ⊙ k_t) + Σ_{s>=t} (A + diag(r · (u ⊙ k)))[s, t] do_s
//
// The products with S_c and D_e, B, and dv's sum on the tensor cores (the
// float32 factors split as in level 1); the pairs inside the chunk by warp
// t for step t, their decay products built step by step (no division).
// dw in the direct form, which needs S_t and D_{t+1} at one step: a thread
// owns kr x vc entries of both states (2 x 4 at kk = vv = 64), steps S
// forward from S_c (kept every 4 steps in shared memory, the 4 steps of a
// sub-chunk in registers) and D backward from D_e, and sums S_t ⊙ D_{t+1}
// over its columns; the lanes of a warp sum over theirs by a
// transpose-reduce (each shuffle level halves the values a lane keeps),
// and the warps' sums meet in shared memory, summed in a fixed order.
// ~110 KB of shared memory and 64 registers a thread give 2 blocks, 32
// warps, an SM.  It is bound by its instructions (the direct dw walk about
// half of them, the chunk's matrix terms most of the rest).  A larger
// state keeps fewer steps in registers and no checkpoints (they would not
// fit): it steps S again from S_c.
//
// Padding: the head size is padded to kk (64 or 128) and the columns to vv
// (64 or 128), time to a whole chunk, with r = k = v = do = 0 and w = 1,
// which leave both states as they are; padded entries write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_common.cuh"

namespace {

using namespace wkv;

constexpr int C = 16;           // steps a chunk (both levels)
constexpr int K_MAX = 128;
constexpr int V_MAX = 128;

// -- level 1: the boundary states ---------------------------------------------
constexpr int LA = C + 4;       // stride of the (x ⊙ factor) tile [k][t]

// a chunk's tiles: x ⊙ factor [KK][LA], v or do [C][VV + 8], the chunk's
// decay products [KK]; two of them
template <int KK, int VV>
__host__ __device__ constexpr int states_buf_floats() {
  return KK * LA + C * (VV + 8) + KK;
}

// Block (bh, z): z = 0 steps S forward from S_0 through the chunks and
// writes it at every chunk start; z = 1 steps D backward from dS_T, writes
// it at every chunk end and D_0 to ds0.
// KK / 8 warps: warp m owns state rows 16 (m % (KK / 16)) + [0, 16) of one
// half of the columns, VV / 16 mma accumulator tiles of 16 x 8.  The
// first KK / 16 warps turn the chunk's x and w into the tiles' factors
// (two threads a head index, a half of the chunk each), the others stage
// its v or do.
template <typename T, int KK, int VV>
__global__ void __launch_bounds__(4 * KK)
wkv6_bwd_states_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const float* __restrict__ s0,
                       const T* __restrict__ dout,
                       const float* __restrict__ dsT, float* __restrict__ ds0,
                       float* __restrict__ ck, int T_len, int K, int V,
                       int nc) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NPS = F32 ? 3 : 2;        // products a k8 step (mma_np)
  constexpr int NT = 4 * KK, MT = KK / 16, NN = VV / 16;
  constexpr int SB = VV + 8;              // stride of the v / do tile
  constexpr int YJ = C * VV / (2 * KK);   // v / do entries a thread stages
  constexpr int BUF = states_buf_floats<KK, VV>();
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long bh = blockIdx.x, BH = gridDim.x;
  const int z = blockIdx.y;
  const T* x = z ? r : k;                 // the tile's rows: k, or r
  const T* y = z ? dout : v;              // its columns: v, or do
  const float* init = z ? dsT : s0;
  const bool prep = warp < MT;
  // the prep's head index pk and half ph of the chunk (steps 8 ph ..
  // 8 ph + 7); the two halves of a head index are lanes l and l ^ 16
  const int pk = 16 * warp + (lane & 15), ph = lane >> 4;
  const int ytid = tid - 2 * KK;          // the stagers' index

  // the state: rows m0 + g (+ 8), columns n0 + 8 j + 2 q (+ 1)
  const int m0 = 16 * (warp % MT), n0 = 8 * NN * (warp / MT);
  float acc[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = m0 + g + 8 * (e >> 1), vc = n0 + 8 * j + 2 * q + (e & 1);
      acc[j][e] = init != nullptr && kr < K && vc < V
                      ? init[(bh * K + kr) * V + vc] : 0.f;
    }

  // a chunk's inputs in registers, loaded two chunks ahead
  struct Stage {
    T x[C / 2], w[C / 2], y[YJ];
  };
  auto load = [&](Stage& st, int i) {
    const int t0 = (z ? nc - 1 - i : i) * C;
    if (prep) {
#pragma unroll
      for (int j = 0; j < C / 2; ++j) {
        const int t = t0 + 8 * ph + j;
        const bool ok = pk < K && t < T_len;
        const long long o = (bh * T_len + t) * K + pk;
        st.x[j] = ok ? x[o] : from_f<T>(0.f);
        st.w[j] = ok ? w[o] : from_f<T>(1.f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < YJ; ++j) {
        const int e = ytid + j * 2 * KK, t = t0 + e / VV, col = e % VV;
        st.y[j] = t < T_len && col < V ? y[(bh * T_len + t) * V + col]
                                       : from_f<T>(0.f);
      }
    }
  };
  // chunk i of the direction: write the state it starts from, turn its
  // inputs into the tiles (then load chunk i + 2 into the same registers),
  // and step the state through it
  auto step = [&](Stage& st, int i) {
    const int c = z ? nc - 1 - i : i;
    float* dst = ck + ((z * BH + bh) * nc + c) * (long long)(KK * VV);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (m0 + g + 8 * hf) * VV + n0 +
                                   8 * j + 2 * q) =
            make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
    if (!z && i == nc - 1) return;        // S_T is not needed
    float* at = smem + (i & 1) * BUF;     // [KK][LA]
    float* yt = at + KK * LA;             // [C][SB]
    float* tot = yt + C * SB;             // [KK]
    if (prep) {
      // the factors of the thread's half: exclusive suffix products (z =
      // 0, G) or prefix products (z = 1, F) of the clamped decays, the
      // other half's product carried across
      float cf[C / 2], run = 1.f;
      if (z) {
#pragma unroll
        for (int j = 0; j < C / 2; ++j) {
          cf[j] = run;
          run *= fmaxf(to_f(st.w[j]), W_MIN);
        }
      } else {
#pragma unroll
        for (int j = C / 2 - 1; j >= 0; --j) {
          cf[j] = run;
          run *= fmaxf(to_f(st.w[j]), W_MIN);
        }
      }
      const float other = __shfl_xor_sync(0xffffffffu, run, 16);
      const float carry = (z ? ph == 1 : ph == 0) ? other : 1.f;
      float f[C / 2];
#pragma unroll
      for (int j = 0; j < C / 2; ++j) f[j] = to_f(st.x[j]) * (cf[j] * carry);
      *reinterpret_cast<float4*>(at + pk * LA + 8 * ph) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(at + pk * LA + 8 * ph + 4) =
          make_float4(f[4], f[5], f[6], f[7]);
      if (ph == 0) tot[pk] = run * other;
    } else {
#pragma unroll
      for (int j = 0; j < YJ; ++j) {
        const int e = ytid + j * 2 * KK;
        yt[(e / VV) * SB + e % VV] = to_f(st.y[j]);
      }
    }
    if (i + 2 < nc) load(st, i + 2);
    __syncthreads();                      // the tiles of chunk i are ready
    float a[C / 8][4];
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks) {
      const float* ar = at + (m0 + g) * LA + 8 * ks + q;
      a[ks][0] = ar[0];
      a[ks][1] = ar[8 * LA];
      a[ks][2] = ar[4];
      a[ks][3] = ar[8 * LA + 4];
    }
    const float w0 = tot[m0 + g], w1 = tot[m0 + g + 8];
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < C / 8; ++ks) {
        float b[2];
        b[0] = yt[(8 * ks + q) * SB + n0 + 8 * j + g];
        b[1] = yt[(8 * ks + q + 4) * SB + n0 + 8 * j + g];
        mma_np<NPS>(d, e, a[ks], b);
      }
      acc[j][0] = fmaf(w0, acc[j][0], d[0] + e[0]);
      acc[j][1] = fmaf(w0, acc[j][1], d[1] + e[1]);
      acc[j][2] = fmaf(w1, acc[j][2], d[2] + e[2]);
      acc[j][3] = fmaf(w1, acc[j][3], d[3] + e[3]);
    }
  };

  Stage sa, sb;
  if (nc > 0) load(sa, 0);
  if (nc > 1) load(sb, 1);
  for (int i = 0; i < nc; i += 2) {
    step(sa, i);
    if (i + 1 < nc) step(sb, i + 1);
  }
  if (z && ds0 != nullptr) {
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = m0 + g + 8 * (e >> 1);
        const int vc = n0 + 8 * j + 2 * q + (e & 1);
        if (kr < K && vc < V) ds0[(bh * K + kr) * V + vc] = acc[j][e];
      }
  }
}

// -- level 2: every chunk at once ---------------------------------------------
constexpr int NT2 = 512;        // threads a level-2 block: 16 warps

// Sums x[0 .. N) over the lanes that differ in the bits of M, lowest bit
// first.  Where N is even the two lanes of a pair split the values (the
// lane whose bit is set keeps the upper half) and each adds its partner's
// half of its own; where N is odd both add all of them.  Afterwards lane l
// holds in x[0 .. left) the sums of the values base(l) + [0, left); the
// lanes that differ only in the bits of `dup` hold the same sums.
template <int N, int M>
struct Tr {
  static constexpr int O = M & -M;
  static constexpr bool split = N % 2 == 0;
  using Next = Tr<split ? N / 2 : N, M & ~O>;
  static constexpr int left = Next::left;
  static constexpr int dup = (split ? 0 : O) | Next::dup;
  template <int NQ>
  static __device__ __forceinline__ void reduce(float (&x)[NQ], int lane) {
    if constexpr (split) {
      const bool up = lane & O;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float send = up ? x[j] : x[j + N / 2];
        const float keep = up ? x[j + N / 2] : x[j];
        x[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        x[j] += __shfl_xor_sync(0xffffffffu, x[j], O);
    }
    Next::reduce(x, lane);
  }
  static __device__ __forceinline__ int base(int lane) {
    return (split && (lane & O) ? N / 2 : 0) + Next::base(lane);
  }
};
template <int N>
struct Tr<N, 0> {
  static constexpr int left = N, dup = 0;
  template <int NQ>
  static __device__ __forceinline__ void reduce(float (&)[NQ], int) {}
  static __device__ __forceinline__ int base(int) { return 0; }
};

// The level-2 block for a state padded to KK x VV.  Warp t owns step t of
// the chunk for the terms in the chunk's matrix form.  In the direct walk
// for dw the 16 warps are 4 row blocks x 4 column blocks, a warp 8 row
// groups x 4 column groups, a thread KR rows x VC columns of S and D; a
// thread keeps SUB steps of S in registers, and S every SUB steps in
// shared memory when they fit (64 x 64), else steps it again from S_c.
// The shared floats (kernels/plan.py::_wkv6_bwd_chunk_smem): the chunk's
// inputs (r, k, w [C][KP]; v, do [C][VP]), F and G, the products X = S_c
// dOᵀ and Y = D_e Vᵀ [C][KP] and Z = (K ⊙ G) D_e [C][VP], B = dO Vᵀ and A
// [C][C + 1], v · do and r · (u ⊙ k) a step, u; then one region that first
// holds S_c and D_e [KK][VP] for the tensor cores and then the checkpoints
// and the walk's partial sums of dw by column block [C][4][KK].
template <int KK, int VV>
struct Cfg {
  static constexpr int KP = KK + 4, VP = VV + 4, CP = C + 1;
  static constexpr int KR = KK / 32, VC = VV / 16, NE = KR * VC;
  static constexpr int SUB = 32 / NE;                     // 4, 2 or 1
  static constexpr int NCK = KK * VV == 4096 ? C / SUB - 1 : 0;
  static constexpr int FIXED =
      7 * C * KP + 3 * C * VP + 2 * C * CP + 2 * C + KK;
  static constexpr int REGION1 = 2 * KK * VP;
  static constexpr int REGION2 = NCK * KK * VV + C * 4 * KK;
  static constexpr int SMEM =
      FIXED + (REGION1 > REGION2 ? REGION1 : REGION2);
  static constexpr int PER_SM = KK * VV == 4096 ? 2 : 1;
  // loads a thread issues at once
  static constexpr int LK = C * KK / NT2, LV = C * VV / NT2;
  static constexpr int LS = KK * VV / 4 / NT2;
  static_assert(C == NT2 / 32, "a warp a step");
  static_assert(VC % 4 == 0 && NE % 4 == 0 && FIXED % 4 == 0, "float4");
};

template <int N>
__device__ __forceinline__ void ld(float (&d)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      d[i] = x.x; d[i + 1] = x.y; d[i + 2] = x.z; d[i + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "rows a thread");
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x; d[1] = x.y;
  }
}

template <typename T, int KK, int VV>
__global__ void __launch_bounds__(NT2, (KK * VV <= 4096 ? 2 : 1))
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const float* __restrict__ u,
                      const T* __restrict__ dout, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      T* __restrict__ dw, float* __restrict__ du_part,
                      const float* __restrict__ ck, int H, int T_len, int K,
                      int V) {
  using G = Cfg<KK, VV>;
  constexpr int KP = G::KP, VP = G::VP, CP = G::CP;
  constexpr int KR = G::KR, VC = G::VC, NE = G::NE, SUB = G::SUB;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NPX = F32 ? 3 : 2;        // X, Y: exact bf16 dO, V
  constexpr int NPB = F32 ? 3 : 1;        // B: both exact in bf16
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;                         // [C][KP]
  float* sk = sr + C * KP;                // [C][KP]
  float* sw = sk + C * KP;                // [C][KP] raw decays
  float* sF = sw + C * KP;                // [C][KP] Π_{τ<t} w_τ
  float* sG = sF + C * KP;                // [C][KP] Π_{τ>t} w_τ
  float* sX = sG + C * KP;                // [C][KP] S_c do_t
  float* sY = sX + C * KP;                // [C][KP] D_e v_t
  float* sv = sY + C * KP;                // [C][VP]
  float* sdo = sv + C * VP;               // [C][VP]
  float* sZ = sdo + C * VP;               // [C][VP] D_eᵀ (k_t ⊙ G_t)
  float* sB = sZ + C * VP;                // [C][CP] sB[t][s] = do_t · v_s
  float* sA = sB + C * CP;                // [C][CP] A[s, t], bonus on diag
  float* vdo = sA + C * CP;               // [C] v_t · do_t
  float* ruk = vdo + C;                   // [C] r_t · (u ⊙ k_t)
  float* su = ruk + C;                    // [KK]
  float* reg = su + KK;                   // the region
  float* sSc = reg;                       // [KK][VP] S_c, then
  float* sDe = reg + KK * VP;             // [KK][VP] D_e
  float4* cks = reinterpret_cast<float4*>(reg);   // [NCK][NE / 4][NT2]
  float* part = reg + G::NCK * KK * VV;   // [C][4][KK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c = blockIdx.x, nc = gridDim.x, t0 = c * C;
  const long long bh = blockIdx.y, BH = gridDim.y;
  const int h = (int)(bh % H);
  const float* cS = ck + (bh * nc + c) * (long long)(KK * VV);
  const float* cD = ck + ((BH + bh) * nc + c) * (long long)(KK * VV);

  // 0. every load of the block at once: the chunk's inputs (padded past T
  // and past K, V), S_c and D_e
  {
    T lr[G::LK], lk[G::LK], lw[G::LK], lv[G::LV], lo[G::LV];
    float4 ls[G::LS], ld_[G::LS];
#pragma unroll
    for (int j = 0; j < G::LK; ++j) {
      const int i = tid + j * NT2, t = i / KK, x = i % KK;
      const bool ok = t0 + t < T_len && x < K;
      const long long o = (bh * T_len + t0 + t) * K + x;
      lr[j] = ok ? r[o] : from_f<T>(0.f);
      lk[j] = ok ? k[o] : from_f<T>(0.f);
      lw[j] = ok ? w[o] : from_f<T>(1.f);
    }
#pragma unroll
    for (int j = 0; j < G::LV; ++j) {
      const int i = tid + j * NT2, t = i / VV, x = i % VV;
      const bool ok = t0 + t < T_len && x < V;
      const long long o = (bh * T_len + t0 + t) * V + x;
      lv[j] = ok ? v[o] : from_f<T>(0.f);
      lo[j] = ok ? dout[o] : from_f<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < G::LS; ++j) {
      const int i = tid + j * NT2;
      ls[j] = *reinterpret_cast<const float4*>(cS + 4 * i);
      ld_[j] = *reinterpret_cast<const float4*>(cD + 4 * i);
    }
#pragma unroll
    for (int j = 0; j < G::LK; ++j) {
      const int i = tid + j * NT2, o = (i / KK) * KP + i % KK;
      sr[o] = to_f(lr[j]);
      sk[o] = to_f(lk[j]);
      sw[o] = to_f(lw[j]);
    }
#pragma unroll
    for (int j = 0; j < G::LV; ++j) {
      const int i = tid + j * NT2, o = (i / VV) * VP + i % VV;
      sv[o] = to_f(lv[j]);
      sdo[o] = to_f(lo[j]);
    }
#pragma unroll
    for (int j = 0; j < G::LS; ++j) {
      const int i = tid + j * NT2;
      const int o = (i / (VV / 4)) * VP + 4 * (i % (VV / 4));
      *reinterpret_cast<float4*>(sSc + o) = ls[j];
      *reinterpret_cast<float4*>(sDe + o) = ld_[j];
    }
    for (int i = tid; i < KK; i += NT2)
      su[i] = i < K ? u[(long long)h * K + i] : 0.f;
  }
  __syncthreads();

  // 1. warp t, step t: v · do and r · (u ⊙ k); the decay products F and G
  // by threads of their own; on the tensor cores Xᵀ = S_c dOᵀ and Yᵀ =
  // D_e Vᵀ (KK x C: m16 tiles of k, n8 of t) and B = dO Vᵀ (C x C)
  const int t = warp;
  {
    float a = 0.f, b = 0.f;
    for (int x = lane; x < VV; x += 32)
      a = fmaf(sv[t * VP + x], sdo[t * VP + x], a);
    for (int x = lane; x < KK; x += 32)
      b = fmaf(sr[t * KP + x] * su[x], sk[t * KP + x], b);
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      vdo[t] = a;
      ruk[t] = b;
    }
  }
  if (tid < 2 * KK) {                     // F (tid < KK) or G
    const int x = tid % KK;
    float f = 1.f;
    if (tid < KK) {
#pragma unroll
      for (int s2 = 0; s2 < C; ++s2) {
        sF[s2 * KP + x] = f;
        f *= fmaxf(sw[s2 * KP + x], W_MIN);
      }
    } else {
#pragma unroll
      for (int s2 = C - 1; s2 >= 0; --s2) {
        sG[s2 * KP + x] = f;
        f *= fmaxf(sw[s2 * KP + x], W_MIN);
      }
    }
  }
  constexpr int XJ = 2 * (KK / 16) * 2;   // X and Y tiles, then B's two
  for (int job = warp; job < XJ + 2; job += 16) {
    float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
    if (job < XJ) {
      const bool isY = job >= XJ / 2;
      const int rem = job % (XJ / 2);
      const int m0 = 16 * (rem >> 1), n0 = 8 * (rem & 1);
      const float* A = isY ? sDe : sSc;
      const float* Bt = isY ? sv : sdo;
#pragma unroll
      for (int ks = 0; ks < VV / 8; ++ks) {
        const float* ar = A + (m0 + g) * VP + 8 * ks + q;
        const float a[4] = {ar[0], ar[8 * VP], ar[4], ar[8 * VP + 4]};
        const float* br = Bt + (n0 + g) * VP + 8 * ks + q;
        const float b[2] = {br[0], br[4]};
        mma_np<NPX>(d, e, a, b);
      }
      float* out = isY ? sY : sX;
      out[(n0 + 2 * q) * KP + m0 + g] = d[0] + e[0];
      out[(n0 + 2 * q + 1) * KP + m0 + g] = d[1] + e[1];
      out[(n0 + 2 * q) * KP + m0 + g + 8] = d[2] + e[2];
      out[(n0 + 2 * q + 1) * KP + m0 + g + 8] = d[3] + e[3];
    } else {                              // B[t, s] = do_t · v_s
      const int n0 = 8 * (job - XJ);
#pragma unroll
      for (int ks = 0; ks < VV / 8; ++ks) {
        const float* ar = sdo + g * VP + 8 * ks + q;
        const float a[4] = {ar[0], ar[8 * VP], ar[4], ar[8 * VP + 4]};
        const float* br = sv + (n0 + g) * VP + 8 * ks + q;
        const float b[2] = {br[0], br[4]};
        mma_np<NPB>(d, e, a, b);
      }
      sB[g * CP + n0 + 2 * q] = d[0] + e[0];
      sB[g * CP + n0 + 2 * q + 1] = d[1] + e[1];
      sB[(g + 8) * CP + n0 + 2 * q] = d[2] + e[2];
      sB[(g + 8) * CP + n0 + 2 * q + 1] = d[3] + e[3];
    }
  }
  __syncthreads();

  // 2. Z = (K ⊙ G) D_e on the tensor cores, every factor split three ways
  // (both are float32): m16 of t, n8 tiles of v
  for (int n = warp; n < VV / 8; n += 16) {
    const int n0 = 8 * n;
    float d[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KK / 8; ++ks) {
      const int o = g * KP + 8 * ks + q;
      const float a[4] = {sk[o] * sG[o], sk[o + 8 * KP] * sG[o + 8 * KP],
                          sk[o + 4] * sG[o + 4],
                          sk[o + 8 * KP + 4] * sG[o + 8 * KP + 4]};
      const float* br = sDe + (8 * ks + q) * VP + n0 + g;
      const float b[2] = {br[0], br[4 * VP]};
      mma_np<3>(d, e, a, b);
    }
    *reinterpret_cast<float2*>(sZ + g * VP + n0 + 2 * q) =
        make_float2(d[0] + e[0], d[1] + e[1]);
    *reinterpret_cast<float2*>(sZ + (g + 8) * VP + n0 + 2 * q) =
        make_float2(d[2] + e[2], d[3] + e[3]);
  }
  // warp t, head indices lane + 32 i: the pairs inside the chunk for dr
  // and dk, and A[s, t], their decay products built step by step; dr, dk
  // out
  {
    constexpr int NX = KK / 32;
    float a_r[NX], a_k[NX], run[NX], kt[NX], ap[C];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      a_r[i] = a_k[i] = 0.f;
      run[i] = 1.f;
      kt[i] = sk[t * KP + lane + 32 * i];
    }
#pragma unroll 1
    for (int s2 = t - 1; s2 >= 0; --s2) {
      const float b = sB[t * CP + s2];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const int x = lane + 32 * i;
        a_r[i] = fmaf(run[i] * sk[s2 * KP + x], b, a_r[i]);
        run[i] *= fmaxf(sw[s2 * KP + x], W_MIN);
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) run[i] = 1.f;
#pragma unroll
    for (int s2 = 0; s2 < C; ++s2) {
      ap[s2] = 0.f;
      if (s2 <= t) continue;
      const float b = sB[s2 * CP + t];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const int x = lane + 32 * i;
        const float y = run[i] * sr[s2 * KP + x];
        a_k[i] = fmaf(y, b, a_k[i]);
        ap[s2] = fmaf(y, kt[i], ap[s2]);
        run[i] *= fmaxf(sw[s2 * KP + x], W_MIN);
      }
    }
    // A[s, t] for s > t, 0 below, and the bonus r_t · (u ⊙ k_t) on the
    // diagonal: dv = Z + (A + diag)ᵀ dO
    Tr<C, 31>::reduce(ap, lane);
    if (!(lane & Tr<C, 31>::dup)) {
      const int s2 = Tr<C, 31>::base(lane);
      sA[s2 * CP + t] = s2 == t ? ruk[t] : ap[0];
    }
    if (t0 + t < T_len) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const int x = lane + 32 * i;
        if (x >= K) continue;
        const long long o = (bh * T_len + t0 + t) * K + x;
        const float bonus = su[x] * vdo[t];
        dr[o] = from_f<T>(fmaf(sF[t * KP + x], sX[t * KP + x], a_r[i]) +
                          bonus * kt[i]);
        dk[o] = from_f<T>(fmaf(sG[t * KP + x], sY[t * KP + x], a_k[i]) +
                          bonus * sr[t * KP + x]);
      }
    }
  }
  // the thread's entries of the direct walk, e = i VC + j for row row0 + i
  // and column col0 + j
  const int rb = warp >> 2, cb = warp & 3;
  const int row0 = rb * 8 * KR + g * KR, col0 = cb * 4 * VC + q * VC;
  float S[NE], D[NE];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    float a[VC], b[VC];
    ld(a, sSc + (row0 + i) * VP + col0);
    ld(b, sDe + (row0 + i) * VP + col0);
#pragma unroll
    for (int j = 0; j < VC; ++j) {
      S[i * VC + j] = a[j];
      D[i * VC + j] = b[j];
    }
  }
  __syncthreads();                        // the region is free, Z is in

  // 3. dv = Z + (A + diag)ᵀ dO on the tensor cores, n8 tiles of v; du's
  // sum of the row and chunk
  for (int n = warp; n < VV / 8; n += 16) {
    const int n0 = 8 * n;
    float d[4], e[4] = {0.f, 0.f, 0.f, 0.f};
    d[0] = sZ[g * VP + n0 + 2 * q];
    d[1] = sZ[g * VP + n0 + 2 * q + 1];
    d[2] = sZ[(g + 8) * VP + n0 + 2 * q];
    d[3] = sZ[(g + 8) * VP + n0 + 2 * q + 1];
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks) {
      const float* ar = sA + (8 * ks + q) * CP + g;
      const float a[4] = {ar[0], ar[8], ar[4 * CP], ar[4 * CP + 8]};
      const float b[2] = {sdo[(8 * ks + q) * VP + n0 + g],
                          sdo[(8 * ks + q + 4) * VP + n0 + g]};
      mma_np<NPX>(d, e, a, b);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = g + 8 * (j >> 1), x = n0 + 2 * q + (j & 1);
      if (t0 + tt < T_len && x < V)
        dv[(bh * T_len + t0 + tt) * V + x] = from_f<T>(d[j] + e[j]);
    }
  }
  if (tid < K) {
    float a = 0.f;
    for (int s2 = 0; s2 < C; ++s2)
      a = fmaf(sr[s2 * KP + tid] * sk[s2 * KP + tid], vdo[s2], a);
    du_part[(bh * nc + c) * K + tid] = a;
  }

  // 4. dw, directly: S_t stepped forward, D_{t+1} backward
  auto step_s = [&](float (&s)[NE], int ts) {       // S <- S_{ts+1}
    float kx[KR], wx[KR], vx[VC];
    ld(kx, sk + ts * KP + row0);
    ld(wx, sw + ts * KP + row0);
    ld(vx, sv + ts * VP + col0);
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const float wc = fmaxf(wx[i], W_MIN);
#pragma unroll
      for (int j = 0; j < VC; ++j)
        s[i * VC + j] = fmaf(wc, s[i * VC + j], kx[i] * vx[j]);
    }
  };
  auto load_sc = [&](float (&s)[NE]) {              // S_c, from the scratch
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      float a[VC];
      ld(a, cS + (row0 + i) * VV + col0);
#pragma unroll
      for (int j = 0; j < VC; ++j) s[i * VC + j] = a[j];
    }
  };
  if constexpr (G::NCK > 0) {             // S every SUB steps
#pragma unroll 1
    for (int ts = 0; ts < C - SUB; ++ts) {
      step_s(S, ts);
      if ((ts + 1) % SUB == 0) {
        float4* dst = cks + ((ts + 1) / SUB - 1) * (NE / 4) * NT2 + tid;
#pragma unroll
        for (int e = 0; e < NE / 4; ++e)
          dst[e * NT2] = make_float4(S[4 * e], S[4 * e + 1], S[4 * e + 2],
                                     S[4 * e + 3]);
      }
    }
  }
  using RowTr = Tr<SUB * KR, 3>;          // a sub-chunk's dw over the lanes
#pragma unroll 1
  for (int j = C / SUB - 1; j >= 0; --j) {
    // S_{SUB j} .. S_{SUB j + SUB - 1}
    float hs[SUB][NE];
    if (j == 0 || G::NCK == 0) {
      load_sc(hs[0]);
#pragma unroll 1
      for (int ts = 0; ts < SUB * j; ++ts) step_s(hs[0], ts);
    } else {
      const float4* src = cks + (j - 1) * (NE / 4) * NT2 + tid;
#pragma unroll
      for (int e = 0; e < NE / 4; ++e) {
        const float4 x = src[e * NT2];
        hs[0][4 * e] = x.x; hs[0][4 * e + 1] = x.y;
        hs[0][4 * e + 2] = x.z; hs[0][4 * e + 3] = x.w;
      }
    }
#pragma unroll
    for (int i = 1; i < SUB; ++i) {
#pragma unroll
      for (int e = 0; e < NE; ++e) hs[i][e] = hs[i - 1][e];
      step_s(hs[i], SUB * j + i - 1);
    }
    // backwards through the sub-chunk: D holds D_{ts+1}
    float xw[SUB * KR];
#pragma unroll
    for (int i = SUB - 1; i >= 0; --i) {
      const int ts = SUB * j + i;
      float rx[KR], wx[KR], ox[VC];
      ld(rx, sr + ts * KP + row0);
      ld(wx, sw + ts * KP + row0);
      ld(ox, sdo + ts * VP + col0);
#pragma unroll
      for (int a = 0; a < KR; ++a) {
        const float wc = fmaxf(wx[a], W_MIN);
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < VC; ++b) {
          acc = fmaf(hs[i][a * VC + b], D[a * VC + b], acc);
          D[a * VC + b] = fmaf(wc, D[a * VC + b], rx[a] * ox[b]);
        }
        xw[i * KR + a] = acc;
      }
    }
    RowTr::reduce(xw, lane);
    if (!(lane & RowTr::dup)) {
      const int b0 = RowTr::base(lane);
#pragma unroll
      for (int n = 0; n < RowTr::left; ++n) {
        const int idx = b0 + n;
        part[((SUB * j + idx / KR) * 4 + cb) * KK + row0 + idx % KR] = xw[n];
      }
    }
  }
  __syncthreads();
  // dw: the column blocks' sums in a fixed order, the clamp's mask
  for (int i = tid; i < C * KK; i += NT2) {
    const int ts = i / KK, x = i % KK;
    const float* p = part + ts * 4 * KK + x;
    const float sum = ((p[0] + p[KK]) + p[2 * KK]) + p[3 * KK];
    if (t0 + ts < T_len && x < K)
      dw[(bh * T_len + t0 + ts) * K + x] =
          from_f<T>(sw[ts * KP + x] >= W_MIN ? sum : 0.f);
  }
}

// -- launches -----------------------------------------------------------------

// the kernel's shared-memory attribute and the residency it allows, looked
// up once per instantiation; refuses a plan the card cannot hold
template <typename Kern>
int prepare(Kern kern, int threads, size_t smem, int per_sm, int* cached,
            int* resident) {
  if ((int)smem != *cached) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern,
                                                          threads, smem);
    if (err != cudaSuccess) return (int)err;
    *cached = (int)smem;
  }
  return *resident < per_sm ? (int)cudaErrorInvalidConfiguration : 0;
}

struct Args {
  const void *r, *k, *v, *w;
  const float *u, *s0;
  const void* dout;
  const float* dsT;
  void *dr, *dk, *dv, *dw;
  float *du_part, *ds0, *ck;
  int BH, H, T_len, K, V;
};

template <typename T, int KK, int VV>
int launch(const Args& a, int chunk, int sub, int n_chunks, int threads1,
           int smem1, int threads2, int smem2, int per_sm,
           cudaStream_t st) {
  using G = Cfg<KK, VV>;
  const size_t bytes1 = sizeof(float) * 2 * states_buf_floats<KK, VV>();
  const size_t bytes2 = sizeof(float) * G::SMEM;
  if (chunk != C || sub != G::SUB ||
      n_chunks != (a.T_len + C - 1) / C ||
      threads1 != 4 * KK || (size_t)smem1 != bytes1 || threads2 != NT2 ||
      (size_t)smem2 != bytes2 || per_sm != G::PER_SM)
    return (int)cudaErrorInvalidValue;
  auto k1 = wkv6_bwd_states_kernel<T, KK, VV>;
  auto k2 = wkv6_bwd_chunk_kernel<T, KK, VV>;
  static int cached1 = -1, resident1 = 0, cached2 = -1, resident2 = 0;
  int err = prepare(k1, threads1, bytes1, 1, &cached1, &resident1);
  if (!err) err = prepare(k2, NT2, bytes2, per_sm, &cached2, &resident2);
  if (err) return err;
  k1<<<dim3(a.BH, 2), threads1, bytes1, st>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.w), a.s0,
      static_cast<const T*>(a.dout), a.dsT, a.ds0, a.ck, a.T_len, a.K, a.V,
      n_chunks);
  err = (int)cudaGetLastError();
  if (err || n_chunks == 0) return err;
  k2<<<dim3(n_chunks, a.BH), NT2, bytes2, st>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.w), a.u,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), static_cast<T*>(a.dw),
      a.du_part, a.ck, a.H, a.T_len, a.K, a.V);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int kk, int vv, const Args& a, int chunk, int sub, int n_chunks,
        int threads1, int smem1, int threads2, int smem2, int per_sm,
        cudaStream_t st) {
#define REPRO_WKV6_BWD(KK_, VV_)                                             \
  return launch<T, KK_, VV_>(a, chunk, sub, n_chunks, threads1, smem1,      \
                             threads2, smem2, per_sm, st)
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
// du_part (BH, n_chunks, K) and, unless null, ds0 (BH, K, V) float, using
// ck (2, BH, n_chunks, kk, vv) float as scratch.  All contiguous.  K must
// be a multiple of 8 up to 128, V at most 128.  Two launches (one when T
// is 0) on the plan of kernels/plan.py's wkv6_bwd_plan: the padded sizes
// `kk` and `vv`, the `chunk` steps, the `sub` steps of S a level-2 thread
// keeps, `n_chunks`, each level's threads and shared bytes, and level 2's
// residency `per_sm`, which the card must hold.
int repro_wkv6_bwd(int types, const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0,
                   const void* dout, const float* dsT, void* dr, void* dk,
                   void* dv, void* dw, float* du_part, float* ds0, float* ck,
                   int BH, int H, int T_len, int K, int V, int kk, int vv,
                   int chunk, int sub, int n_chunks, int threads1, int smem1,
                   int threads2, int smem2, int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || V <= 0) return 0;
  if (K <= 0 || K % 8 || K > K_MAX || V > V_MAX || H <= 0 || BH % H ||
      BH > 65535 || T_len < 0 || kk != (K <= 64 ? 64 : 128) ||
      vv != (V <= 64 ? 64 : 128))
    return (int)cudaErrorInvalidValue;
  const Args a{r,  k,  v,  w,       u,   s0, dout, dsT, dr, dk,
               dv, dw, du_part, ds0, ck, BH, H,    T_len, K, V};
  switch (types) {
    case 0:
      return run<float>(kk, vv, a, chunk, sub, n_chunks, threads1, smem1,
                        threads2, smem2, per_sm, st);
    case 1:
      return run<__nv_bfloat16>(kk, vv, a, chunk, sub, n_chunks, threads1,
                                smem1, threads2, smem2, per_sm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
