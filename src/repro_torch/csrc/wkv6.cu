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
// input type; the final state S_T is always written, in float32.  S_0 and
// S_T may alias (an in-place decode).
//
// What bounds it on this card: per (bh, t) the recurrence is about 6 K V
// float32 operations against 2 (3 K + V) bytes of bf16 input and 2 V of
// output, so a long prefill (B 1, H 64, T 4096, K = V = 64: ~6.4 GFLOP,
// ~0.1 ms at 67 TFLOP/s) is bound by operations and a decode step (T 1)
// by reading and writing the float32 state (8 MB at B 4).  Two routes,
// chosen by kernels/plan.py::wkv6_plan:
//
// "chunked" (T > 1): the chunked form of gated linear attention with
// secondary chunking (Yang, Wang, Shen, Panda and Kim, "Gated Linear
// Attention Transformers with Hardware-Efficient Training"), on the TF32
// tensor cores (mma.sync m16n8k8).  Time goes in chunks of 16 steps, one
// m16 tile of rows.  Inside a chunk, with the decays clamped to
// w >= 1e-12 as the reference's log does:
//
//     o_t  = (r_t ⊙ F_t) S_in + Σ_{s<t} A[t, s] v_s + (r_t · (u ⊙ k_t)) v_t
//     S_out = diag(Π_chunk w) S_in + Σ_s (k_s ⊙ G_s) v_sᵀ
//     A[t, s] = Σ_k r_{t,k} k_{s,k} Π_{s<τ<t} w_{τ,k}
//
// with F_t = Π_{τ<t} w_τ and G_s = Π_{τ>s} w_τ over the chunk.  The
// strict-causal A never forms a growth factor e^{-Σ log w} (the TPU
// kernel's exp(-cumsum(log w)), which overflows float32 once a chunk's
// mean log w is below about -1.39).  A pair (t, s) in two different
// sub-chunks of 4 steps factors through a reference step between them:
// for the level L in {8, 4} at which t and s first fall into different
// halves of an aligned 2L-block, the reference is the last step of s's
// half, and
//
//     A[t, s] = Σ_k (r_{t,k} Π_{ref<τ<t} w_τ) (k_{s,k} Π_{s<τ<=ref} w_τ),
//
// one matrix product per level.  The six pairs inside a sub-chunk (decay
// factors 1, w or w w) and the bonus are FMA terms of the prep.  Every
// factor e^{lc_a - lc_b}, a >= b, is formed as the product of the clamped
// decays between, never as the exp of a cumulative log sum: every factor
// is <= 1, a w of 0 or below 1e-12 gives factors that underflow to 0, and
// no MUFU work is needed.
//
// Precision: TF32 keeps 11 bits of a float32 operand.  The state update
// (K ⊙ G)ᵀ V splits the float32 factor into its TF32 head (low 13 bits
// cleared) + the exact tail, two products against an exact bf16 v (three
// when v is float32), so the state keeps float32 accuracy (~2^-21 a term).
// For bf16 inputs the output products (the carry-in (r ⊙ F) S_in, levels
// 8 and 4 of A, and A V) take one product with operands rounded to TF32
// (~2^-10 a term, below the bf16 rounding of the output); for float32
// inputs they take three, head head + head tail + tail head.  The state
// never leaves float32.
//
// Design: one block of 16 warps per (bh, 32 state columns), one block an
// SM; 8 producer warps prepare chunk i + 1 while 8 consumer warps run
// chunk i, one block barrier a chunk:
//   producer: thread (k, sub-chunk) turns its four steps of r, k, w (loaded
//      into registers during the previous chunk) into the level factors,
//      exchanging the sub-chunk totals of its k by shuffles, and stores the
//      scaled operands as [k][t] tiles (one 16-byte store each); its FMA
//      terms are summed over the warp's head indices by shuffles, and over
//      the warps, in a fixed order, by the consumer;
//   consumer: three warps run the level products of A and one sums the FMA
//      terms, each writing its own pairs of Aᵀ, then arrive at a named
//      barrier; the state slice lives in the mma accumulators of the
//      consumer warps for the whole sequence: per chunk the carry-in
//      (r ⊙ F) S_in, ΔS = (K ⊙ G)ᵀ V and S = diag(Π w) S + ΔS (written to
//      the other of two shared copies that the next carry-in reads); four
//      warps wait for Aᵀ, add A V and the bonus to their output tiles and
//      write them to memory.
// A chunk's hand-over (the operand tiles, v, Aᵀ, the bonus, the decay
// products and the FMA partial sums) is double-buffered.  The [k][t]
// tiles are swizzled and the mma rows permuted (see the fragment loads) so
// that the prep's stores and the fragment loads are free of bank
// conflicts.  Time steps past T are padded with r = k = v = 0 and w = 1, as
// the plain version pads.
//
// "decode" (T <= 1): a state-streaming step.  A block owns a row bh and up
// to 256 state columns; a warp reads whole rows of S_0 (neighbouring
// threads on neighbouring columns, 16 bytes a thread), each thread updates
// S_T = diag(w) S_0 + k vᵀ for its rows and sums r_k S_0[k, :] over them,
// and one barrier later the partial sums over the row groups (and the
// bonus (r · (u ⊙ k)) v) give o.  Each thread reads its state entries
// before it writes them, so S_0 and S_T may alias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_common.cuh"

namespace {

using namespace wkv;

constexpr int CH = 16;          // time steps a chunk (one m16 row tile)
constexpr int SUB = 4;          // sub-chunk: a thread's steps in the prep
constexpr int VB = 32;          // state columns a chunked block
constexpr int NW = 8;           // warps a chunked block
constexpr int NT = 32 * NW;
constexpr int NO = VB / 8;      // output n8 tiles (warps 0 .. NO-1)
constexpr int LT = CH + 8;      // stride of the [k][t] operand tiles
constexpr int SS = VB + 8;      // stride of the state copies [k][v]
constexpr int SV = VB + 4;      // stride of the v tile [t][v]
constexpr int AS = CH + 4;      // stride of Aᵀ [s][t]
constexpr int K_MAX = 128;
constexpr int DEC_THREADS = 256;
constexpr int DEC_COLS = 256;   // most state columns a decode block owns

// two neighbouring outputs in one store (the caller checks alignment)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Fragment loads (g = lane / 4, q = lane % 4).  Row m of an m16 tile is
// time step 2 (m % 8) + m / 8, so that rows g and g + 8 are neighbouring
// steps and their A entries one 8-byte load from a [k][t] tile.  Where
// the contraction runs over time (the state step, A V), its k8 slot q is
// step 2q and slot q + 4 step 2q + 1, for the same reason.  The prep's
// [k][t] tiles are swizzled: step t of row k sits at t ^ (4 bit2(k)), so
// that the prep's 16-byte stores and these loads are free of bank
// conflicts.
__device__ __forceinline__ int swz(int k) { return (k & 4); }
// Each load takes the tile's base, the lane's offsets into it (computed
// once, outside the chunk loop) and the k8 step s; the step's offset is a
// compile-time constant.
//   A from a swizzled X[k][t], contraction over k (natural order):
//   o0 = q LD + 2g, o1 = (q + 4) LD + (2g ^ 4)
template <int LD>
__device__ __forceinline__ void lda_kt(float (&a)[4], const float* X, int o0,
                                       int o1, int s) {
  const float2 x = *reinterpret_cast<const float2*>(X + o0 + 8 * s * LD);
  const float2 y = *reinterpret_cast<const float2*>(X + o1 + 8 * s * LD);
  a[0] = x.x; a[1] = x.y; a[2] = y.x; a[3] = y.y;
}
//   A from a swizzled X[m][t], rows m0 + g (+ 8), contraction over time
//   (permuted slots): o = (m0 + g) LD + (2q ^ swz(g))
template <int LD>
__device__ __forceinline__ void lda_mt(float (&a)[4], const float* X, int o,
                                       int s) {
  const float2 x = *reinterpret_cast<const float2*>(X + o + 8 * s);
  const float2 y = *reinterpret_cast<const float2*>(X + o + 8 * LD + 8 * s);
  a[0] = x.x; a[1] = y.x; a[2] = x.y; a[3] = y.y;
}
//   A from X[s][t] (Aᵀ), rows t, contraction over s (permuted slots):
//   o = 2q LD + 2g
template <int LD>
__device__ __forceinline__ void lda_st(float (&a)[4], const float* X, int o,
                                       int s) {
  const float2 x = *reinterpret_cast<const float2*>(X + o + 8 * s * LD);
  const float2 y =
      *reinterpret_cast<const float2*>(X + o + (8 * s + 1) * LD);
  a[0] = x.x; a[1] = x.y; a[2] = y.x; a[3] = y.y;
}
//   B from X[k][n], contraction over k in natural order: o = q LD + n0 + g
template <int LD>
__device__ __forceinline__ void ldb_kn(float (&b)[2], const float* X, int o,
                                       int s) {
  b[0] = X[o + 8 * s * LD];
  b[1] = X[o + (8 * s + 4) * LD];
}
//   B from a swizzled X[k][s], contraction over k in natural order:
//   o0 = q LD + n0 + g, o1 = (q + 4) LD + ((n0 + g) ^ 4)
template <int LD>
__device__ __forceinline__ void ldb_ks(float (&b)[2], const float* X, int o0,
                                       int o1, int s) {
  b[0] = X[o0 + 8 * s * LD];
  b[1] = X[o1 + 8 * s * LD];
}
//   B from X[t][n], contraction over time (permuted slots):
//   o = 2q LD + n0 + g
template <int LD>
__device__ __forceinline__ void ldb_tn(float (&b)[2], const float* X, int o,
                                       int s) {
  b[0] = X[o + 8 * s * LD];
  b[1] = X[o + (8 * s + 1) * LD];
}

// what the producer hands the consumer for one chunk (double-buffered):
// [k][t] tiles of (r ⊙ F), (k ⊙ G) and the level-8 and level-4 operands,
// v [t][v], Aᵀ [s][t] (written by the consumer), the bonus, the chunk's
// decay products, and the FMA terms' partial sums
enum { B_R16, B_KC, B_R8, B_R4, B_K8, B_K4, NTILES };
//   a prep thread's FMA terms: the pairs inside its sub-chunk and the
//   bonus of its four steps; the pairs as (t, s) offsets in the sub-chunk
constexpr int NPAIR = 6, NFMA = NPAIR + SUB;
__constant__ int8_t PAIRS[NPAIR][2] = {{1, 0}, {2, 1}, {3, 2},
                                       {2, 0}, {3, 1}, {3, 0}};
template <int KK>
__host__ __device__ constexpr int cbuf_floats() {
  return NTILES * KK * LT + CH * SV + CH * AS + CH + KK + NW * SUB * NFMA;
}
template <int KK>
constexpr size_t chunked_smem_floats() {
  return 2 * (size_t)cbuf_floats<KK>() + 2 * (size_t)KK * SS;
}

// the level products of A on the tensor cores, one n8 tile each:
// (level, R tile, K tile, n8 tile), consumer warps NO .. NO + 2
__constant__ int8_t A_TASKS[3][4] = {
    {8, B_R8, B_K8, 0}, {4, B_R4, B_K4, 0}, {4, B_R4, B_K4, 1}};

// Aᵀ of a chunk is ready: the consumer warps that write it arrive, the
// output warps wait (a named barrier of the consumer's threads)
__device__ __forceinline__ void at_ready_arrive() {
  asm volatile("bar.arrive 1, %0;" ::"n"(NT) : "memory");
}
__device__ __forceinline__ void at_ready_wait() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

template <typename T, int KK>
__global__ void __launch_bounds__(2 * NT, 1)
wkv6_chunked_kernel(const T* __restrict__ R, const T* __restrict__ Kx,
                    const T* __restrict__ Vx, const T* __restrict__ W,
                    const float* __restrict__ U, const float* S0,
                    T* __restrict__ O, float* ST, int H, int T_len, int K,
                    int V) {
  // products: the state update splits its float32 factor (v exact in
  // bf16); the output products round for bf16 outputs, split for float32
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NPO = F32 ? 3 : 1;
  constexpr int NPS = F32 ? 3 : 2;
  constexpr int KS = KK / 8;                    // k8 steps over the head
  constexpr int NTILE = (KK / 16) * NO;         // 16 x 8 state tiles
  constexpr int TLO = NTILE / 16;               // tiles of consumers 0-3
  constexpr int THI = 3 * TLO;                  // tiles of consumers 4-7
  constexpr int KJ = KK / 64;                   // prep k's a thread
  constexpr int VJ = CH * VB / NT;              // v entries a thread
  constexpr int CB = cbuf_floats<KK>();

  extern __shared__ __align__(16) float smem[];
  float* cbuf = smem;                           // [2][CB]
  float* sst = cbuf + 2 * CB;                   // [2][KK][SS]
  // a chunk buffer: the [k][t] tiles [NTILES][KK][LT], v [CH][SV], Aᵀ
  // [CH][AS], bonus [CH], decays [KK], FMA partial sums [NW][SUB][NFMA]
  auto tile_of = [&](int b, int i) { return cbuf + b * CB + i * KK * LT; };
  auto v_of = [&](int b) { return tile_of(b, NTILES); };
  auto at_of = [&](int b) { return v_of(b) + CH * SV; };
  auto bon_of = [&](int b) { return at_of(b) + CH * AS; };
  auto tot_of = [&](int b) { return bon_of(b) + CH; };
  auto part_of = [&](int b) { return tot_of(b) + KK; };

  const int bh = blockIdx.y, h = bh % H;
  const int v0 = blockIdx.x * VB;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool producer = tid < NT;
  const int warp = (tid >> 5) % NW;             // within its group
  const int g = lane >> 2, q = lane & 3;
  // lane offsets of the A loads from the [k][t] operand tiles
  const int oa0 = q * LT + 2 * g, oa1 = (q + 4) * LT + (2 * g ^ 4);
  const size_t rbase = (size_t)bh * T_len * K;
  const size_t vbase = (size_t)bh * T_len * V;
  const size_t sbase = (size_t)bh * K * V;
  const int nchunks = (T_len + CH - 1) / CH;

  // the strictly lower part of A is rewritten every chunk, the rest stays 0
  for (int b = 0; b < 2; ++b)
    for (int i = tid; i < CH * AS; i += 2 * NT) at_of(b)[i] = 0.f;
  __syncthreads();

  if (producer) {
    // -- producer: the prep, one chunk ahead --------------------------------
    // thread (sub-chunk pa: steps 4 pa .. 4 pa + 3, head index pk[j])
    const int pa = lane >> 3;
    int pk[KJ];
    float uk[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      pk[j] = 8 * warp + (lane & 7) + 64 * j;
      uk[j] = pk[j] < K ? U[(size_t)h * K + pk[j]] : 0.f;
    }
    // register prefetch of a chunk: four steps of r, k, w at the thread's
    // head indices, and its v entries
    T pr[KJ][SUB], pkk[KJ][SUB], pw[KJ][SUB], pv[VJ];
    // a whole chunk inside the rows and the head (the model's shapes) loads
    // without predicates, from one row pointer a tensor
    const bool whole_k = K == KK, whole_v = v0 + VB <= V;
    auto load = [&](int t0) {
      if (whole_k && t0 + CH <= T_len) {
        const size_t o = rbase + (size_t)(t0 + SUB * pa) * K + pk[0];
        const T *r = R + o, *k = Kx + o, *w = W + o;
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
            pr[j][i] = r[i * KK + 64 * j];
            pkk[j][i] = k[i * KK + 64 * j];
            pw[j][i] = w[i * KK + 64 * j];
          }
      } else {
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int i = 0; i < SUB; ++i) {
            const int t = t0 + SUB * pa + i;
            const bool ok = t < T_len && pk[j] < K;
            const size_t o = rbase + (size_t)t * K + pk[j];
            pr[j][i] = ok ? R[o] : from_f<T>(0.f);
            pkk[j][i] = ok ? Kx[o] : from_f<T>(0.f);
            pw[j][i] = ok ? W[o] : from_f<T>(1.f);
          }
      }
      if (whole_v && t0 + CH <= T_len) {
        const T* v = Vx + vbase + (size_t)t0 * V + v0 + tid % VB;
#pragma unroll
        for (int j = 0; j < VJ; ++j) pv[j] = v[(size_t)((tid + j * NT) / VB) * V];
      } else {
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int e = tid + j * NT, t = t0 + e / VB, c = v0 + e % VB;
          pv[j] = (t < T_len && c < V) ? Vx[vbase + (size_t)t * V + c]
                                       : from_f<T>(0.f);
        }
      }
    };
    load(0);
    for (int ci = 0; ci < nchunks; ++ci) {
      const int b = ci & 1;
      // 1. prep: the level factors of the thread's four steps at its k,
      // and its share of the pairs inside the sub-chunk and of the bonus
      float fr[KJ][SUB], fk[KJ][SUB], fw[KJ][SUB], fv[VJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
#pragma unroll
        for (int i = 0; i < SUB; ++i) {
          fr[j][i] = to_f(pr[j][i]);
          fk[j][i] = to_f(pkk[j][i]);
          fw[j][i] = fmaxf(to_f(pw[j][i]), W_MIN);
        }
#pragma unroll
      for (int j = 0; j < VJ; ++j) fv[j] = to_f(pv[j]);
      // the next chunk's loads fly while this one is prepared
      if (ci + 1 < nchunks) load((ci + 1) * CH);
      float fm[NFMA];
#pragma unroll
      for (int i = 0; i < NFMA; ++i) fm[i] = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float* r = fr[j];
        const float* kv = fk[j];
        const float* w = fw[j];
        // exclusive prefix / suffix products inside the sub-chunk
        const float f4[SUB] = {1.f, w[0], w[0] * w[1], (w[0] * w[1]) * w[2]};
        const float b4[SUB] = {w[1] * (w[2] * w[3]), w[2] * w[3], w[3], 1.f};
        const float t4 = f4[3] * w[3];
        float tt[SUB];
#pragma unroll
        for (int a = 0; a < SUB; ++a)
          tt[a] = __shfl_sync(0xffffffffu, t4, (lane & 7) + 8 * a);
        // level 8: the other sub-chunk of the pair; level 16: the chunk
        const float p8 = pa == 1 ? tt[0] : pa == 3 ? tt[2] : 1.f;
        const float s8 = pa == 0 ? tt[1] : pa == 2 ? tt[3] : 1.f;
        float pre = 1.f, suf = 1.f;
#pragma unroll
        for (int a = 0; a < SUB; ++a) {
          if (a < pa) pre *= tt[a];
          if (SUB - 1 - a > pa) suf *= tt[SUB - 1 - a];
        }
        const int k = pk[j];
        const int col = SUB * (pa ^ (swz(k) >> 2));
        float4 x;
#define REPRO_PUT(DST, EXPR)                                                \
  x.x = (EXPR(0)); x.y = (EXPR(1)); x.z = (EXPR(2)); x.w = (EXPR(3));       \
  *reinterpret_cast<float4*>((DST) + k * LT + col) = x
#define E16(i) r[i] * (f4[i] * pre)
#define E8(i) r[i] * (f4[i] * p8)
#define E4(i) r[i] * f4[i]
#define G16(i) kv[i] * (b4[i] * suf)
#define G8(i) kv[i] * (b4[i] * s8)
#define G4(i) kv[i] * b4[i]
        REPRO_PUT(tile_of(b, B_R16), E16); REPRO_PUT(tile_of(b, B_KC), G16);
        REPRO_PUT(tile_of(b, B_R8), E8); REPRO_PUT(tile_of(b, B_R4), E4);
        REPRO_PUT(tile_of(b, B_K8), G8); REPRO_PUT(tile_of(b, B_K4), G4);
#undef E16
#undef E8
#undef E4
#undef G16
#undef G8
#undef G4
#undef REPRO_PUT
        if (pa == 0) tot_of(b)[k] = ((tt[0] * tt[1]) * tt[2]) * tt[3];
        // pairs (t, s) of the sub-chunk: r_t k_s Π_{s<τ<t} w_τ; bonus
        fm[0] = fmaf(r[1], kv[0], fm[0]);
        fm[1] = fmaf(r[2], kv[1], fm[1]);
        fm[2] = fmaf(r[3], kv[2], fm[2]);
        fm[3] = fmaf(r[2], kv[0] * w[1], fm[3]);
        fm[4] = fmaf(r[3], kv[1] * w[2], fm[4]);
        fm[5] = fmaf(r[3], kv[0] * (w[1] * w[2]), fm[5]);
#pragma unroll
        for (int i = 0; i < SUB; ++i)
          fm[NPAIR + i] = fmaf(r[i] * uk[j], kv[i], fm[NPAIR + i]);
      }
      // sum the FMA terms over the warp's 8 head indices: lanes with bit 2
      // of k clear keep terms 0-4, the others 5-9, then a butterfly
      {
        const bool hi = (lane & 4) != 0;
        float x5[NFMA / 2];
#pragma unroll
        for (int i = 0; i < NFMA / 2; ++i) {
          const float mine = hi ? fm[NFMA / 2 + i] : fm[i];
          const float other = hi ? fm[i] : fm[NFMA / 2 + i];
          x5[i] = mine + __shfl_xor_sync(0xffffffffu, other, 4);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
#pragma unroll
          for (int i = 0; i < NFMA / 2; ++i)
            x5[i] += __shfl_xor_sync(0xffffffffu, x5[i], off);
        if ((lane & 3) == 0) {
#pragma unroll
          for (int i = 0; i < NFMA / 2; ++i)
            part_of(b)[(warp * SUB + pa) * NFMA + (hi ? NFMA / 2 : 0) + i] =
                x5[i];
        }
      }
#pragma unroll
      for (int j = 0; j < VJ; ++j) {
        const int e = tid + j * NT;
        v_of(b)[(e / VB) * SV + e % VB] = fv[j];
      }
      // the consumer takes this chunk after the block barrier
      __syncthreads();
    }
  } else {
    // -- consumer: Aᵀ, the state step, the carry-in, A V, out --------------
    // state tiles: consumer warp w owns tiles j0 .. j0 + nt - 1 of the
    // (KK / 16) x NO grid, tile j -> rows (k) 16 (j / NO), columns 8 (j % NO)
    const int nt = warp < NO ? TLO : THI;
    const int j0 = warp < NO ? TLO * warp : NO * TLO + THI * (warp - NO);
    const bool pairs = (V & 1) == 0;            // 2-element output stores
    // per tile: the lane's offsets into (K ⊙ G) (A), v (B), the state
    // copies and the decays
    int okc[THI], ov[THI], os[THI], ot[THI];
    float sreg[THI][4];
#pragma unroll
    for (int j = 0; j < THI; ++j) {
      const int tj = j0 + j;
      const int m0 = 16 * (tj / NO), n0 = 8 * (tj % NO);
      okc[j] = (m0 + g) * LT + (2 * q ^ swz(g));
      ov[j] = 2 * q * SV + n0 + g;
      os[j] = (m0 + g) * SS + n0 + 2 * q;
      ot[j] = m0 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = m0 + g + 8 * (e >> 1), vc = n0 + 2 * q + (e & 1);
        float sv = 0.f;
        if (j < nt && S0 != nullptr && kr < K && v0 + vc < V)
          sv = S0[sbase + (size_t)kr * V + v0 + vc];
        sreg[j][e] = sv;
        if (j < nt) sst[kr * SS + vc] = sv;
      }
    }
    // the output tile's offsets: S (B of the carry-in), Aᵀ and v (A V)
    const int osb = q * SS + 8 * warp + g, oat = 2 * q * AS + 2 * g;
    const int ovo = 2 * q * SV + 8 * warp + g;
    __syncthreads();                            // chunk 0 is prepared
    for (int ci = 0; ci < nchunks; ++ci) {
      const int b = ci & 1, t0 = ci * CH;
      const float* vt = v_of(b);
      const float* scur = sst + b * KK * SS;
      float* snxt = sst + (b ^ 1) * KK * SS;
      float oacc[4] = {0.f, 0.f, 0.f, 0.f}, ocor[4] = {0.f, 0.f, 0.f, 0.f};
      if (warp >= NO) {
        // Aᵀ: levels 8 and 4 on the tensor cores (each writes its own
        // pairs), the pairs inside a sub-chunk and the bonus from the FMA
        // terms, summed over the producer warps in a fixed order
        float* at = at_of(b);
        if (warp < NO + 3) {
          const int L = A_TASKS[warp - NO][0];
          const int n0 = 8 * A_TASKS[warp - NO][3];
          const float* Xr = tile_of(b, A_TASKS[warp - NO][1]);
          const float* Xk = tile_of(b, A_TASKS[warp - NO][2]);
          const int ob0 = q * LT + n0 + g;
          const int ob1 = (q + 4) * LT + ((n0 + g) ^ 4);
          float d[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            float a[4], bb[2];
            lda_kt<LT>(a, Xr, oa0, oa1, s);
            ldb_ks<LT>(bb, Xk, ob0, ob1, s);
            mma_np<NPO>(d, c, a, bb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 2 * g + (e >> 1), sc = n0 + 2 * q + (e & 1);
            if (t > sc && (t ^ sc) >= L && (t ^ sc) < 2 * L)
              at[sc * AS + t] = d[e] + c[e];
          }
        } else {
          const float* part = part_of(b);
          for (int x = lane; x < SUB * NFMA; x += 32) {
            const int a = x / NFMA, i = x % NFMA;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w)
              sum += part[(w * SUB + a) * NFMA + i];
            if (i < NPAIR)
              at[(SUB * a + PAIRS[i][1]) * AS + SUB * a + PAIRS[i][0]] = sum;
            else
              bon_of(b)[SUB * a + i - NPAIR] = sum;
          }
        }
        at_ready_arrive();
      } else {                                  // the carry-in (r ⊙ F) S_in
        const float* r16 = tile_of(b, B_R16);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          float a[4], bb[2];
          lda_kt<LT>(a, r16, oa0, oa1, s);
          ldb_kn<SS>(bb, scur, osb, s);
          mma_np<NPO>(oacc, ocor, a, bb);
        }
      }
      const float* kc = tile_of(b, B_KC);
      const float* tot = tot_of(b);
#pragma unroll
      for (int j = 0; j < THI; ++j) {           // S = diag(Π w) S + ΔS
        if (j >= nt) break;
        float d[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < CH / 8; ++s) {
          float a[4], bb[2];
          lda_mt<LT>(a, kc, okc[j], s);
          ldb_tn<SV>(bb, vt, ov[j], s);
          mma_np<NPS>(d, c, a, bb);
        }
        const float w0 = tot[ot[j]], w1 = tot[ot[j] + 8];
        sreg[j][0] = fmaf(w0, sreg[j][0], d[0] + c[0]);
        sreg[j][1] = fmaf(w0, sreg[j][1], d[1] + c[1]);
        sreg[j][2] = fmaf(w1, sreg[j][2], d[2] + c[2]);
        sreg[j][3] = fmaf(w1, sreg[j][3], d[3] + c[3]);
        *reinterpret_cast<float2*>(snxt + os[j]) =
            make_float2(sreg[j][0], sreg[j][1]);
        *reinterpret_cast<float2*>(snxt + os[j] + 8 * SS) =
            make_float2(sreg[j][2], sreg[j][3]);
      }
      if (warp < NO) {                          // A V, the bonus, out
        at_ready_wait();
        const int n0 = 8 * warp;
        const float* at = at_of(b);
        const float* bon = bon_of(b);
#pragma unroll
        for (int s = 0; s < CH / 8; ++s) {
          float a[4], bb[2];
          lda_st<AS>(a, at, oat, s);
          ldb_tn<SV>(bb, vt, ovo, s);
          mma_np<NPO>(oacc, ocor, a, bb);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 2 * g + hf, vc = n0 + 2 * q;
          const float o0 = fmaf(bon[t], vt[t * SV + vc],
                                oacc[2 * hf] + ocor[2 * hf]);
          const float o1 = fmaf(bon[t], vt[t * SV + vc + 1],
                                oacc[2 * hf + 1] + ocor[2 * hf + 1]);
          if (t0 + t >= T_len) continue;
          T* out = O + vbase + (size_t)(t0 + t) * V + v0 + vc;
          if (pairs && v0 + vc + 1 < V) {
            store2(out, o0, o1);
          } else {
            if (v0 + vc < V) out[0] = from_f<T>(o0);
            if (v0 + vc + 1 < V) out[1] = from_f<T>(o1);
          }
        }
      }
      // chunk ci + 1 is prepared (the producer's last barrier is the one
      // before chunk nchunks - 1)
      if (ci + 1 < nchunks) __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < THI; ++j) {
      if (j >= nt) break;
      const int tj = j0 + j;
      const int m0 = 16 * (tj / NO), n0 = 8 * (tj % NO);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = m0 + g + 8 * (e >> 1), vc = n0 + 2 * q + (e & 1);
        if (kr < K && v0 + vc < V)
          ST[sbase + (size_t)kr * V + v0 + vc] = sreg[j][e];
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(DEC_THREADS, 4)
wkv6_decode_kernel(const T* __restrict__ R, const T* __restrict__ Kx,
                   const T* __restrict__ Vx, const T* __restrict__ W,
                   const float* __restrict__ U, const float* S0,
                   T* __restrict__ O, float* ST, int H, int T_len, int K,
                   int V, int ncols) {
  extern __shared__ __align__(16) float dsm[];
  float* rs = dsm;                 // [K]
  float* ks = rs + K;              // [K]
  float* ws = ks + K;              // [K]
  float* rus = ws + K;             // [K] r ⊙ u ⊙ k
  float* vs = rus + K;             // [ncols]
  float* part = vs + ncols;        // [groups][ncols]

  const int bh = blockIdx.y, h = bh % H;
  const int c0 = blockIdx.x * ncols;
  const int nc = min(ncols, V - c0);
  const int tid = threadIdx.x;
  const bool step = T_len > 0;
  for (int i = tid; i < K; i += DEC_THREADS) {
    const size_t o = (size_t)bh * K + i;
    const float r = step ? to_f(R[o]) : 0.f;
    const float k = step ? to_f(Kx[o]) : 0.f;
    rs[i] = r;
    ks[i] = k;
    ws[i] = step ? to_f(W[o]) : 1.f;
    rus[i] = r * U[(size_t)h * K + i] * k;
  }
  for (int i = tid; i < ncols; i += DEC_THREADS)
    vs[i] = (step && i < nc) ? to_f(Vx[(size_t)bh * V + c0 + i]) : 0.f;
  __syncthreads();

  // thread (row group rg, column group cg): VEC neighbouring columns of
  // rows rg, rg + groups, ...
  const int ncg = ncols / VEC, groups = DEC_THREADS / ncg;
  const int cg = tid % ncg, rg = tid / ncg, col = cg * VEC;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (rg < groups && col < nc) {
    for (int k = rg; k < K; k += groups) {
      const size_t o = ((size_t)bh * K + k) * V + c0 + col;
      float s[VEC];
      if constexpr (VEC == 4) {
        const float4 x = S0 != nullptr
                             ? *reinterpret_cast<const float4*>(S0 + o)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
      } else {
        s[0] = S0 != nullptr ? S0[o] : 0.f;
      }
      const float r = rs[k], w = ws[k], kk = ks[k];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[e] = fmaf(r, s[e], acc[e]);
        s[e] = fmaf(w, s[e], kk * vs[col + e]);
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(ST + o) = make_float4(s[0], s[1], s[2],
                                                         s[3]);
      } else {
        ST[o] = s[0];
      }
    }
  }
  if (rg < groups) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[rg * ncols + col + e] = acc[e];
  }
  __syncthreads();
  if (!step) return;
  for (int i = tid; i < nc; i += DEC_THREADS) {
    float o4[4] = {0.f, 0.f, 0.f, 0.f}, b4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gi = 0; gi < groups; ++gi) o4[gi & 3] += part[gi * ncols + i];
    for (int k = 0; k < K; ++k) b4[k & 3] += rus[k];
    const float o = (o4[0] + o4[1]) + (o4[2] + o4[3]);
    const float bonus = (b4[0] + b4[1]) + (b4[2] + b4[3]);
    O[(size_t)bh * V + c0 + i] = from_f<T>(fmaf(bonus, vs[i], o));
  }
}

// residency check and launch; the attributes and the occupancy are looked
// up once per instantiation (host work a call, not device work)
template <typename Kern>
int launch_checked(Kern kern, dim3 grid, int threads, size_t smem,
                   int per_sm, cudaStream_t st, int* cached_smem,
                   int* resident) {
  if ((int)smem != *cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern,
                                                          threads, smem);
    if (err != cudaSuccess) return (int)err;
    *cached_smem = (int)smem;
  }
  // the plan's grid is sized for per_sm blocks an SM
  if (*resident < per_sm) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T, int KK>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0, void* o,
                   float* sT, int BH, int H, int T_len, int K, int V,
                   int gx, int per_sm, cudaStream_t st) {
  auto kern = wkv6_chunked_kernel<T, KK>;
  const size_t smem = sizeof(float) * chunked_smem_floats<KK>();
  static int cached = -1, resident = 0;
  int err = launch_checked(kern, dim3(gx, BH), 2 * NT, smem, per_sm, st,
                           &cached, &resident);
  if (err) return err;
  kern<<<dim3(gx, BH), 2 * NT, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(o), sT, H, T_len, K, V);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_decode(const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* o, float* sT,
                  int BH, int H, int T_len, int K, int V, int gx, int ncols,
                  int per_sm, cudaStream_t st) {
  auto kern = wkv6_decode_kernel<T, VEC>;
  const int groups = DEC_THREADS / (ncols / VEC);
  const size_t smem = sizeof(float) * (4 * (size_t)K + ncols +
                                       (size_t)groups * ncols);
  static int cached = -1, resident = 0;
  int err = launch_checked(kern, dim3(gx, BH), DEC_THREADS, smem, per_sm, st,
                           &cached, &resident);
  if (err) return err;
  kern<<<dim3(gx, BH), DEC_THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(o), sT, H, T_len, K, V, ncols);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int route, int chunk, int sub, int kk, int vb, int vec, int gx,
        int smem, int per_sm, const void* r, const void* k, const void* v,
        const void* w, const float* u, const float* s0, void* o, float* sT,
        int BH, int H, int T_len, int K, int V, cudaStream_t st) {
  if (route == 0) {  // decode: vb state columns a block, vec a thread
    if (T_len > 1 || chunk != 1 || sub != 1 || kk != K ||
        (vec != 1 && vec != 4) || vb % vec || vb > DEC_COLS ||
        DEC_THREADS % (vb / vec) || gx != (V + vb - 1) / vb ||
        (size_t)smem != sizeof(float) * (4 * (size_t)K + vb +
                                         (size_t)(DEC_THREADS / (vb / vec)) *
                                             vb))
      return (int)cudaErrorInvalidValue;
    if (vec == 4) {
      if (V % 4 || (s0 != nullptr && reinterpret_cast<uintptr_t>(s0) % 16) ||
          reinterpret_cast<uintptr_t>(sT) % 16)
        return (int)cudaErrorInvalidValue;
      return launch_decode<T, 4>(r, k, v, w, u, s0, o, sT, BH, H, T_len, K,
                                 V, gx, vb, per_sm, st);
    }
    return launch_decode<T, 1>(r, k, v, w, u, s0, o, sT, BH, H, T_len, K, V,
                               gx, vb, per_sm, st);
  }
  if (route != 1 || chunk != CH || sub != SUB || vb != VB || vec != 1 ||
      gx != (V + VB - 1) / VB || T_len < 1)
    return (int)cudaErrorInvalidValue;

  if ((kk != 64 && kk != 128) ||
      (size_t)smem != sizeof(float) * (kk == 64 ? chunked_smem_floats<64>()
                                                : chunked_smem_floats<128>()))
    return (int)cudaErrorInvalidValue;
  if (kk == 64 && K <= 64)
    return launch_chunked<T, 64>(r, k, v, w, u, s0, o, sT, BH, H, T_len,
                                    K, V, gx, per_sm, st);
  if (kk == 128 && K > 64)
    return launch_chunked<T, 128>(r, k, v, w, u, s0, o, sT, BH, H, T_len,
                                     K, V, gx, per_sm, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// WKV6 over BH = B * H rows: r, k, w (BH, T, K) and v (BH, T, V) in the
// input type (`types` 0 = float, 1 = bf16), u (H, K) float (row bh uses
// head bh % H), s0 (BH, K, V) float or null for zeros; writes o (BH, T, V)
// in the input type and sT (BH, K, V) float.  All contiguous.  K must be a
// multiple of 8 and at most 128; BH at most 65535.  The launch runs on the
// plan of kernels/plan.py's wkv6_plan: `route` (0 decode, T <= 1; 1
// chunked), its `chunk` and `sub` steps, the padded head size `kk`, the
// state columns a block `vb`, the columns a decode thread `vec`, the grid's
// column blocks `gx`, the block's shared bytes `smem`, and the residency
// `per_sm` the grid was sized for, which the card must hold.
int repro_wkv6(int types, const void* r, const void* k, const void* v,
               const void* w, const float* u, const float* s0, void* o,
               float* sT, int BH, int H, int T_len, int K, int V, int route,
               int chunk, int sub, int kk, int vb, int vec, int gx, int smem,
               int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || V <= 0) return 0;
  if (K <= 0 || K % 8 || K > K_MAX || H <= 0 || BH % H || BH > 65535 ||
      T_len < 0 || per_sm < 1)
    return (int)cudaErrorInvalidValue;
  switch (types) {
    case 0:
      return run<float>(route, chunk, sub, kk, vb, vec, gx, smem, per_sm, r,
                        k, v, w, u, s0, o, sT, BH, H, T_len, K, V, st);
    case 1:
      return run<__nv_bfloat16>(route, chunk, sub, kk, vb, vec, gx, smem,
                                per_sm, r, k, v, w, u, s0, o, sT, BH, H,
                                T_len, K, V, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
