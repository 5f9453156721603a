// Blockwise softmax attention for Hopper (sm_90a): the forward.
//
// Replaces no Pallas kernel: the reference's attention is jnp, the
// blockwise online softmax repro/models/attention.py::flash_attention
// (masks in _attn_block), which every attention layer of the port runs
// for prefill and training (GQA with its sliding window, MLA with Dk 192 /
// Dv 128 and its own scale, cross-attention and the encoder, non-causal
// with Tq != Tk).  It is a kernel here because the plain version keeps a
// (T, T) score tensor or a Python loop of blocks: one 32 768-token
// llama3.2-1b layer's float32 scores alone are 128 GiB.
//
// For q (B, Tq, Hq, D), k (B, Tk, Hkv, D), v (B, Tk, Hkv, Dv) in the input
// type, G = Hq / Hkv query heads a kv head:
//
//     o[b, t, h] = Σ_j softmax_j(scale q[b, t, h] · k[b, j, g]) v[b, j, g]
//     with g = h / G
//
// over the keys j that the causal (j <= q_offset + t), window (j >
// q_offset + t - window) and kv_valid (j < kv_valid[b]) masks leave; a row
// that sees no key is 0.  It also writes the rows' log-sum-exp (B, Hq, Tq)
// float32 (-inf for such a row), which the backward reads.
//
// What bounds it on this card: per visible (query, key) pair 2 (D + Dv)
// operations against the q, k, v and o bytes once each -- a prefill of T
// tokens does O(T²) operations on O(T) bytes, so it is bound by
// operations.  This first kernel runs them on the FP32 pipe (SIMT), not
// on the tensor cores; `wgmma` and TMA are the next step.
//
// Design: one block per (query tile, kv head and head chunk, batch row).
// A tile is 64 query rows: gt of the group's heads x bq positions (gt * bq
// <= 64), so one K / V tile serves every query head of its kv head, as the
// reference's (B, Hkv, G, T, D) layout does.  The block visits only the
// keys its rows can see -- from max(0, first position - window + 1) to the
// causal / kv_valid end -- bk keys a step, so a windowed prefill costs
// O(T W) and a causal one half the square.  A step loads K and V (float32
// in shared memory), forms S = scale Q Kᵀ (4 rows x bk / 16 keys a
// thread), masks it, updates each row's running max m, denominator l and
// numerator O (registers) with the online softmax, writes P = exp(S - m)
// to shared memory and adds P V.  A row whose running max is still -inf
// takes its correction and P as 0 (the reference's exp(-inf + inf) is NaN
// there).  Out: O / max(l, 1e-30), the reference's, in the input type.
// Every sum is in a fixed order: repeated calls are bit-equal.  Head sizes
// D and Dv (multiples of 4 up to 256: the smoke configs' 16, MLA's 192 /
// 128) run at a compiled width W, the smallest of 32, 64, 128, 192 and
// 256 that holds both; a tile's columns past its head size are zero.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int W>
__global__ void __launch_bounds__(NT, 2)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_valid, T* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int Hq,
                         int Hkv, int D, int Dv, int gt, int bq, int causal,
                         int use_window, int window, int q_offset,
                         float scale) {
  constexpr int BK = step_keys(W);   // keys a step
  constexpr int KN = BK / 16;        // keys a thread
  constexpr int CJ = W / 16;         // output columns a thread
  constexpr int ld = W + 4, ldp = BK + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm;
  float* Ks = Qs + ROWS * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = Hq / Hkv, nhc = (G + gt - 1) / gt;
  const int hkv = blockIdx.y / nhc, g0 = (blockIdx.y % nhc) * gt;
  const int gn = min(gt, G - g0), h0 = hkv * G + g0;
  const int b = blockIdx.z, t0 = blockIdx.x * bq, tn = min(bq, Tq - t0);

  // the keys any row of the tile can see
  const int kv_lim = kv_valid ? min(Tk, kv_valid[b]) : Tk;
  int hi = kv_lim;
  if (causal) hi = min(hi, q_offset + t0 + tn);
  const int lo = use_window ? max(0, q_offset + t0 - window + 1) : 0;

  load_tile(Qs, ld, ROWS, W, D, q + (((long long)b * Tq + t0) * Hq + h0) * D,
            bq, (long long)Hq * D, D, tn, gn);

  float m[4], l[4], acc[4][CJ];
  int qp[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, t = r % bq;
    live[i] = r / bq < gn && t < tn;
    qp[i] = q_offset + t0 + t;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous step's readers are done
    load_tile(Ks, ld, BK, W, D, k + (((long long)b * Tk + k0) * Hkv + hkv) * D,
              BK, (long long)Hkv * D, 0, Tk - k0, 1);
    load_tile(Vs, ld, BK, W, Dv,
              v + (((long long)b * Tk + k0) * Hkv + hkv) * Dv, BK,
              (long long)Hkv * Dv, 0, Tk - k0, 1);
    __syncthreads();

    float s[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
    dot_rows<4, KN>(s, Qs + 4 * ty * ld, ld, Ks + tx * ld, ld, D);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kp = k0 + tx + 16 * j;
        s[i][j] = live[i] && visible(qp[i], kp, kv_lim, causal, use_window,
                                     window)
                      ? s[i][j] * scale
                      : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      // a row with nothing seen yet: corr and p are 0, not NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    mul_rows<4, CJ>(acc, Ps + 4 * ty * ldp, ldp, Vs + tx, ld, BK);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = 4 * ty + i, g = r / bq, t = t0 + r % bq;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * Tq + t) * Hq + h0 + g) * Dv;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      if (tx + 16 * j < Dv) store1(orow + tx + 16 * j, acc[i][j] / den);
    if (tx == 0)
      lse[((long long)b * Hq + h0 + g) * Tq + t] =
          l[i] > 0.f ? (m[i] == -INFINITY ? 0.f : m[i]) + logf(den)
                     : -INFINITY;
  }
}

template <typename T, int W>
int launch(const void* q, const void* k, const void* v, const int* kv_valid,
           void* o, float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
           int D, int Dv, int gt, int bq, int causal, int use_window,
           int window, int q_offset, float scale, int per_sm,
           cudaStream_t st) {
  auto kern = attention_fwd_kernel<T, W>;
  static int cached = -1, resident = 0;
  const size_t smem = fwd_smem(W);
  int err = prepare(kern, smem, per_sm, &cached, &resident);
  if (err) return err;
  const int G = Hq / Hkv;
  const dim3 grid((Tq + bq - 1) / bq, Hkv * ((G + gt - 1) / gt), B);
  kern<<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(o), lse, Tq, Tk, Hq,
      Hkv, D, Dv, gt, bq, causal, use_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int W, const void* q, const void* k, const void* v,
        const int* kv_valid, void* o, float* lse, int B, int Tq, int Tk,
        int Hq, int Hkv, int D, int Dv, int gt, int bq, int causal,
        int use_window, int window, int q_offset, float scale, int per_sm,
        cudaStream_t st) {
#define ATTN_FWD(WW)                                                       \
  return launch<T, WW>(q, k, v, kv_valid, o, lse, B, Tq, Tk, Hq, Hkv, D,  \
                       Dv, gt, bq, causal, use_window, window, q_offset,  \
                       scale, per_sm, st)
  switch (W) {
    case 32: ATTN_FWD(32);
    case 64: ATTN_FWD(64);
    case 128: ATTN_FWD(128);
    case 192: ATTN_FWD(192);
    case 256: ATTN_FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ATTN_FWD
}

}  // namespace

extern "C" {

// Attention forward: q (B, Tq, Hq, D), k (B, Tk, Hkv, D), v (B, Tk, Hkv,
// Dv) in the input type (`types` 0 = float, 1 = bf16), kv_valid (B,) int32
// or null; writes o (B, Tq, Hq, Dv) in the input type and lse (B, Hq, Tq)
// float.  All contiguous, rows 4-element aligned.  D and Dv multiples of 4
// up to 256; Hq a multiple of Hkv; `use_window` 1 masks keys at or before
// position - window.  The launch runs on the plan of kernels/plan.py's
// attention_plan: the compiled width `width` (32, 64, 128, 192 or 256, the
// smallest that holds D and Dv), `gt` heads x `bq` positions a tile, `bk`
// keys a step, `threads`, the block's shared bytes `smem` and the
// residency `per_sm` the card must hold for it; each is checked against
// what the kernel was built for.
int repro_attention(int types, const void* q, const void* k, const void* v,
                    const int* kv_valid, void* o, float* lse, int B, int Tq,
                    int Tk, int Hq, int Hkv, int D, int Dv, int causal,
                    int use_window, int window, int q_offset, float scale,
                    int width, int gt, int bq, int bk, int threads, int smem,
                    int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tq <= 0) return 0;
  const int esz = types == 0 ? 4 : 2;
  if ((types != 0 && types != 1) || !head_size(D) || !head_size(Dv) ||
      Hkv <= 0 || Hq % Hkv || Tk < 0 || B > 65535 || per_sm < 1 ||
      width != width_class(D, Dv) || !tiles_ok(Hq / Hkv, gt, bq) ||
      bk != step_keys(width) || threads != NT ||
      (size_t)smem != fwd_smem(width) ||
      (long long)Hkv * ((Hq / Hkv + gt - 1) / gt) > 65535 ||
      !aligned(q, esz) || !aligned(k, esz) || !aligned(v, esz) ||
      !aligned(o, esz))
    return (int)cudaErrorInvalidValue;
  if (types == 0)
    return run<float>(width, q, k, v, kv_valid, o, lse, B, Tq, Tk, Hq, Hkv,
                      D, Dv, gt, bq, causal, use_window, window, q_offset,
                      scale, per_sm, st);
  return run<__nv_bfloat16>(width, q, k, v, kv_valid, o, lse, B, Tq, Tk, Hq,
                            Hkv, D, Dv, gt, bq, causal, use_window, window,
                            q_offset, scale, per_sm, st);
}

}  // extern "C"
