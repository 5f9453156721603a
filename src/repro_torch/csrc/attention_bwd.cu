// Blockwise softmax attention for Hopper (sm_90a): the backward.
//
// Replaces no Pallas kernel: the reference takes the gradient of its jnp
// blockwise repro/models/attention.py::flash_attention by jax's autodiff
// of the scan.  Here, from the forward's output O and row log-sum-exp L
// (csrc/attention.cu) and the output's cotangent dO, the FlashAttention-2
// backward (Dao, "FlashAttention-2: Faster Attention with Better
// Parallelism and Work Partitioning"), recomputing P from L:
//
//     D_i  = Σ_c dO[i, c] O[i, c]
//     P_ij = exp(scale q_i · k_j - L_i)      (0 where masked, or L_i = -inf)
//     dV_j = Σ_i P_ij dO_i       dS_ij = P_ij (dO_i · v_j - D_i)
//     dQ_i = scale Σ_j dS_ij k_j  dK_j = scale Σ_i dS_ij q_i
//
// Two kernels, launched in this order by one call:
//
// * attention_dq_kernel: a block per query tile (the forward's tiles: gt
//   heads x bq positions of one kv head, 64 rows).  It computes D_i of its
//   rows from dO and O (and writes them for the next kernel), then steps
//   through the keys the tile sees, bk a step: S and dP = dO Vᵀ (4 rows x
//   bk / 16 keys a thread), dS into shared memory, dQ += dS K in registers.
// * attention_dkdv_kernel: a block per (bn keys, kv head, batch row).  It
//   steps through every query tile of the kv head's G query heads that can
//   see its keys (causal: from the first key's position; window: up to the
//   last key's position + window): Sᵀ and dPᵀ (bn / 16 keys x 4 rows a
//   thread), P and dS into shared memory, dV += Pᵀ dO and dK += dSᵀ Q in
//   registers.
//
// No atomics: every entry of dQ, dK and dV is summed by one thread in a
// fixed order, so repeated calls are bit-equal.  Sums are float32; dq, dk
// and dv are written in the input type.
//
// What bounds it: per visible pair 2 (2 D + 2 Dv) operations at least (the
// four products; the recomputed S and, in the dQ pass, the second dP are
// extra), on the FP32 pipe in this first kernel; `wgmma` and TMA are the
// next step.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int W>
__global__ void __launch_bounds__(NT, 2)
    attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const int* __restrict__ kv_valid, T* __restrict__ dq,
                        float* __restrict__ di_out, int Tq, int Tk, int Hq,
                        int Hkv, int D, int Dv, int gt, int bq, int causal,
                        int use_window, int window, int q_offset,
                        float scale) {
  constexpr int BK = step_keys(W);   // keys a step
  constexpr int KN = BK / 16;        // keys a thread
  constexpr int CJ = W / 16;         // dQ columns a thread
  constexpr int ld = W + 4, ldp = BK + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm;
  float* dOs = Qs + ROWS * ld;
  float* Ks = dOs + ROWS * ld;
  float* Vs = Ks + BK * ld;
  float* dSs = Vs + BK * ld;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = Hq / Hkv, nhc = (G + gt - 1) / gt;
  const int hkv = blockIdx.y / nhc, g0 = (blockIdx.y % nhc) * gt;
  const int gn = min(gt, G - g0), h0 = hkv * G + g0;
  const int b = blockIdx.z, t0 = blockIdx.x * bq, tn = min(bq, Tq - t0);

  const int kv_lim = kv_valid ? min(Tk, kv_valid[b]) : Tk;
  int hi = kv_lim;
  if (causal) hi = min(hi, q_offset + t0 + tn);
  const int lo = use_window ? max(0, q_offset + t0 - window + 1) : 0;

  const long long row0 = ((long long)b * Tq + t0) * Hq + h0;
  load_tile(Qs, ld, ROWS, W, D, q + row0 * D, bq, (long long)Hq * D, D, tn,
            gn);
  load_tile(dOs, ld, ROWS, W, Dv, dout + row0 * Dv, bq, (long long)Hq * Dv,
            Dv, tn, gn);
  __syncthreads();

  // D_i = dO_i · O_i and L_i of the thread's rows
  float di[4], ls[4];
  int qp[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, g = r / bq, t = r % bq;
    live[i] = g < gn && t < tn;
    qp[i] = q_offset + t0 + t;
    float part = 0.f;
    if (live[i]) {
      const T* orow = o + (row0 + (long long)t * Hq + g) * Dv;
      for (int c = 4 * tx; c < Dv; c += 64) {
        const float4 ov = load4(orow + c);
        const float4 gv = *reinterpret_cast<const float4*>(dOs + r * ld + c);
        part += gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w;
      }
    }
    di[i] = half_sum(part);
    const long long li = ((long long)b * Hq + h0 + g) * Tq + t0 + t;
    ls[i] = live[i] ? lse[li] : -INFINITY;
    if (live[i] && tx == 0) di_out[li] = di[i];
    // a row that sees no key has P = 0 throughout
    if (ls[i] == -INFINITY) live[i] = false;
  }

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    load_tile(Ks, ld, BK, W, D, k + (((long long)b * Tk + k0) * Hkv + hkv) * D,
              BK, (long long)Hkv * D, 0, Tk - k0, 1);
    load_tile(Vs, ld, BK, W, Dv,
              v + (((long long)b * Tk + k0) * Hkv + hkv) * Dv, BK,
              (long long)Hkv * Dv, 0, Tk - k0, 1);
    __syncthreads();
    float s[4][KN], dp[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<4, KN>(s, Qs + 4 * ty * ld, ld, Ks + tx * ld, ld, D);
    dot_rows<4, KN>(dp, dOs + 4 * ty * ld, ld, Vs + tx * ld, ld, Dv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = live[i] && visible(qp[i], kp, kv_lim, causal,
                                           use_window, window)
                            ? expf(s[i][j] * scale - ls[i])
                            : 0.f;
        dSs[(4 * ty + i) * ldp + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    __syncthreads();
    mul_rows<4, CJ>(acc, dSs + 4 * ty * ldp, ldp, Ks + tx, ld, BK);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, g = r / bq, t = r % bq;
    if (g >= gn || t >= tn) continue;
    T* row = dq + (row0 + (long long)t * Hq + g) * D;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      if (tx + 16 * j < D) store1(row + tx + 16 * j, acc[i][j] * scale);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(NT, 1)
    attention_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lse,
                          const T* __restrict__ dout,
                          const float* __restrict__ di,
                          const int* __restrict__ kv_valid,
                          T* __restrict__ dk, T* __restrict__ dv, int Tq,
                          int Tk, int Hq, int Hkv, int D, int Dv, int gt,
                          int bq, int causal, int use_window, int window,
                          int q_offset, float scale) {
  constexpr int BN = block_keys(W);   // keys a block
  constexpr int RI = BN / 16;         // keys a thread
  constexpr int CJ = W / 16;          // dK and dV columns a thread
  constexpr int ld = W + 4, ldr = ROWS + 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Ks = sm;
  float* Vs = Ks + BN * ld;
  float* Qs = Vs + BN * ld;
  float* dOs = Qs + ROWS * ld;
  float* Ps = dOs + ROWS * ld;
  float* dSs = Ps + BN * ldr;
  float* Ls = dSs + BN * ldr;
  float* Dis = Ls + ROWS;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int G = Hq / Hkv, nhc = (G + gt - 1) / gt;
  const int hkv = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BN;
  const int kn = min(BN, Tk - k0);
  const int kv_lim = kv_valid ? min(Tk, kv_valid[b]) : Tk;
  const int k_end = min(k0 + kn, kv_lim);

  float ak[RI][CJ], av[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // the query positions that see a key of [k0, k_end)
  const int t_lo = causal ? max(0, k0 - q_offset) : 0;
  const int t_hi = use_window ? min(Tq, k_end - 1 + window - q_offset) : Tq;
  if (k_end > k0 && t_lo < t_hi) {
    load_tile(Ks, ld, BN, W, D, k + (((long long)b * Tk + k0) * Hkv + hkv) * D,
              BN, (long long)Hkv * D, 0, kn, 1);
    load_tile(Vs, ld, BN, W, Dv,
              v + (((long long)b * Tk + k0) * Hkv + hkv) * Dv, BN,
              (long long)Hkv * Dv, 0, kn, 1);
    for (int hc = 0; hc < nhc; ++hc) {
      const int g0 = hc * gt, gn = min(gt, G - g0), h0 = hkv * G + g0;
      for (int t0 = t_lo; t0 < t_hi; t0 += bq) {
        const int tn = min(bq, t_hi - t0);
        const long long row0 = ((long long)b * Tq + t0) * Hq + h0;
        __syncthreads();  // the previous tile's readers are done
        load_tile(Qs, ld, ROWS, W, D, q + row0 * D, bq, (long long)Hq * D, D,
                  tn, gn);
        load_tile(dOs, ld, ROWS, W, Dv, dout + row0 * Dv, bq,
                  (long long)Hq * Dv, Dv, tn, gn);
        for (int r = tid; r < ROWS; r += NT) {
          const int g = r / bq, t = r % bq;
          const long long li = ((long long)b * Hq + h0 + g) * Tq + t0 + t;
          const bool ok = g < gn && t < tn;
          Ls[r] = ok ? lse[li] : -INFINITY;
          Dis[r] = ok ? di[li] : 0.f;
        }
        __syncthreads();
        float s[RI][4], dp[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
        dot_rows<RI, 4>(s, Ks + RI * ty * ld, ld, Qs + tx * ld, ld, D);
        dot_rows<RI, 4>(dp, Vs + RI * ty * ld, ld, dOs + tx * ld, ld, Dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qp = q_offset + t0 + r % bq;
          const float L = Ls[r], Di = Dis[r];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const int kp = k0 + RI * ty + i;
            const float p = L != -INFINITY &&
                                    visible(qp, kp, k_end, causal,
                                            use_window, window)
                                ? expf(s[i][j] * scale - L)
                                : 0.f;
            Ps[(RI * ty + i) * ldr + r] = p;
            dSs[(RI * ty + i) * ldr + r] = p * (dp[i][j] - Di);
          }
        }
        __syncthreads();
        mul_rows<RI, CJ>(av, Ps + RI * ty * ldr, ldr, dOs + tx, ld, ROWS);
        mul_rows<RI, CJ>(ak, dSs + RI * ty * ldr, ldr, Qs + tx, ld, ROWS);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = RI * ty + i;
    if (key >= kn) continue;
    const long long row = ((long long)b * Tk + k0 + key) * Hkv + hkv;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store1(dk + row * D + c, ak[i][j] * scale);
      if (c < Dv) store1(dv + row * Dv + c, av[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int* kv_valid;
  void *dq, *dk, *dv;
  float* di;
  int B, Tq, Tk, Hq, Hkv, D, Dv, gt, bq, causal, use_window, window,
      q_offset;
  float scale;
  int dq_per_sm, dkdv_per_sm;
  cudaStream_t st;
};

template <typename T, int W>
int launch(const Args& a) {
  const int G = a.Hq / a.Hkv;
  {
    auto kern = attention_dq_kernel<T, W>;
    static int cached = -1, resident = 0;
    const size_t smem = dq_smem(W);
    int err = prepare(kern, smem, a.dq_per_sm, &cached, &resident);
    if (err) return err;
    const dim3 grid((a.Tq + a.bq - 1) / a.bq,
                    a.Hkv * ((G + a.gt - 1) / a.gt), a.B);
    kern<<<grid, NT, smem, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.o), a.lse,
        static_cast<const T*>(a.dout), a.kv_valid, static_cast<T*>(a.dq),
        a.di, a.Tq, a.Tk, a.Hq, a.Hkv, a.D, a.Dv, a.gt, a.bq, a.causal,
        a.use_window, a.window, a.q_offset, a.scale);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  auto kern = attention_dkdv_kernel<T, W>;
  static int cached = -1, resident = 0;
  const size_t smem = dkdv_smem(W);
  int err = prepare(kern, smem, a.dkdv_per_sm, &cached, &resident);
  if (err) return err;
  const dim3 grid((a.Tk + block_keys(W) - 1) / block_keys(W), a.Hkv, a.B);
  kern<<<grid, NT, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lse, static_cast<const T*>(a.dout), a.di,
      a.kv_valid, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Tq, a.Tk,
      a.Hq, a.Hkv, a.D, a.Dv, a.gt, a.bq, a.causal, a.use_window, a.window,
      a.q_offset, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run(int W, const Args& a) {
  switch (W) {
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 192: return launch<T, 192>(a);
    case 256: return launch<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Attention backward: q, k, v as the forward's, o (B, Tq, Hq, Dv) its
// output and dout the output's cotangent, both in the input type (`types`
// 0 = float, 1 = bf16), lse (B, Hq, Tq) float its rows' log-sum-exp,
// kv_valid (B,) int32 or null; writes dq, dk, dv (the shapes of q, k, v,
// input type) and di (B, Hq, Tq) float (D_i, a scratch of the two
// kernels).  Tq and Tk at least 1 (the wrapper fills empty gradients
// itself).  All contiguous, rows 4-element aligned.  The plan's numbers
// (kernels/plan.py attention_plan): `width`, `gt`, `bq`, `bk` as the
// forward's, the dK / dV block's keys `bn`, `threads`, each kernel's
// shared bytes and residency; each is checked against what the kernels
// were built for.
int repro_attention_bwd(int types, const void* q, const void* k,
                        const void* v, const void* o, const float* lse,
                        const void* dout, const int* kv_valid, void* dq,
                        void* dk, void* dv, float* di, int B, int Tq, int Tk,
                        int Hq, int Hkv, int D, int Dv, int causal,
                        int use_window, int window, int q_offset, float scale,
                        int width, int gt, int bq, int bk, int bn,
                        int threads, int dq_smem_bytes, int dkdv_smem_bytes,
                        int dq_per_sm, int dkdv_per_sm, void* stream) {
  if (B <= 0) return 0;
  const int esz = types == 0 ? 4 : 2;
  if ((types != 0 && types != 1) || !head_size(D) || !head_size(Dv) ||
      Hkv <= 0 || Hq % Hkv || Tq <= 0 || Tk <= 0 || B > 65535 ||
      dq_per_sm < 1 || dkdv_per_sm < 1 || width != width_class(D, Dv) ||
      !tiles_ok(Hq / Hkv, gt, bq) || bk != step_keys(width) ||
      bn != block_keys(width) || threads != NT ||
      (size_t)dq_smem_bytes != dq_smem(width) ||
      (size_t)dkdv_smem_bytes != dkdv_smem(width) ||
      (long long)Hkv * ((Hq / Hkv + gt - 1) / gt) > 65535 ||
      !aligned(q, esz) || !aligned(k, esz) || !aligned(v, esz) ||
      !aligned(o, esz) || !aligned(dout, esz) || !aligned(dq, esz) ||
      !aligned(dk, esz) || !aligned(dv, esz))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, kv_valid, dq, dk, dv, di, B, Tq, Tk,
               Hq, Hkv, D, Dv, gt, bq, causal, use_window, window, q_offset,
               scale, dq_per_sm, dkdv_per_sm,
               static_cast<cudaStream_t>(stream)};
  return types == 0 ? run<float>(width, a) : run<__nv_bfloat16>(width, a);
}

}  // extern "C"
