// Shared pieces of the blockwise attention kernels (attention.cu, the
// forward, and attention_bwd.cu, its gradient): loads of row tiles into
// float32 shared memory, the two register-tiled products every step runs,
// and the masks of the reference's _attn_block.
//
// Thread layout: 256 threads, ty = tid / 16 and tx = tid % 16.  A thread
// owns RI consecutive rows (RI * ty + i) of a tile and the columns tx + 16 j
// of them, so the 16 lanes that share ty -- one half-warp -- hold a whole
// row and reduce it with shuffles inside the half-warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int NT = 256;    // threads a block
constexpr int ROWS = 64;   // query rows (heads x positions) a tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dst[r][0, width) = the row r of a tile, float32, rows `ld` floats apart.
// Tile row r is source row (a, c) = (r % per, r / per) at src + a * sa +
// c * sb, present when a < lim_a and c < lim_b, else zero; its columns
// from `valid` (the head size) up to `width` (the compiled width) are
// zero too.  Both are multiples of 4 and each source row 4-element
// aligned: a thread reads four elements at a time, neighbouring threads
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          int width, int valid, const T* src,
                                          int per, long long sa,
                                          long long sb, int lim_a,
                                          int lim_b) {
  const int w4 = width / 4;
  for (int idx = threadIdx.x; idx < rows * w4; idx += NT) {
    const int r = idx / w4, c = (idx - r * w4) * 4;
    const int a = r % per, b = r / per;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a < lim_a && b < lim_b && c < valid)
      x = load4(src + a * sa + b * sb + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

// acc[i][j] += Σ_d a[i * lda + d] * b[16 j * ldb + d] over d < n (n a
// multiple of 4): rows of a against rows of b, both read as float4.  With
// lda, ldb = 4 (mod 32) words, the two ty of a warp and its 16 tx hit
// distinct banks.
template <int RI, int CJ>
__device__ __forceinline__ void dot_rows(float (&acc)[RI][CJ], const float* a,
                                         int lda, const float* b, int ldb,
                                         int n) {
#pragma unroll 2
  for (int d = 0; d < n; d += 4) {
    float4 av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * ldb + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += Σ_k a[i * lda + k] * b[k * ldb + 16 j] over k < n (n a
// multiple of 4): rows of a (float4 along k) times the columns 16 j of b
// (a thread's tx is already in b).
template <int RI, int CJ>
__device__ __forceinline__ void mul_rows(float (&acc)[RI][CJ], const float* a,
                                         int lda, const float* b, int ldb,
                                         int n) {
#pragma unroll 1
  for (int k = 0; k < n; k += 4) {
    float4 av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bv[j] = b[(k + kk) * ldb + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                      : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The masks of the reference's _attn_block for query position qp and key
// position kp: causal kp <= qp, window kp > qp - window, and kp below the
// row's valid keys (min(Tk, kv_valid[b])).
__device__ __forceinline__ bool visible(int qp, int kp, int kv_lim,
                                        int causal, int use_window,
                                        int window) {
  return kp < kv_lim && (!causal || kp <= qp) &&
         (!use_window || kp > qp - window);
}

// The compiled widths: a head size D (queries, keys) or Dv (values), a
// multiple of 4 up to 256, runs at the smallest of 32, 64, 128, 192, 256
// that holds max(D, Dv), its tiles' extra columns zero.
inline int width_class(int D, int Dv) {
  const int d = D > Dv ? D : Dv;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

inline bool head_size(int d) { return d > 0 && d % 4 == 0 && d <= 256; }

// keys a step of the forward and dQ blocks, and keys a dK / dV block, at
// width W (host and device)
__host__ __device__ constexpr int step_keys(int W) { return W <= 64 ? 64 : 32; }
__host__ __device__ constexpr int block_keys(int W) {
  return W <= 128 ? 64 : 32;
}

// Bytes of the blocks' shared arrays at width W, as kernels/plan.py's
// attention_plan counts them (rows padded by 4 floats).
inline size_t fwd_smem(int W) {
  const size_t bk = step_keys(W), w = W + 4;
  return sizeof(float) * (ROWS * w + 2 * bk * w + ROWS * (bk + 4));
}

inline size_t dq_smem(int W) {
  const size_t bk = step_keys(W), w = W + 4;
  return sizeof(float) * (2 * ROWS * w + 2 * bk * w + ROWS * (bk + 4) +
                          2 * ROWS);
}

inline size_t dkdv_smem(int W) {
  const size_t bn = block_keys(W), w = W + 4;
  return sizeof(float) * (2 * bn * w + 2 * ROWS * w +
                          2 * bn * (ROWS + 4) + 2 * ROWS);
}

// The plan's tiles for G heads a group: gt heads x bq positions a tile.
inline bool tiles_ok(int G, int gt, int bq) {
  return gt == (G < ROWS ? G : ROWS) && bq == ROWS / gt;
}

// The dynamic shared-memory attribute (past 48 KB) and the residency the
// plan was sized for; looked up once per instantiation and size.
template <typename Kern>
int prepare(Kern kern, size_t smem, int per_sm, int* cached_smem,
            int* resident) {
  if ((int)smem != *cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern, NT,
                                                          smem);
    if (err != cudaSuccess) return (int)err;
    *cached_smem = (int)smem;
  }
  if (*resident < per_sm) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

inline bool aligned(const void* p, int esz) {
  return reinterpret_cast<uintptr_t>(p) % (4 * (uintptr_t)esz) == 0;
}

}  // namespace attn
