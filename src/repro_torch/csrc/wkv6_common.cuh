// Pieces shared by the WKV kernels (wkv6.cu, wkv6_bwd.cu): the input
// conversions, the decay clamp, and the TF32 tensor-core products that keep
// float32 accuracy by splitting an operand into its TF32 head and tail.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv {

// decays are clamped to w >= W_MIN, as the reference's log clamps them
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
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the TF32 head of x (its low 13 mantissa bits cleared); x - head is exact
__device__ __forceinline__ uint32_t head(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// x rounded to TF32 as the tensor core reads it (it ignores the low 13
// bits): half an ulp added; an exact bf16 value stays exact
__device__ __forceinline__ uint32_t rounded(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// d += a b for one k8 step in NP products: 1 -- both operands rounded to
// TF32; 2 -- a split head + tail against an exact b (a bf16 input);
// 3 -- both split, head head + head tail + tail head.  The tail products
// go to e, which the caller adds to d at the end.
template <int NP>
__device__ __forceinline__ void mma_np(float (&d)[4], float (&e)[4],
                                       const float (&a)[4],
                                       const float (&b)[2]) {
  uint32_t ah[4], bh[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) ah[i] = NP == 1 ? rounded(a[i]) : head(a[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bh[i] = NP == 1 ? rounded(b[i])
                    : NP == 3 ? head(b[i]) : __float_as_uint(b[i]);
  if constexpr (NP >= 2) {
    uint32_t al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      al[i] = __float_as_uint(a[i] - __uint_as_float(ah[i]));
    mma(e, al, bh);
  }
  if constexpr (NP == 3) {
    uint32_t bl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      bl[i] = __float_as_uint(b[i] - __uint_as_float(bh[i]));
    mma(e, ah, bl);
  }
  mma(d, ah, bh);
}

}  // namespace wkv
