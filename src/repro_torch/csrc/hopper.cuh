// Hopper primitives of the kernels that feed shared memory with TMA
// (mds_encode_gemm.cu, attention_mma.cu): mbarriers, TMA tile loads and
// libcuda's tensor-map encoder, reached through the runtime so that no
// library links -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mb_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mb_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared.b64 st, [%0];\n\t}\n"
      ::"r"(saddr(bar)) : "memory");
}
// the producer's arrival, announcing `bytes` of TMA traffic to come
__device__ __forceinline__ void mb_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared.b64 st, [%0], %1;\n\t}\n"
      ::"r"(saddr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mb_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}\n"
      ::"r"(saddr(bar)), "r"(parity) : "memory");
}
// one TMA box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
// the same from a 4-D tensor map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
