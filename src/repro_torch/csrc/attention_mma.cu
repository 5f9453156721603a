// Blockwise softmax attention for Hopper (sm_90a): the forward on the
// tensor cores, for bfloat16 q, k, v at head widths 64-256.
//
// Replaces no Pallas kernel: the reference's attention is jnp, the
// blockwise online softmax repro/models/attention.py::flash_attention
// (masks in _attn_block).  attention.cu is the port's first kernel for it
// (SIMT, on the FP32 pipe); this one takes every bfloat16 call whose head
// sizes D (queries, keys) and Dv (values) are multiples of 16 up to 256
// with the larger above 32 -- llama3.2-1b and seamless at 64; dbrx,
// internvl2, glm4, jamba and nemotron at 128; DeepSeek-V3's MLA at 192 /
// 128; gemma3-12b at 256 -- and attention.cu keeps float32 and the smoke
// configs' heads of 16 and 24.  It computes what attention.cu computes
// (see there: the masks, rows that see no key, the log-sum-exp the
// backward reads) with two differences of arithmetic: P enters P V as the
// sum of two bf16 parts, hi = P cut to bf16 (its top 16 bits) and lo = P
// - hi cut likewise, together within 2^-16 of P (one part alone, as a
// TPU's MXU takes the reference's float32 p @ v at JAX's default
// precision, moves a row that sees few keys by a bf16 step of its output
// and misses the gate against float32 P), and the exponentials are exp2
// of scores scaled by scale * log2(e).
// kernels/ref.py::attention_mma_ref is its plain twin.
//
// What bounds it on this card: per visible (query, key) pair 2 (D + Dv)
// operations against the q, k, v and o bytes once each, so a prefill is
// bound by the bf16 tensor cores (989 TFLOP/s); the two parts of P make
// them run 2 (D + 2 Dv) a pair.  Measured on an H100 (see PERF.md), the
// softmax's instructions and the products of the warpgroups that share
// an SM sub-partition hardly overlap: at D = 64 the
// ~8 instructions a score cost about as much as its products, which
// bounds this kernel near half the tensor cores' rate.
//
// Design (FlashAttention-3's forward, simplified): one block per query
// tile of 64 NWG rows -- gt of a kv head's G query heads x bq positions,
// position-major, so one K / V tile serves the whole GQA group -- and
// per tile the keys its masks leave, BK a step, steps aligned to
// multiples of BK (a row's result is then the same in any tile, and a
// step whose keys a row cannot see leaves that row exactly as it was).
// NWG consumer warpgroups own 64 rows each; the last warpgroup is the
// producer, of which one thread loads Q once, then K and V tiles into a
// ring of ST stages with TMA (4-D tensor maps over (D, H, T, B),
// 64-column boxes in the 128-byte swizzle, zeros past T and past the head
// size), handing a stage's K and its V over through mbarriers of their
// own and taking it back through an empty one.  setmaxnreg moves the
// producers' registers to the consumers: ptxas grants a block of 128
// (NWG + 1) threads 65 536 / (128 (NWG + 1)) registers a thread (168 at
// NWG = 2, 128 at 3), of which the producers keep 24 (a single producer
// warp gets no more: its pool would hold too few for the consumers).  A
// consumer warpgroup forms S = Q Kᵀ with wgmma (m64 n BK k16, both
// operands from shared memory, K-major, float32 accumulators), masks it
// only on steps that cross the causal diagonal, the window's lower edge
// or kv_valid, and runs the online softmax on the accumulator fragment in
// log2 units (a row's max and sum as pairwise trees, then over the four
// lanes that share the row; a row whose running max is still -inf takes
// its correction and P as 0; O is scaled only where a row's max moved).
// P's two bf16 parts stay in registers, laid out as wgmma's register A
// operand, and O += P V is two more wgmmas a k16 step with V read
// through the descriptor's MN-major (transposed) form.  A step's products
// go out as one batch, S_j with P_{j-1} V_{j-1}, so the tensor cores work
// through the other warpgroups' batches while one runs its softmax.  The
// epilogue writes O / max(l, 1e-30) in bf16 and the rows' log-sum-exp.
// Tiles are launched heaviest first (under a causal mask the last query
// tiles see the most keys).  Every sum runs in a fixed order: repeated
// calls are bit-equal.
//
// Compiled shapes (DC, VC) = 64-column chunks of D and Dv: (1, 1), (2,
// 2), MLA's (3, 2), (3, 3) and (4, 4); kernels/plan.py's
// attention_mma_plan picks one (other pairs run at the square of the
// larger, the extra columns zero), NWG (3 at one chunk: a thread's 160
// registers hold S, P and O at BK 96; else 2), BK (96 at one chunk, 128
// at two, else 64) and ST (the stages that fit 200 KB of shared memory,
// at most 4).

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int PRODUCER_REGS = 24;
constexpr int SMEM_BUDGET = 204800;
constexpr float LN2 = 0.693147180559945309f;

// NWG consumer warpgroups of 64 query rows and a producer warpgroup; ptxas
// grants the block's threads 65 536 / THREADS registers each (a multiple
// of 8), and setmaxnreg moves all but PRODUCER_REGS of the producers' to
// the consumers.
template <int DC, int VC, int BK, int NWG>
struct Cfg {
  static constexpr int ROWS = 64 * NWG;           // query rows a block
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int CONSUMER_REGS =
      (REGS * THREADS - 128 * PRODUCER_REGS) / CONSUMERS / 8 * 8;
  static constexpr int Q_CHUNK = ROWS * 128;  // a 64-column chunk of Q
  static constexpr int K_BYTES = DC * BK * 128, V_BYTES = VC * BK * 128;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int Q_BYTES = DC * Q_CHUNK;
  static constexpr int ST_FIT = (SMEM_BUDGET - 1024 - Q_BYTES) / STAGE;
  static constexpr int ST = ST_FIT < 4 ? ST_FIT : 4;
  static constexpr int SMEM = 1024 + Q_BYTES + ST * STAGE;  // + alignment
  static constexpr int NS = BK / 2;    // S accumulators a thread
  static constexpr int NO = VC * 32;   // O accumulators a thread
  static_assert(ST >= 2, "a ring of at least two stages");
  static_assert(CONSUMER_REGS <= 256, "no more than 256 registers");
};

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units).  The
// address sits in the low 14 bits, so a descriptor plus (bytes >> 4)
// describes the tile that many bytes on, inside shared memory.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo,
                                         unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma's accumulators across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D (+)= A B over k16 for a 64-row warpgroup tile, float32 accumulators:
// mma_ss with A and B from shared memory (both K-major), scale_d 0 to
// overwrite D; mma_rs with A from registers (bf16 pairs, mma.sync's A
// fragment) and B MN-major.
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                       int scale_d);
template <int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                       uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<96>(float (&d)[48], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<192>(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<256>(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The max (or sum) of a thread's NS / 2 entries of row r0 + 8 H, as a
// pairwise tree (no chain of NS / 2 dependent steps; a fixed order) over
// entries LO .. LO + N - 1: entry j is 4 (j / 2) + 2 H + j % 2 of the
// accumulator (element 4 i + e is row r0 + 8 (e >> 1), key 8 i + 2 (lane
// % 4) + (e & 1) of the step).
template <int NS, int H, bool SUM, int LO = 0, int N = NS / 2>
__device__ __forceinline__ float row_tree(const float (&s)[NS]) {
  if constexpr (N == 1) {
    return s[4 * (LO >> 1) + 2 * H + (LO & 1)];
  } else {
    const float a = row_tree<NS, H, SUM, LO, N / 2>(s);
    const float b = row_tree<NS, H, SUM, LO + N / 2, N - N / 2>(s);
    return SUM ? a + b : fmaxf(a, b);
  }
}

// -inf at the keys a row cannot see (past its valid keys, after its
// position when causal, at or before position - window): the steps that
// cross an edge.  Key kc + 8 i + (e & 1) of entry 4 i + e.
template <int NS>
__device__ __forceinline__ void mask_scores(float (&s)[NS], int kc,
                                            const int (&qp)[2], int kv_lim,
                                            int causal, int use_window,
                                            int window) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = kc + 8 * i + (e & 1), h = e >> 1;
      if (!(kp < kv_lim && (!causal || kp <= qp[h]) &&
            (!use_window || kp > qp[h] - window)))
        s[4 * i + e] = -INFINITY;
    }
}

template <int DC, int VC, int BK, int NWG>
__global__ void __launch_bounds__(Cfg<DC, VC, BK, NWG>::THREADS, 1)
    attention_mma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const int* __restrict__ kv_valid,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int B, int Tq, int Tk,
                         int Hq, int Hkv, int Dv, int gt, int bq, int causal,
                         int use_window, int window, int q_offset,
                         float scale_log2) {
  using C = Cfg<DC, VC, BK, NWG>;
  constexpr int ROWS = C::ROWS, CONSUMERS = C::CONSUMERS;
  constexpr int THREADS = C::THREADS, Q_CHUNK = C::Q_CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // a stage's K and V arrive apart (S = Q K_jᵀ runs a step before P_j V_j)
  __shared__ __align__(8) uint64_t full_k[C::ST], full_v[C::ST], empty[C::ST];
  __shared__ __align__(8) uint64_t qbar;
  // the swizzle repeats every 1024 bytes: align Q and the ring to it
  unsigned char* qs =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + C::Q_BYTES;

  // the block's tile: batch row b, kv head hkv, heads h0 .. h0 + gn - 1 of
  // its group, positions t0 .. t0 + tn - 1; the heaviest tiles first
  const int G = Hq / Hkv, nhc = (G + gt - 1) / gt, nh = Hkv * nhc;
  const int ntiles = (Tq + bq - 1) / bq;
  const int hc = blockIdx.x % nh, rest = blockIdx.x / nh;
  const int b = rest % B, tile = ntiles - 1 - rest / B;
  const int hkv = hc / nhc, g0 = (hc % nhc) * gt;
  const int gn = min(gt, G - g0), h0 = hkv * G + g0;
  const int t0 = tile * bq, tn = min(bq, Tq - t0);
  const int qrows = gt * bq;

  // the keys any row of the tile can see, in steps aligned to BK
  const int kv_lim = kv_valid ? min(Tk, kv_valid[b]) : Tk;
  int hi = kv_lim;
  if (causal) hi = min(hi, q_offset + t0 + tn);
  const int lo = use_window ? max(0, q_offset + t0 - window + 1) : 0;
  const int k_begin = lo / BK * BK;
  const int steps = hi > lo ? (hi - k_begin + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::ST; ++s) {
      mb_init(&full_k[s], 1);
      mb_init(&full_v[s], 1);
      mb_init(&empty[s], CONSUMERS);
    }
    mb_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q's rows past the box (gt * bq < ROWS) are never loaded: zeros, seen
  // by the tensor cores (the async proxy) after the fence
  for (int i = tid; i < DC * (ROWS - qrows) * 8; i += THREADS) {
    const int c = i / ((ROWS - qrows) * 8), j = i % ((ROWS - qrows) * 8);
    *reinterpret_cast<uint4*>(qs + c * Q_CHUNK + (qrows + j / 8) * 128 +
                              (j % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != CONSUMERS || steps == 0) return;
    mb_expect_tx(&qbar, DC * qrows * 128);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      tma_load(qs + c * Q_CHUNK, &tq, &qbar, 64 * c, h0, t0, b);
    for (int j = 0; j < steps; ++j) {
      const int s = j % C::ST, k0 = k_begin + j * BK;
      unsigned char* st = ring + s * C::STAGE;
      if (j >= C::ST) mb_wait(&empty[s], (j / C::ST - 1) & 1);
      mb_expect_tx(&full_k[s], C::K_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(st + c * BK * 128, &tk, &full_k[s], 64 * c, hkv, k0, b);
      mb_expect_tx(&full_v[s], C::V_BYTES);
#pragma unroll
      for (int c = 0; c < VC; ++c)
        tma_load(st + C::K_BYTES + c * BK * 128, &tv, &full_v[s], 64 * c,
                 hkv, k0, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int wg = tid >> 7, lane = tid & 31;
  // this thread's rows r0 and r0 + 8 of the tile and its column pair
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q_offset + t0 + (r0 + 8 * h) / gt;
  float oacc[C::NO];
#pragma unroll
  for (int i = 0; i < C::NO; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // O / max(l, 1e-30) in bf16 and the rows' log-sum-exp
  auto store = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = quad_sum(l[h]);
      const int r = r0 + 8 * h, t = r / gt, g = r % gt;
      if (r >= qrows || t >= tn || g >= gn) continue;
      const float den = fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow =
          o + (((long long)b * Tq + t0 + t) * Hq + h0 + g) * Dv;
#pragma unroll
      for (int n = 0; n < C::NO / 4; ++n)
        if (8 * n + cq < Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + cq) =
              __floats2bfloat162_rn(oacc[4 * n + 2 * h] / den,
                                    oacc[4 * n + 2 * h + 1] / den);
      if ((lane & 3) == 0)
        lse[((long long)b * Hq + h0 + g) * Tq + t0 + t] =
            lt > 0.f ? ((m[h] == -INFINITY ? 0.f : m[h]) + log2f(den)) * LN2
                     : -INFINITY;
    }
  };
  // no keys: rows of 0 and -inf, no products (ptxas serializes wgmma
  // that a branch may skip, so none below sits inside one)
  if (steps == 0) {
    store();
    return;
  }

  // Step j's products go out as one batch: S_j = Q K_jᵀ and O += P_{j-1}
  // V_{j-1} (at j = 0 P is zeros against V_0, which adds exactly 0), and
  // the last step's P V after the loop; one warpgroup's softmax runs while
  // the tensor cores work through the others' batches.
  const unsigned ra = saddr(ring);
  // descriptors of this warpgroup's Q rows, and of stage 0's K and V
  const uint64_t dq = desc(saddr(qs) + wg * 64 * 128, 16, 1024);
  const uint64_t dk0 = desc(ra, 16, 1024);
  const uint64_t dv0 = desc(ra + C::K_BYTES, BK * 128, 1024);
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) ph[kk][e] = pl[kk][e] = 0u;
  // O += P V from stage sp: 16 keys a product, each part of P in turn;
  // V's 64-column chunks BK rows apart
  auto pv_products = [&](int sp) {
    const uint64_t dvs = dv0 + ((sp * C::STAGE) >> 4);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = dvs + kk * (2048 >> 4);
      mma_rs<64 * VC>(oacc, ph[kk], dv);
      mma_rs<64 * VC>(oacc, pl[kk], dv);
    }
  };
  mb_wait(&qbar, 0);
  for (int j = 0; j < steps; ++j) {
    const int s = j % C::ST, sp = j > 0 ? (j - 1) % C::ST : 0;
    const uint64_t dks = dk0 + ((s * C::STAGE) >> 4);
    mb_wait(&full_k[s], (j / C::ST) & 1);
    mb_wait(&full_v[sp], (j > 0 ? (j - 1) / C::ST : 0) & 1);
    float sacc[C::NS];
    wg_fence();
    // S = Q Kᵀ: 16 columns of D a product (32 bytes of a swizzled row)
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const unsigned off = (kk & 3) * 32;
      mma_ss<BK>(sacc, dq + (((kk >> 2) * Q_CHUNK + off) >> 4),
                 dks + (((kk >> 2) * BK * 128 + off) >> 4), kk > 0);
    }
    pv_products(sp);
    wg_commit();
    wg_wait();
    fence_regs(sacc);
    fence_regs(oacc);
    if (j > 0) mb_arrive(&empty[sp]);
    const int k0 = k_begin + j * BK;

    // the online softmax in log2 units (scale_log2 > 0, so a row's max
    // of the raw scores, scaled, is the max of the scaled ones); masks
    // only where the step crosses an edge
    if (k0 + BK > kv_lim || (causal && k0 + BK - 1 > q_offset + t0) ||
        (use_window && k0 <= q_offset + t0 + tn - 1 - window))
      mask_scores(sacc, k0 + cq, qp, kv_lim, causal, use_window, window);
    const float rmax[2] = {row_tree<C::NS, 0, false>(sacc),
                           row_tree<C::NS, 1, false>(sacc)};
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = fmaxf(m[h], quad_max(rmax[h]) * scale_log2);
      // a row with nothing seen yet: corr and p are 0, not NaN
      mu[h] = mx == -INFINITY ? 0.f : mx;
      const float corr = ex2(m[h] - mu[h]);
      m[h] = mx;
      l[h] *= corr;
      // a row's max moves rarely once it has seen many keys: O is scaled
      // only where a row of the warp needs it (x 1 is exact)
      if (__any_sync(0xffffffffu, corr != 1.f)) {
#pragma unroll
        for (int n = 0; n < C::NO / 4; ++n) {
          oacc[4 * n + 2 * h] *= corr;
          oacc[4 * n + 2 * h + 1] *= corr;
        }
      }
    }
    // P = ph + pl, two bf16 parts cut from P's bits (ph its top 16, pl
    // the top 16 of P - ph), as the A operand: k16 step kk holds keys
    // 16 kk .. + 15, registers (r0, k), (r0 + 8, k), (r0, k + 8), (r0 +
    // 8, k + 8)
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a = sacc[4 * i + 2 * h];
        float& c = sacc[4 * i + 2 * h + 1];
        a = ex2(fmaf(a, scale_log2, -mu[h]));
        c = ex2(fmaf(c, scale_log2, -mu[h]));
        const uint32_t ua = __float_as_uint(a), uc = __float_as_uint(c);
        ph[i >> 1][2 * (i & 1) + h] = __byte_perm(ua, uc, 0x7632);
        pl[i >> 1][2 * (i & 1) + h] = __byte_perm(
            __float_as_uint(a - __uint_as_float(ua & 0xffff0000u)),
            __float_as_uint(c - __uint_as_float(uc & 0xffff0000u)), 0x7632);
      }
    l[0] += row_tree<C::NS, 0, true>(sacc);
    l[1] += row_tree<C::NS, 1, true>(sacc);
  }
  // the last step's P V
  const int sl = (steps - 1) % C::ST;
  mb_wait(&full_v[sl], ((steps - 1) / C::ST) & 1);
  wg_fence();
  pv_products(sl);
  wg_commit();
  wg_wait();
  fence_regs(oacc);
  store();
}

// A 4-D bf16 tensor (d0 innermost, contiguous) read in boxes of 64 x b1 x
// b2 x 1 with the 128-byte swizzle; elements outside it arrive as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int d0, int d1, int d2,
                int d3, int b1, int b2) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2,
                                 (cuuint64_t)d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)b1, (cuuint32_t)b2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DC, int VC, int BK, int NWG>
int launch(const void* q, const void* k, const void* v, const int* kv_valid,
           void* o, float* lse, int B, int Tq, int Tk, int Hq, int Hkv,
           int D, int Dv, int causal, int use_window, int window,
           int q_offset, float scale, int rows, int gt, int bq, int bk,
           int stages, int threads, int smem, int per_sm, cudaStream_t st) {
  using C = Cfg<DC, VC, BK, NWG>;
  constexpr int THREADS = C::THREADS;
  const int G = Hq / Hkv, gtt = G < C::ROWS ? G : C::ROWS;
  if (rows != C::ROWS || gt != gtt || bq != C::ROWS / gtt || bk != BK ||
      stages != C::ST || threads != THREADS || smem != C::SMEM)
    return (int)cudaErrorInvalidValue;
  auto kern = attention_mma_kernel<DC, VC, BK, NWG>;
  static int ready = 0, resident = 0, regs = 0;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern,
                                                          THREADS, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    regs = fa.numRegs;
    ready = 1;
  }
  // the registers setmaxnreg hands the consumers come from the block's
  // own: a launch with fewer would wait for them forever
  if (resident < per_sm ||
      regs * THREADS < C::CONSUMERS * C::CONSUMER_REGS + 128 * PRODUCER_REGS)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap mq{}, mk{}, mv{};
  if (!tensor_map(&mq, q, D, Hq, Tq, B, gt, bq))
    return (int)cudaErrorInvalidValue;
  // no tensor map spans a zero extent: with no keys no block loads any
  if (Tk > 0 && !(tensor_map(&mk, k, D, Hkv, Tk, B, 1, BK) &&
                  tensor_map(&mv, v, Dv, Hkv, Tk, B, 1, BK)))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)((Tq + bq - 1) / bq) * Hkv * ((G + gt - 1) / gt) * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  kern<<<(unsigned)blocks, THREADS, C::SMEM, st>>>(
      mq, mk, mv, kv_valid, static_cast<__nv_bfloat16*>(o), lse, B, Tq, Tk,
      Hq, Hkv, Dv, gt, bq, causal, use_window, window, q_offset, scale_log2);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Attention forward on the tensor cores: q (B, Tq, Hq, D), k (B, Tk, Hkv,
// D), v (B, Tk, Hkv, Dv) bfloat16, contiguous, bases 16-byte aligned;
// kv_valid (B,) int32 or null; writes o (B, Tq, Hq, Dv) bfloat16 and lse
// (B, Hq, Tq) float.  D and Dv multiples of 16 up to 256, the larger above
// 32; Hq a multiple of Hkv; scale > 0; `use_window` 1 masks keys at or
// before position - window.  The launch runs on the plan of
// kernels/plan.py's attention_mma_plan: 64-column chunks `dc` of D and
// `vc` of Dv, `rows` a tile of `gt` heads x `bq` positions, `bk` keys a
// stage, `stages` of the ring, `threads`, the block's shared bytes `smem`
// and the residency `per_sm` the card must hold for it; each is checked
// against what the kernel was built for.
int repro_attention_mma(const void* q, const void* k, const void* v,
                        const int* kv_valid, void* o, float* lse, int B,
                        int Tq, int Tk, int Hq, int Hkv, int D, int Dv,
                        int causal, int use_window, int window, int q_offset,
                        float scale, int dc, int vc, int rows, int gt, int bq,
                        int bk, int stages, int threads, int smem,
                        int per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tq <= 0) return 0;
  auto head = [](int d) { return d >= 16 && d <= 256 && d % 16 == 0; };
  int wc = ((D > Dv ? D : Dv) + 63) / 64, dcc = (D + 63) / 64,
      vcc = (Dv + 63) / 64;
  if (!(dcc == 3 && vcc == 2)) dcc = vcc = wc;
  if (!head(D) || !head(Dv) || (D > Dv ? D : Dv) <= 32 || Hkv <= 0 ||
      Hq % Hkv || Hq < Hkv || Tk < 0 || per_sm < 1 || dc != dcc ||
      vc != vcc || !(scale > 0.f) || !aligned16(q) || !aligned16(o) ||
      (Tk > 0 && (!aligned16(k) || !aligned16(v))))
    return (int)cudaErrorInvalidValue;
#define ATTN_MMA(DC, VC, BK, NWG)                                           \
  return launch<DC, VC, BK, NWG>(q, k, v, kv_valid, o, lse, B, Tq, Tk, Hq,  \
                                 Hkv, D, Dv, causal, use_window, window,    \
                                 q_offset, scale, rows, gt, bq, bk, stages, \
                                 threads, smem, per_sm, st)
  switch (dc * 8 + vc) {
    case 9: ATTN_MMA(1, 1, 96, 3);
    case 18: ATTN_MMA(2, 2, 128, 2);
    case 26: ATTN_MMA(3, 2, 64, 2);
    case 27: ATTN_MMA(3, 3, 64, 2);
    case 36: ATTN_MMA(4, 4, 64, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ATTN_MMA
}

}  // extern "C"
