// Counter-derived MDS parity for Hopper (sm_90a): the virtual-parity
// generator and the counter-derived parity contraction.
//
// Replaces repro/kernels/mds_encode.py::
//   * counter_parity_rows_pallas (_rows_kernel, _parity_tile) -- parity
//     generator rows R[ctrs] from packed (row | draw << 24) counters,
//   * gen_parity_matvec_pallas (_gen_matvec_kernel) -- y = R_gen @ (W @ x)
//     with the encoded parity rows WR never stored, and
//   * the decode's substitution term R[par, known] @ y_known, which the
//     reference forms whole (repro/serve_coded/packing.py:263-273, Gk)
//     from counter_parity_rows_pallas rows.
//
// Every entry is two threefry2x32-20 calls, four 24-bit uniforms summed in
// the fixed order (u(a0)+u(a1)) + (u(b0)+u(b1)) - 2, times sqrt(3/L)
// (repro/core/mds.py:81-149).  The rows must be bit-identical to the host
// derivation, so the arithmetic uses uint32 wrap-around, the exact
// (bits >> 8) -> float conversion, and explicitly rounded single-precision
// intrinsics (__fadd_rn/__fmaf_rn/__fmul_rn), which the compiler never
// contracts or reassociates.
//
// What bounds them on this card: 142 integer operations per generated
// entry against 4 bytes written (counter rows) or a 2*C-FLOP contraction,
// so both are bound by the integer pipes, not by HBM.  As written here
// the rotations run as SHF on the ALU pipe, which alone runs SHF and LOP3
// at half the issue rate: their 78 an entry (with the xors) take 156
// issue slots' time, so this code reaches at most 142 / 156 of the
// issue-rate bound.  ptxas puts a 32-bit add on either pipe (IADD3 on
// the ALU, IMAD.IADD on the FMA pipe) and left 8 an entry on the ALU;
// every threefry add is written here as x * one + y with `one` a kernel
// argument (always 1), which ptxas cannot fold, so they all run as IMAD
// on the FMA pipe and the ALU pipe carries the rotations, the xors and
// the two shift-adds of the uniforms alone.
//
// Design.  Work that depends on the row alone (c0 + k0) or on the column
// alone (c1 + k1 and its first rotation, for both counters) is hoisted out
// of the entry, and the two pairs of uniforms are summed as integers first
// (below), which halves the int -> float conversions.  Each block owns 8
// rows, loads their counters once, and strides its threads over the
// columns; every entry of a column is derived for the 8 rows in registers
// (8 independent threefry chains a thread).  The contraction kernel
// contracts the entries against Z rows read through L2 (R never touches
// memory) and reduces the per-row sums across the block in a fixed order:
// no atomics, so repeated calls give the same bits.  With a column-index
// operand it derives only the columns a decode needs (R[par, known]);
// without one it takes columns 0..m-1 (the generated-parity lanes, Z =
// W @ X precomputed once per call by the coded_matvec kernel).  It takes
// 1 <= C <= 8 columns of Z; the rows kernel writes its 8 x 4 entries a
// thread coalesced along the row, for decode minors (R[par, unk]) and
// parity-block encodes.
//
// The wide contraction (more than 8 float64 columns: the trunk decodes'
// known term at a prefill, C = 32, and the generated-parity lanes of a
// wide prefill).  The narrow kernel keeps C accumulators for each of its 8
// rows a thread, so it is compiled for C <= 8 and a wider Z took one
// launch per 8 columns, each deriving every entry again: at C = 32 four
// times the threefry work that bounds it.  Design:
//  * One launch computes up to 64 columns (plan.CT_WIDE_COLS; the host
//    splits a wider Z into chunks of 64), and derives each entry once.
//  * A block owns 32 rows.  A stage of 64 columns: the block's 256 threads
//    derive the 32 x 64 entries, 8 rows of one column a thread (8
//    independent chains, the narrow kernel's entry arithmetic bit for
//    bit), widen them exactly and store them to a shared [32][64] double
//    tile, while cp.async brings the stage's 64 rows of Z; then the
//    warps contract the tile on the FP64 tensor cores (mma.sync
//    m16n8k8), each warp one m16 tile against its n8 tiles of the chunk.
//    The tiles' rows are padded to 4 mod 16 doubles, so every fragment
//    read is free of bank conflicts.  142 integer operations an entry
//    against 2 C FLOP: the derivation still bounds it.
//  * The m columns are split into at most 8 slabs of a length that is a
//    function of m alone (plan.contract_plan): the blocks of one row
//    block form a thread-block cluster along the slabs and sum their
//    partial tiles in slab order over the cluster's shared memory, as the
//    wide coded_matvec does.  A column's sum has one order -- stage by
//    stage, the mma's k order, then the slabs -- whatever C, the column's
//    place among the others, n or the card, and repeated calls are
//    bit-equal.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32-20 of (c0, c1) under (k0, k1), from x0 = c0 + k0, x1 = c1 +
// k1 and r1 = rotl(x1, 13): the first round's rotation depends on the
// column alone, so it comes in precomputed.  `one` is 1: each a * one + b
// is the add a + b, kept on the FMA pipe (see above).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t ks2, uint32_t one,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t r1, uint32_t& o0,
                                             uint32_t& o1) {
#define TF_ROUND(r)     \
  x0 = x1 * one + x0;   \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;
  // rotations (13,15,26,6) on even groups, (17,29,16,24) on odd groups;
  // key schedule (k1, ks2, k0) injected after every 4 rounds
  x0 = x1 * one + x0;
  x1 = r1 ^ x0;
  TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = x0 * one + k1; x1 = x1 * one + (ks2 + 1u);
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = x0 * one + ks2; x1 = x1 * one + (k0 + 2u);
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = x0 * one + k0; x1 = x1 * one + (k1 + 3u);
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = x0 * one + k1; x1 = x1 * one + (ks2 + 4u);
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = x0 * one + ks2; x1 = x1 * one + (k0 + 5u);
#undef TF_ROUND
  o0 = x0;
  o1 = x1;
}

// The launch's key: k0, k1, the schedule word ks2, and the run-time 1.
struct Key {
  uint32_t k0, k1, ks2, one;
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1,
                                      uint32_t one) {
  return Key{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu, one};
}

// A column's half of both threefry calls: counters (ctr, 2 col) and (ctr,
// 2 col + 1) after the key add, and their first rotations.
struct Col {
  uint32_t xa, ra, xb, rb;
};

__device__ __forceinline__ Col make_col(const Key& k, uint32_t col) {
  Col c;
  c.xa = col * 2u + k.k1;
  c.xb = c.xa + 1u;
  c.ra = rotl32(c.xa, 13);
  c.rb = rotl32(c.xb, 13);
  return c;
}

// R(ctr, col) with x0 = ctr + k0.  u(a0) + u(a1) = ((a0 >> 8) + (a1 >> 8))
// * 2^-24 exactly: each 24-bit value converts exactly, their sum (< 2^25)
// is an exact integer, and one round-to-nearest conversion of it equals
// the __fadd_rn of the two exact floats (scaling by 2^-24 is exact).  The
// sum of the pairs times 2^-24 is exact too, so one fma minus 2 rounds
// once, as the subtraction did.
__device__ __forceinline__ float parity_entry(const Key& k, uint32_t x0,
                                              const Col& c, float scale) {
  uint32_t a0, a1, b0, b1;
  threefry2x32(k.k0, k.k1, k.ks2, k.one, x0, c.xa, c.ra, a0, a1);
  threefry2x32(k.k0, k.k1, k.ks2, k.one, x0, c.xb, c.rb, b0, b1);
  const float sa = __uint2float_rn((a0 >> 8) + (a1 >> 8));
  const float sb = __uint2float_rn((b0 >> 8) + (b1 >> 8));
  const float g = __fmaf_rn(__fadd_rn(sa, sb), 5.9604644775390625e-08f,
                            -2.0f);
  return __fmul_rn(g, scale);
}

constexpr int ROWS = 8;                 // rows a block (and a thread)
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int CR_COLS = 4;              // columns a thread, rows kernel

// The 8 rows' x0 = ctr + k0; rows past n derive from counter 0 and are
// never stored.
__device__ __forceinline__ void row_keys(const Key& k,
                                         const uint32_t* __restrict__ ctrs,
                                         int r0, int n, uint32_t* x0) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    x0[r] = (r0 + r < n ? __ldg(ctrs + r0 + r) : 0u) + k.k0;
}

// out (n, m) float32, out[i, j] = R(ctrs[i], cols[j]); grid (row blocks,
// column spans of THREADS * CR_COLS).
__global__ void __launch_bounds__(THREADS)
counter_rows_kernel(uint32_t k0, uint32_t k1, uint32_t one,
                    float scale, const uint32_t* __restrict__ ctrs, int n,
                    const uint32_t* __restrict__ cols, int m,
                    float* __restrict__ out) {
  const Key k = make_key(k0, k1, one);
  const int r0 = blockIdx.x * ROWS;
  uint32_t x0[ROWS];
  row_keys(k, ctrs, r0, n, x0);
  const int nr = min(ROWS, n - r0);
  const int j0 = blockIdx.y * THREADS * CR_COLS + threadIdx.x;
#pragma unroll
  for (int q = 0; q < CR_COLS; ++q) {
    const int j = j0 + q * THREADS;
    if (j >= m) break;
    const Col c = make_col(k, __ldg(cols + j));
    float v[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r] = parity_entry(k, x0[r], c, scale);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nr) out[(size_t)(r0 + r) * m + j] = v[r];
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Y (n, CC) = R(ctrs, cols) @ Z, Z (m, CC) row-major; without GATHER the
// columns are 0..m-1.  T is the type of Z, of the accumulator and of Y.
// With T = double each float32 R entry is widened exactly and contracted
// against the float64 Z in double: the products feed an MDS decode,
// which would amplify any float32 rounding they carried.
template <typename T, int CC, bool GATHER>
__global__ void __launch_bounds__(THREADS)
parity_contract_kernel(uint32_t k0, uint32_t k1, uint32_t one,
                       float scale, const uint32_t* __restrict__ ctrs, int n,
                       const uint32_t* __restrict__ cols, int m,
                       const T* __restrict__ Z, T* __restrict__ Y) {
  __shared__ T red[WARPS][ROWS * CC];
  const Key k = make_key(k0, k1, one);
  const int r0 = blockIdx.x * ROWS;
  uint32_t x0[ROWS];
  row_keys(k, ctrs, r0, n, x0);
  T acc[ROWS][CC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = T(0);

  for (int j = threadIdx.x; j < m; j += THREADS) {
    const Col col = make_col(k, GATHER ? __ldg(cols + j) : (uint32_t)j);
    T z[CC];
#pragma unroll
    for (int c = 0; c < CC; ++c) z[c] = Z[(size_t)j * CC + c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const T v = T(parity_entry(k, x0[r], col, scale));
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] = fma_t(v, z[c], acc[r][c]);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      T v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * CC + c] = v;
    }
  __syncthreads();
  const int nr = min(ROWS, n - r0);
  for (int t = threadIdx.x; t < ROWS * CC; t += THREADS) {
    const int r = t / CC;
    if (r >= nr) continue;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][t];
    Y[(size_t)(r0 + r) * CC + (t % CC)] = s;
  }
}

template <typename T, bool GATHER, int CC>
int launch_contract(uint32_t k0, uint32_t k1, float scale,
                    const uint32_t* ctrs, int n, const uint32_t* cols,
                    int m, const void* Z, void* Y, cudaStream_t st) {
  const int blocks = (n + ROWS - 1) / ROWS;
  parity_contract_kernel<T, CC, GATHER><<<blocks, THREADS, 0, st>>>(
      k0, k1, 1u, scale, ctrs, n, cols, m, static_cast<const T*>(Z),
      static_cast<T*>(Y));
  return (int)cudaGetLastError();
}

template <typename T, bool GATHER>
int contract(uint32_t k0, uint32_t k1, float scale, const uint32_t* ctrs,
             int n, const uint32_t* cols, int m, const void* Z, int C,
             void* Y, cudaStream_t st) {
#define CASE(cc)                                                          \
  case cc:                                                                \
    return launch_contract<T, GATHER, cc>(k0, k1, scale, ctrs, n, cols, m, \
                                          Z, Y, st);
  switch (C) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CASE
}

// -- the wide contraction ---------------------------------------------------
namespace wide {

namespace cg = cooperative_groups;

// plan.CT_WIDE_ROWS (rows a block), plan.CT_WIDE_BK (columns of R a
// stage), plan.CT_WIDE_COLS, plan.CT_WIDE_MAX_SPLITS
constexpr int BM = 32, BK = 64, COLS = 64, MAX_SPLITS = 8;
constexpr int RS_LD = BK + 4;       // doubles a row of the R tile
static_assert(BM == 4 * ROWS && BK * 4 == THREADS,
              "a stage's entries: 8 rows of one column a thread");

// NT n8 tiles of columns
template <int NT>
struct Tile {
  static constexpr int CW = 8 * NT;
  static constexpr int ZS_LD = CW + 4;              // doubles a row of Z's
  static constexpr int RS = BM * RS_LD;             // doubles of the R tile
  static constexpr int SMEM = (RS + BK * ZS_LD) * 8;
  static constexpr int RED_LD = CW + 2;             // doubles a partial row
  static_assert(BM * RED_LD <= RS + BK * ZS_LD,
                "the partial tile reuses the stage's tiles");
};

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Y[:, c0:c0+cc] of rows [32 x, 32 x + 32) over the column slab y; the
// cluster of a row block's slabs sums them.  Fragments (PTX m16n8k8 .f64):
// lane (g, t) holds A rows g and g + 8 at k = t and t + 4, B's k = t and
// t + 4 at column g, and C rows g and g + 8 at columns 2 t and 2 t + 1.
template <int NT, bool GATHER>
__global__ void __launch_bounds__(THREADS, 2)
parity_contract_wide_kernel(uint32_t k0, uint32_t k1, uint32_t one,
                            float scale, const uint32_t* __restrict__ ctrs,
                            int n, const uint32_t* __restrict__ cols, int m,
                            const double* __restrict__ Z, int C, int c0,
                            int cc, double* __restrict__ Y, int splits,
                            int m_span) {
  using T = Tile<NT>;
  constexpr int NJ = (NT + 3) / 4;                  // n8 tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  double* rs = reinterpret_cast<double*>(smem);    // [BM][RS_LD]
  double* zs = rs + T::RS;                          // [BK][ZS_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM, z = blockIdx.y;
  const Key k = make_key(k0, k1, one);
  // the entries a thread derives: column dj of each stage, rows dr + 0..7
  const int dj = tid % BK, dr = (tid / BK) * ROWS;
  uint32_t x0[ROWS];
  row_keys(k, ctrs, row0 + dr, n, x0);
  const int j_begin = z * m_span, j_end = min(m, j_begin + m_span);
  const int n_stages = j_end > j_begin ? (j_end - j_begin + BK - 1) / BK : 0;
  // the warp's m16 tile and n8 tiles jw, jw + 4
  const int mt = warp & 1, jw = warp >> 1, n_live = (cc + 7) / 8;

  double acc[NJ][4];
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;

  for (int s = 0; s < n_stages; ++s) {
    const int j0 = j_begin + s * BK;
    // Z's rows [j0, j0 + BK) x columns [c0, c0 + CW), zero past the slab
    // and cc
#pragma unroll
    for (int e = tid; e < BK * T::CW; e += THREADS) {
      const int kk = e / T::CW, c = e % T::CW;
      const bool ok = j0 + kk < j_end && c < cc;
      gemm::cp_async<8>(zs + kk * T::ZS_LD + c,
                        ok ? Z + (size_t)(j0 + kk) * C + c0 + c : Z,
                        ok ? 8 : 0);
    }
    gemm::cp_async_commit();
    // the stage's entries, widened exactly (zero past the slab)
    const int j = j0 + dj;
    if (j < j_end) {
      const Col col = make_col(k, GATHER ? __ldg(cols + j) : (uint32_t)j);
      float v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[r] = parity_entry(k, x0[r], col, scale);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        rs[(dr + r) * RS_LD + dj] = static_cast<double>(v[r]);
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) rs[(dr + r) * RS_LD + dj] = 0.0;
    }
    gemm::cp_async_wait<0>();
    __syncthreads();            // the stage's R and Z tiles are whole
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const double* ra = rs + (mt * 16 + g) * RS_LD + ks * 8 + t;
      const double a[4] = {ra[0], ra[8 * RS_LD], ra[4], ra[8 * RS_LD + 4]};
      const double* zb = zs + (ks * 8 + t) * T::ZS_LD + g;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int jt = jw + 4 * i;
        if (jt < NT && jt < n_live) {
          const double b[2] = {zb[8 * jt], zb[4 * T::ZS_LD + 8 * jt]};
          dmma(acc[i], a, b);
        }
      }
    }
    __syncthreads();            // every warp is done with the stage's tiles
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int jt = jw + 4 * i;
      if (jt >= NT || jt >= n_live) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + g + 8 * h, c = 8 * jt + 2 * t;
        if (row >= n) continue;
        double* yrow = Y + (size_t)row * C + c0;
        if (c < cc) yrow[c] = acc[i][2 * h];
        if (c + 1 < cc) yrow[c + 1] = acc[i][2 * h + 1];
      }
    }
    return;
  }
  // the slab's partial tile into this block's shared memory, then the
  // cluster's sum of every slab's tile in slab order
  double* red = rs;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int jt = jw + 4 * i;
    if (jt >= NT || jt >= n_live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<double2*>(red + (mt * 16 + g + 8 * h) * T::RED_LD +
                                  8 * jt + 2 * t) =
          make_double2(acc[i][2 * h], acc[i][2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (BM + splits - 1) / splits;
  const int rb = z * per, re = min(BM, rb + per);
  for (int e = tid; e < (re - rb) * cc; e += THREADS) {
    const int r = rb + e / cc, c = e % cc;
    const int off = r * T::RED_LD + c;
    double sum = cluster.map_shared_rank(red, 0)[off];
    for (int q = 1; q < splits; ++q)
      sum += cluster.map_shared_rank(red, q)[off];
    if (row0 + r < n) Y[(size_t)(row0 + r) * C + c0 + c] = sum;
  }
  cluster.sync();               // no block leaves while its tile is read
}

template <int NT, bool GATHER>
int launch(uint32_t k0, uint32_t k1, float scale, const uint32_t* ctrs,
           int n, const uint32_t* cols, int m, const double* Z, int C,
           int c0, int cc, double* Y, int row_blocks, int splits, int m_span,
           cudaStream_t st) {
  using T = Tile<NT>;
  auto kern = parity_contract_wide_kernel<NT, GATHER>;
  static bool ready = false;          // the attribute, once an instantiation
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const uint32_t one = 1u;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, k0, k1, one, scale, ctrs, n, cols, m, Z,
                         C, c0, cc, Y, splits, m_span);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool GATHER>
int run(uint32_t k0, uint32_t k1, float scale, const uint32_t* ctrs, int n,
        const uint32_t* cols, int m, const double* Z, int C, int c0,
        double* Y, int row_blocks, int splits, int m_span, cudaStream_t st) {
  const int cc = C - c0 < COLS ? C - c0 : COLS;
#define REPRO_CT(NT)                                                       \
  return launch<NT, GATHER>(k0, k1, scale, ctrs, n, cols, m, Z, C, c0, cc, \
                            Y, row_blocks, splits, m_span, st)
  if (cc <= 16) REPRO_CT(2);
  if (cc <= 32) REPRO_CT(4);
  REPRO_CT(8);
#undef REPRO_CT
}

}  // namespace wide

}  // namespace

extern "C" {

// out (n, m) float32: out[i, j] = R(ctrs[i], cols[j]).
int repro_counter_parity_rows(uint32_t k0, uint32_t k1, float scale,
                              const uint32_t* ctrs, int n,
                              const uint32_t* cols, int m, float* out,
                              void* stream) {
  if (n <= 0 || m <= 0) return 0;
  dim3 grid((n + ROWS - 1) / ROWS,
            (m + THREADS * CR_COLS - 1) / (THREADS * CR_COLS));
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  counter_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, 1u, scale, ctrs, n, cols, m, out);
  return (int)cudaGetLastError();
}

// Y (n, C) = R(ctrs, cols) @ Z, Z (m, C) row-major, 1 <= C <= 8 (the
// narrow kernel; wider float64 Z takes repro_parity_contract_wide), cols
// (m,) column indices or null for 0..m-1; `f64` selects float64 Z,
// accumulation and Y (else float32 throughout, columns 0..m-1 only).
int repro_parity_contract(int f64, uint32_t k0, uint32_t k1, float scale,
                          const uint32_t* ctrs, int n, const uint32_t* cols,
                          int m, const void* Z, int C, void* Y,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (cols != nullptr && !f64) return (int)cudaErrorInvalidValue;
  if (!f64)
    return contract<float, false>(k0, k1, scale, ctrs, n, cols, m, Z, C, Y,
                                  st);
  return cols != nullptr
             ? contract<double, true>(k0, k1, scale, ctrs, n, cols, m, Z, C,
                                      Y, st)
             : contract<double, false>(k0, k1, scale, ctrs, n, cols, m, Z,
                                       C, Y, st);
}


// The wide contraction: Y[:, c0:c0+cc] = R(ctrs, cols) @ Z[:, c0:c0+cc] in
// float64, cc = min(C - c0, 64), Z (m, C) and Y (n, C) row-major, cols as
// above (the caller loops over 64-column chunks).  The plan of
// kernels/plan.py's contract_plan (route "wide"): `row_blocks` =
// ceil(n / 32) blocks of 32 rows, `splits` <= 8 column slabs of `m_span`
// (a multiple of 64) that cover m with none empty, one cluster of
// `splits` blocks a row block.
int repro_parity_contract_wide(uint32_t k0, uint32_t k1, float scale,
                               const uint32_t* ctrs, int n,
                               const uint32_t* cols, int m, const void* Z,
                               int C, int c0, void* Y, int row_blocks,
                               int splits, int m_span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (m < 0 || c0 < 0 || c0 >= C ||
      row_blocks != (n + wide::BM - 1) / wide::BM ||
      splits > wide::MAX_SPLITS ||
      !gemm::plan_ok(m, splits, m_span, wide::BK))
    return (int)cudaErrorInvalidValue;
  const double* z = static_cast<const double*>(Z);
  double* y = static_cast<double*>(Y);
  return cols != nullptr
             ? wide::run<true>(k0, k1, scale, ctrs, n, cols, m, z, C, c0, y,
                               row_blocks, splits, m_span, st)
             : wide::run<false>(k0, k1, scale, ctrs, n, cols, m, z, C, c0, y,
                                row_blocks, splits, m_span, st);
}

}  // extern "C"
