// Float32 GEMM C = A @ B for Hopper (sm_90a).
//
// Replaces repro/kernels/matmul.py::matmul_pallas (_matmul_kernel): the
// 128^3-block VMEM matmul with f32 accumulation that encodes parity rows
// (R_block @ W, repro/serve_coded/coded_linear.py:391).
//
// What bounds it on this card: at the serving shape (256 x 128512) @
// (128512 x 2048) the product does 1.35e11 FLOP on 1.05 GB of W, i.e.
// ~128 FLOP/byte -- above the f32 SIMT ridge (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP/byte), so it is bound by the f32 pipes (the port keeps IEEE f32,
// no TF32, to match the reference encode).
//
// Design: the TPU grid walks K sequentially with an accumulator in VMEM;
// here the 128 x 128 output tiles of sgemm.cuh (8 x 8 a thread, a 4-stage
// cp.async ring) run in parallel blocks.  The serving shape has only 2 x 16
// output tiles for 132 SMs and a very long K, so K is split into slabs
// (kernels/plan.py chooses how many) written to a workspace and summed in a
// fixed order by a second kernel (deterministic, no atomics).  Ragged M/N/K
// edges and unaligned operands are masked inside the kernel; no operand
// padding is needed.
#include "sgemm.cuh"

extern "C" {

// C (M, N) = A (M, K) @ B (K, N), all float32 row-major, on the plan
// `config` (0, the sgemm tiles), `splits` K slabs of `k_span` elements.
// `ws` holds splits * M * N floats when splits > 1 (unused otherwise).
int repro_matmul_f32(const float* A, const float* B, float* C, float* ws,
                     int M, int N, int K, int config, int splits, int k_span,
                     void* stream) {
  if (config != 0) return (int)cudaErrorInvalidValue;
  return sgemm::launch(A, 0, K, B, 0, N, C, 0, N, ws, M, N, K, 1, splits,
                       k_span, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
