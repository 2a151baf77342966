// The tensor-core tile of the fused matmul (K1) for Hopper (sm_90a):
// out = epilogue(A @ B) for bf16 and fp16 with M > 8 rows (prefill).
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py
// (fused_matmul_kernel) on the port's prefill path; the wrapper
// (kernels/matmul/matmul.py::select_tile) sends it every bf16/fp16 call
// with M > 8 whose rows TMA can load.  Card-only: TMA and wgmma have no
// CPU stand-in, so the emulated tests leave this source out.
//
// What bounds it on an H100: at prefill (M = batch x prompt, in the
// hundreds or thousands) the product does thousands of operations per
// byte, so the bound is the bf16 tensor-core rate (989 TFLOP/s).  What the
// design does about that: the tile of tc_tile.cuh, with two warpgroups
// (128 rows by 128 columns of B a block, 4 stages of 32 KB) and one
// problem (Z = 1): wgmma on the tensor cores fed by TMA, the GLU paired
// and the epilogue applied in registers before the one store.

#include "tc_tile.cuh"

namespace {
struct FusedMatmul {};   // names this file's instantiations of the tile
}  // namespace

// A (M, K) and B (K, N) row-major bf16 or fp16, both 16-byte aligned, K
// and N (and N/2 under GLU) multiples of 8; out (M, N) or (M, N/2) under
// GLU.  Grid: x over 128-row tiles, so the blocks that share a column
// tile of B run together and B streams from device memory about once.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_matmul_tc_launch(
    int in_code, const void* A, const void* B, void* out, int M, int N,
    int K, int glu, int bias_type, const void* bias, const void* scale_a,
    const void* scale_b, const void* residual, float softcap, int act,
    int trivial, int out_code, void* stream) {
  const Epi ep = make_epi(glu, bias_type, bias, scale_a, scale_b, residual,
                          softcap, act, trivial, out_code, out);
  return tc_tile_dispatch<FusedMatmul, 2>(in_code, A, B, 1, M, N, K, nullptr,
                                          ep,
                                          static_cast<cudaStream_t>(stream));
}
