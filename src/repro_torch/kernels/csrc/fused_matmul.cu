// Fused GEMM + epilogue for Hopper (sm_90a): C = epilogue(A @ B).
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py
// (fused_matmul_kernel, wrapped by kernels/matmul/ops.py::fused_matmul).
//
// What bounds it on an H100: at prefill (M = batch x prompt, in the
// thousands) the product is compute-bound; at decode (M = batch = 4) it
// reads every weight byte once for a few rows, so it is bound by device
// memory bandwidth.  This first version is a shared-memory-tiled SIMT
// kernel, not a tensor-core one, so at prefill it runs far below the
// bf16 tensor-core peak; wgmma, TMA and warp specialisation are later
// work.  What the design does about the bound (the tile is in
// gemm_tile.cuh, shared with the grouped MoE matmul):
//   * each block keeps its fp32 (int32 for int8) accumulator tile in
//     registers across the whole K sweep, and applies the epilogue
//     (scales, bias, softcap, activation, GLU, residual, cast) in those
//     registers before its one store: the intermediate never goes to
//     device memory, which is the paper's matrix-vector fusion;
//   * operand tiles are staged through shared memory with coalesced
//     16-byte loads wherever the row length and alignment allow, and
//     per-element masked loads at ragged edges, so any M, N, K works;
//   * a small-M tile (8 rows, 128-deep K steps) serves decode, so the
//     weight stream is not spread over 64-row tiles that are mostly
//     padding; a 64x64 tile serves prefill.

#include "gemm_tile.cuh"

namespace {
struct FusedMatmul {};   // names this file's instantiations of the tile
}  // namespace

// A (M, K) and B (K, N) row-major; out (M, N) or (M, N/2) under GLU.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_matmul_launch(
    int in_code, const void* A, const void* B, void* out, int M, int N,
    int K, int glu, int vec_a, int vec_b, int bias_type, const void* bias,
    const void* scale_a, const void* scale_b, const void* residual,
    float softcap, int act, int trivial, int out_code, void* stream) {
  Epi ep;
  ep.bias_type = bias_type;
  ep.bias = static_cast<const float*>(bias);
  ep.scale_a = static_cast<const float*>(scale_a);
  ep.scale_b = static_cast<const float*>(scale_b);
  ep.residual = static_cast<const float*>(residual);
  ep.softcap = softcap;
  ep.act = act;
  ep.glu = glu;
  ep.trivial = trivial;
  ep.out_code = out_code;
  ep.out = out;
  return gemm_tile_dispatch<FusedMatmul>(
      in_code, A, B, M, N, K, 1, 0, 0, 0, vec_a, vec_b, ep,
      static_cast<cudaStream_t>(stream));
}
