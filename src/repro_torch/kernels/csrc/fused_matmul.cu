// Fused GEMM + epilogue for Hopper (sm_90a): C = epilogue(A @ B).
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py
// (fused_matmul_kernel, wrapped by kernels/matmul/ops.py::fused_matmul).
//
// Two of K1's three tiles live in this library; the wrapper
// (kernels/matmul/matmul.py::select_tile) picks one per call:
//   * the decode tile (decode_tile.cuh, ``fused_matmul_decode_launch``)
//     for M <= 8 rows, every input type.  There the product reads each
//     weight byte once for a few rows and is bound by device memory
//     bandwidth; the tile streams B with vector loads, splits K across
//     warps and, where N is narrow, across blocks with a fixed-order
//     reduction;
//   * the SIMT tile (gemm_tile.cuh, ``fused_matmul_launch``) for what the
//     tensor-core tile does not take: fp32 (TF32 would break fp32
//     parity), int8 (wgmma's s8 form takes only K-major B) and 16-bit
//     shapes whose rows are not whole 16-byte units.  It keeps its fp32
//     (int32 for int8) accumulator tile in registers across the whole K
//     sweep and stages operands through shared memory with coalesced
//     16-byte loads where alignment allows and masked loads at ragged
//     edges.
// The third, the tensor-core tile for bf16/fp16 prefill, is card-only
// (fused_matmul_sm90.cu).  Every tile applies the epilogue (scales,
// bias, softcap, activation, GLU, residual, cast; epilogue.cuh) to the
// accumulators in registers before its one store: the intermediate never
// goes to device memory, which is the paper's matrix-vector fusion.

#include "decode_tile.cuh"
#include "gemm_tile.cuh"

namespace {
struct FusedMatmul {};   // names this file's instantiations of the tiles
}  // namespace

// A (M, K) and B (K, N) row-major; out (M, N) or (M, N/2) under GLU.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_matmul_launch(
    int in_code, const void* A, const void* B, void* out, int M, int N,
    int K, int glu, int vec_a, int vec_b, int bias_type, const void* bias,
    const void* scale_a, const void* scale_b, const void* residual,
    float softcap, int act, int trivial, int out_code, void* stream) {
  const Epi ep = make_epi(glu, bias_type, bias, scale_a, scale_b, residual,
                          softcap, act, trivial, out_code, out);
  return gemm_tile_dispatch<FusedMatmul>(
      in_code, A, B, M, N, K, 1, 0, 0, nullptr, vec_a, vec_b, ep,
      static_cast<cudaStream_t>(stream));
}

// The decode tile, M <= 8: K in ``splits`` ranges of ``k_split`` rows;
// with splits > 1, ``ws`` is an fp32 (int32 for int8) workspace of
// (splits, M, N) elements.  Returns the CUDA error code of the launches.
extern "C" int fused_matmul_decode_launch(
    int in_code, const void* A, const void* B, void* out, int M, int N,
    int K, int glu, int vec_b, int splits, int k_split, void* ws,
    int bias_type, const void* bias, const void* scale_a,
    const void* scale_b, const void* residual, float softcap, int act,
    int trivial, int out_code, void* stream) {
  const Epi ep = make_epi(glu, bias_type, bias, scale_a, scale_b, residual,
                          softcap, act, trivial, out_code, out);
  const DecodeArgs args{A, B, 1, M, N, K, 0, 0, nullptr, splits, k_split,
                        vec_b, ws};
  return decode_tile_dispatch<FusedMatmul>(
      in_code, args, M, ep, static_cast<cudaStream_t>(stream));
}
