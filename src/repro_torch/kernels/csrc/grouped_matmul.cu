// Grouped (per-expert) GEMM for MoE layers on Hopper (sm_90a):
// out[e] = epilogue(x[e] @ w[e]) for every expert e.
//
// Replaces the TPU kernel src/repro/kernels/moe/grouped_matmul.py
// (grouped_matmul_kernel, wrapped by kernels/moe/ops.py::grouped_matmul).
// The TPU kernel walks an (E, C/bm, N/bn, K/bk) grid with a sequential K
// axis and a VMEM accumulator; here each block owns one (expert, row
// tile, column tile), loops over K inside itself and applies the
// operand-free epilogue (softcap, activation, GLU, cast) in registers
// before its one store.  It is the fused-matmul tile of gemm_tile.cuh
// with the expert on blockIdx.z and per-expert strides.
//
// What bounds it on an H100: the weights.  Capacity dispatch gives every
// expert the same C rows, so each call reads all E experts' weights.  For
// OLMoE's gate/up projection, (64, 2048, 2048) bf16, that is 537 MB per
// call: 0.16 ms at 3.35 TB/s, against 0.078 ms for the 77 GFLOP of the
// prefill shape (C = 144) at the bf16 tensor-core rate, so even prefill
// is bound by bytes, and decode (C = 8) is bound by them many times over.
// What the design does about it: a weight tile is read once per row tile
// of its expert (three times at C = 144, the repeats mostly from L2; once
// at C <= 8, by the 8-row decode tile, whose 128-deep K steps keep whole
// weight rows streaming); the gate and up halves of a GLU weight are read
// by the same block and combined in registers, so the (E, C, 2*ff)
// intermediate never reaches device memory.  Blocks of empty capacity
// rows still run: skipping them is later work, as is the tensor-core
// (wgmma) version.

#include "gemm_tile.cuh"

namespace {
struct GroupedMatmul {};   // names this file's instantiations of the tile
}  // namespace

// x (E, C, K) and w (E, K, N) row-major, w's N = 2 * N_out under GLU
// (gate columns, then up columns); out (E, C, N_out).  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int grouped_matmul_launch(
    int in_code, const void* x, const void* w, void* out, int E, int C,
    int N, int K, int glu, int vec_a, int vec_b, float softcap, int act,
    int trivial, int out_code, int out_bytes, void* stream) {
  Epi ep;
  ep.bias_type = BIAS_ZERO;
  ep.bias = nullptr;
  ep.scale_a = nullptr;
  ep.scale_b = nullptr;
  ep.residual = nullptr;
  ep.softcap = softcap;
  ep.act = act;
  ep.glu = glu;
  ep.trivial = trivial;
  ep.out_code = out_code;
  ep.out = out;
  const long long n_out = glu ? N / 2 : N;
  return gemm_tile_dispatch<GroupedMatmul>(
      in_code, x, w, C, N, K, E, (long long)C * K, (long long)K * N,
      (long long)C * n_out * out_bytes, vec_a, vec_b, ep,
      static_cast<cudaStream_t>(stream));
}
