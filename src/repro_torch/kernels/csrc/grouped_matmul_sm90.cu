// The tensor-core tile of the grouped MoE matmul (K4) for Hopper
// (sm_90a): out[e] = epilogue(x[e] @ w[e]) for bf16 and fp16 with C > 8
// rows an expert (prefill).
//
// Replaces the TPU kernel src/repro/kernels/moe/grouped_matmul.py
// (grouped_matmul_kernel, wrapped by kernels/moe/ops.py::grouped_matmul)
// on the port's prefill path; the wrapper (kernels/moe/grouped_matmul.py,
// through K1's select_tile) sends it every bf16/fp16 call with C > 8
// whose rows TMA can load.  Card-only, as fused_matmul_sm90.cu.
//
// What bounds it on an H100: the weights.  OLMoE's gate/up projection at
// the 884-token prefill, x (64, 144, 2048) @ w (64, 2048, 2048) GLU, does
// 77 GFLOP (0.078 ms at the bf16 tensor-core rate) against 537 MB of
// weights (0.16 ms at 3.35 TB/s), so bytes bound it, and each weight byte
// has to be read from device memory about once.  What the design does
// about that: the tile of tc_tile.cuh with the expert on blockIdx.z and
// rank-3 tensor maps over x (E, C, K) and w (E, K, N), so a box of x
// stops at its own expert's last row; the grid runs x over an expert's
// row tiles first, so the blocks that read one expert's weight panel run
// side by side and the panel comes from device memory once and from L2
// for the others.  The operand-free epilogue (softcap, activation, GLU,
// cast) runs in registers, so the (E, C, 2 * ff) intermediate of a GLU
// never reaches device memory.
//
// The row tile follows C: of 64, 128 and 192 rows (one to three
// warpgroups, 96, 129 and 161 KB of shared memory), the one that computes
// the fewest rows past C, and of those the tallest, which reads each
// weight panel for the fewest row tiles.  At C = 144, 192-row tiles
// compute 192 rows (75% of them real) and read each panel once; 64-row
// tiles compute as many but read each panel three times, and 128-row
// tiles compute 256 (56%).  At the second prefill batch's C = 64 one
// 64-row tile computes exactly C.
//
// With ``rows`` (rows[e] promises x[e, rows[e]:] is zero, on the device),
// a row tile at or past rows[e] loads nothing and writes epilogue(0):
// experts with no token and the empty tail of each capacity block cost
// no weight traffic.

#include "tc_tile.cuh"

namespace {
struct GroupedMatmul {};   // names this file's instantiations of the tile
}  // namespace

// x (E, C, K) and w (E, K, N) row-major bf16 or fp16, 16-byte aligned, K
// and N (and N/2 under GLU) multiples of 8, w's N = 2 * N_out under GLU
// (gate columns, then up columns); out (E, C, N_out); rows null or (E,)
// int32 on the device.  Returns the CUDA error code of the launch.
extern "C" int grouped_matmul_tc_launch(
    int in_code, const void* x, const void* w, void* out, int E, int C,
    int N, int K, int glu, const int* rows, float softcap, int act,
    int trivial, int out_code, void* stream) {
  const Epi ep = make_epi(glu, BIAS_ZERO, nullptr, nullptr, nullptr, nullptr,
                          softcap, act, trivial, out_code, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto computed = [C](int wg) { return (C + 64 * wg - 1) / (64 * wg) * wg; };
  int wg = 1;
  for (int g = 2; g <= 3; ++g)
    if (computed(g) <= computed(wg)) wg = g;
  switch (wg) {
    case 1: return tc_tile_dispatch<GroupedMatmul, 1>(in_code, x, w, E, C, N,
                                                      K, rows, ep, s);
    case 2: return tc_tile_dispatch<GroupedMatmul, 2>(in_code, x, w, E, C, N,
                                                      K, rows, ep, s);
    default: return tc_tile_dispatch<GroupedMatmul, 3>(in_code, x, w, E, C,
                                                       N, K, rows, ep, s);
  }
}
