// The grouped MoE matmul (K4) for Hopper (sm_90a): out[e] =
// epilogue(x[e] @ w[e]) for every expert e, on the two tiles that take
// what the tensor-core tile (grouped_matmul_sm90.cu) does not.
//
// Replaces the TPU kernel src/repro/kernels/moe/grouped_matmul.py
// (grouped_matmul_kernel, wrapped by kernels/moe/ops.py::grouped_matmul).
// The TPU kernel walks an (E, C/bm, N/bn, K/bk) grid with a sequential K
// axis and a VMEM accumulator; here each block owns one (expert, row
// tile, column tile), loops over K inside itself and applies the
// operand-free epilogue (softcap, activation, GLU, cast) in registers
// before its one store, so the (E, C, 2 * ff) intermediate of a GLU never
// reaches device memory.  The wrapper picks the tile by K1's rule
// (kernels/matmul/matmul.py::select_tile with M = C):
//   * the decode tile (decode_tile.cuh, ``grouped_matmul_decode_launch``)
//     for C <= 8 rows an expert, every input type, the expert on
//     blockIdx.z;
//   * the SIMT tile (gemm_tile.cuh, ``grouped_matmul_launch``) for fp32,
//     int8 and rows TMA refuses with C > 8, the expert on blockIdx.z.
//
// What bounds it on an H100 at decode: the bytes of the experts that hold
// a row.  OLMoE's gate/up projection, (64, 2048, 2048) bf16, is 537 MB a
// call if every expert is read (0.16 ms at 3.35 TB/s); 4 tokens routed
// top-8 fill about 26.5 of the 64 experts, about 223 MB (0.067 ms).  What
// the design does about that: with ``rows`` (rows[e] promises x[e,
// rows[e]:] is zero, on the device, never read by the host) a block of
// an expert with no row loads nothing and writes epilogue(0), and the
// tile computes only the rows the caller promises may be nonzero (``mr``:
// 4 at 4 tokens, since top-k picks distinct experts); where the experts
// that can hold a row give too few blocks to fill the card, K is split
// across blocks and the splits' sums are added in order in a second
// kernel (no atomics: a result repeats bit for bit).

#include "decode_tile.cuh"
#include "gemm_tile.cuh"

namespace {
struct GroupedMatmul {};   // names this file's instantiations of the tiles
}  // namespace

// x (E, C, K) and w (E, K, N) row-major, w's N = 2 * N_out under GLU
// (gate columns, then up columns); out (E, C, N_out); rows null or (E,)
// int32 on the device.  Returns the CUDA error code of the launch (0 =
// success).
extern "C" int grouped_matmul_launch(
    int in_code, const void* x, const void* w, void* out, int E, int C,
    int N, int K, int glu, int vec_a, int vec_b, const int* rows,
    float softcap, int act, int trivial, int out_code, void* stream) {
  const Epi ep = make_epi(glu, BIAS_ZERO, nullptr, nullptr, nullptr, nullptr,
                          softcap, act, trivial, out_code, out);
  return gemm_tile_dispatch<GroupedMatmul>(
      in_code, x, w, C, N, K, E, (long long)C * K, (long long)K * N, rows,
      vec_a, vec_b, ep, static_cast<cudaStream_t>(stream));
}

// The decode tile, C <= 8: rows past ``mr`` promised zero; K in
// ``splits`` ranges of ``k_split`` rows; with splits > 1, ``ws`` is an
// fp32 (int32 for int8) workspace of (splits, E, C, N) elements.  Returns
// the CUDA error code of the launches.
extern "C" int grouped_matmul_decode_launch(
    int in_code, const void* x, const void* w, void* out, int E, int C,
    int N, int K, int glu, int vec_b, int mr, int splits, int k_split,
    void* ws, const int* rows, float softcap, int act, int trivial,
    int out_code, void* stream) {
  const Epi ep = make_epi(glu, BIAS_ZERO, nullptr, nullptr, nullptr, nullptr,
                          softcap, act, trivial, out_code, out);
  const DecodeArgs args{x, w, E, C, N, K, (long long)C * K, (long long)K * N,
                        rows, splits, k_split, vec_b, ws};
  return decode_tile_dispatch<GroupedMatmul>(
      in_code, args, mr, ep, static_cast<cudaStream_t>(stream));
}
