// The decode tile, shared by the fused matmul (K1, fused_matmul.cu) and
// the grouped MoE matmul (K4, grouped_matmul.cu): out[z] =
// epilogue(A[z] @ B[z]) for M <= 8 rows, one problem per blockIdx.z (K1
// has one, K4 one per expert).  The shape of every decode step, of each
// prefill's logits call and of K4's decode capacity.
//
// What bounds it on an H100: each weight byte is used for at most 8 rows
// (at most 16 operations a byte), so the time is reading B once at the
// memory rate.  What the design does about that:
//   * B is read with 8-element vector loads along N (16 bytes in bf16 and
//     fp16, two of 16 in fp32, 8 in int8 and fp8): each thread owns 8 output
//     columns (8 gate and 8 up columns of B under GLU), and the 32 lanes
//     of a warp read 256 consecutive columns of one row;
//   * each thread keeps all MR rows' accumulators (fp32, int32 for int8)
//     in registers; fp8 is decoded to fp32 element by element;
//   * A (at most 8 rows) sits in shared memory in its own type, K-chunked
//     and laid out [k][row], so a warp reads one row's values as a
//     broadcast;
//   * the 8 warps of a block split the block's K rows among them, and each
//     warp issues U rows of loads before it multiplies, so 8 16-byte loads
//     a thread are in flight (4 at 8 rows under GLU, where the
//     accumulators take half the registers);
//   * where N alone gives too few blocks to fill the card, the wrapper
//     also splits K across blocks (``splits`` > 1): each block writes its
//     partial sums to an fp32 (int32) workspace, and a second kernel adds
//     them in split order and applies the epilogue.  Every sum is taken
//     in a fixed order (rows within a warp, then warps, then splits): no
//     atomics, so a result repeats bit for bit from run to run;
//   * ``rows`` (K4, optional, on the device): rows[z] promises that A[z,
//     rows[z]:] is zero, and the caller may promise on the host that
//     every row past ``mr`` is zero.  The tile computes only rows below
//     both (MR, the rows its registers hold, is picked from ``mr``); a
//     problem with no row loads nothing, and every row past them is
//     written as epilogue(0), so the result is the same function of A.
//     At OLMoE's decode (4 tokens, top-8 of 64 experts) at most 32
//     experts hold a row, so at most half the weights are read.
//
// Under GLU, B is (K, 2, N/2) flattened to (K, N): output column j reads
// gate column j and up column N/2 + j.  Problem z reads A + z * stride_a
// and B + z * stride_b (in elements); its output row r is row z * M + r
// of one (Z * M, N_out) output, so the epilogue operands (scales, bias,
// residual) serve only Z = 1: K4 passes none.

#pragma once

#include "epilogue.cuh"

namespace {

constexpr int D_WARPS = 8;               // warps of a block, each on its own K rows
constexpr int D_THREADS = 32 * D_WARPS;
constexpr int D_COLS = 8;                // output columns a thread owns
constexpr int D_BNO = 32 * D_COLS;       // output columns a block owns
constexpr int D_KA = 512;                // rows of A staged in shared memory at a time
constexpr int D_CH = 16;                 // accumulators a round of the warp reduction takes
constexpr int D_RED_THREADS = 256;       // threads of a block of the split reduction

// 8 consecutive elements of one row of B, as one or two vector loads;
// one 8-byte load for the one-byte types (int8, fp8 e4m3fn and e5m2).
template <typename T, int BYTES = sizeof(T)> struct Row8 {
  using V = uint4;
  static constexpr int n = sizeof(T) / 2;
  V r[n];
};
template <typename T> struct Row8<T, 1> {
  using V = uint2;
  static constexpr int n = 1;
  V r[n];
};

// Row8 from p[0..valid): vector loads where all 8 are valid and ``vec``
// says the row is aligned for them, else element by element, zeros past
// ``valid``.
template <typename T>
__device__ __forceinline__ void load_row8(Row8<T>& d, const T* p, int valid,
                                          int vec) {
  if (vec && valid >= D_COLS) {
#pragma unroll
    for (int i = 0; i < Row8<T>::n; ++i)
      d.r[i] = reinterpret_cast<const typename Row8<T>::V*>(p)[i];
  } else {
    d = Row8<T>{};
    T* e = reinterpret_cast<T*>(&d);
#pragma unroll
    for (int v = 0; v < D_COLS; ++v)
      if (v < valid) e[v] = p[v];
  }
}

// One block: problem blockIdx.z, output columns [blockIdx.x * D_BNO,
// +D_BNO), K rows [blockIdx.y * k_split, +k_split).  With ``ws`` null it
// applies the epilogue and stores; else it stores its partial sums at
// ws[blockIdx.y][blockIdx.z][row][B column] for the rows below MR.
// Up to 4 rows of 16- or 8-bit inputs: two blocks an SM (at most 128
// registers a thread), so that one block's barriers and reduction overlap
// the other's loads.  Unbounded, the bf16 4-row GLU variant (K1's and
// K4's served decode) takes more than 128 registers: one block an SM.
template <typename Tag, typename T, int MR, bool GLU>
__global__ void __launch_bounds__(D_THREADS,
                                  MR <= 4 && sizeof(T) <= 2 ? 2 : 1)
decode_tile_kernel(const T* __restrict__ A, const T* __restrict__ B, int M,
                   int N, int K, long long stride_a, long long stride_b,
                   const int* __restrict__ rows, int k_split, int vec_b,
                   typename AccOf<T>::type* __restrict__ ws, Epi ep) {
  using acc_t = typename AccOf<T>::type;
  constexpr int NH = GLU ? 2 : 1;        // column groups of B a thread reads
  // rows a warp loads before it multiplies: 8 vector loads a thread in
  // flight, 4 where 128 accumulators (8 rows under GLU) leave no room
  constexpr int U = MR * NH >= 16 ? 2 : GLU ? 4 : 8;
  constexpr int FLAT = MR * D_COLS * NH;
  constexpr int CH = FLAT < D_CH ? FLAT : D_CH;
  static_assert(D_KA % (D_WARPS * U) == 0, "A chunk vs the warps' rows");
  static_assert(D_KA * MR * sizeof(T) % 16 == 0, "A chunk in whole uint4s");

  __shared__ uint4 a_raw[D_KA * MR * sizeof(T) / 16];
  __shared__ acc_t red[D_WARPS][CH][32];
  T* As = reinterpret_cast<T*>(a_raw);    // As[k * MR + row]

  const int n_out = GLU ? N / 2 : N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int z = blockIdx.z;
  A += z * stride_a;
  B += z * stride_b;
  const int c0 = blockIdx.x * D_BNO + lane * D_COLS;
  const int valid = n_out - c0;           // this thread's columns in range
  // rows that may be nonzero; a problem with none loads nothing
  const int mc = min(min(M, MR), rows ? rows[z] : M);
  const int kb = blockIdx.y * k_split;
  const int ke = mc > 0 ? min(K, kb + k_split) : kb;

  acc_t acc[MR][D_COLS][NH];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < D_COLS; ++j)
#pragma unroll
      for (int h = 0; h < NH; ++h) acc[m][j][h] = 0;

  for (int ka = kb; ka < ke; ka += D_KA) {
    const int kn = min(D_KA, ke - ka);
    __syncthreads();                      // the last chunk's reads are done
    for (int q = threadIdx.x; q < MR * D_KA; q += D_THREADS) {
      const int m = q / D_KA, k = q % D_KA;
      T v{};
      if (m < mc && k < kn) v = A[(size_t)m * K + ka + k];
      As[k * MR + m] = v;
    }
    __syncthreads();
    for (int k0 = warp * U; k0 < kn; k0 += D_WARPS * U) {
      Row8<T> rb[U][NH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* row = B + (size_t)(ka + k0 + u) * N;
        const int v = k0 + u < kn ? valid : 0;
        load_row8(rb[u][0], row + c0, v, vec_b);
        if (GLU) load_row8(rb[u][NH - 1], row + n_out + c0, v, vec_b);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc_t a[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) a[m] = conv(As[(k0 + u) * MR + m]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const T* e = reinterpret_cast<const T*>(&rb[u][h]);
#pragma unroll
          for (int j = 0; j < D_COLS; ++j) {
            const acc_t b = conv(e[j]);
#pragma unroll
            for (int m = 0; m < MR; ++m) acc[m][j][h] += a[m] * b;
          }
        }
      }
    }
  }

  // Add the warps' sums in warp order, CH accumulators a round: every
  // thread writes its round's values, then each (output, lane) pair of the
  // round is summed by one thread, which finishes or stores it.
#pragma unroll
  for (int f0 = 0; f0 < FLAT; f0 += CH) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int f = f0 + i;
      red[warp][i][lane] = acc[f / (D_COLS * NH)][(f / NH) % D_COLS][f % NH];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (CH / NH) * 32; e += D_THREADS) {
      const int p = e / 32, l = e % 32;
      acc_t s[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        s[h] = 0;
        for (int w = 0; w < D_WARPS; ++w) s[h] += red[w][p * NH + h][l];
      }
      const int f = f0 + p * NH;
      const int row = f / (D_COLS * NH);
      const int col = blockIdx.x * D_BNO + l * D_COLS + (f / NH) % D_COLS;
      if (row < M && col < n_out) {
        if (ws) {
          acc_t* dst =
              ws + (((size_t)blockIdx.y * gridDim.z + z) * M + row) * N;
          dst[col] = s[0];
          if (GLU) dst[n_out + col] = s[NH - 1];
        } else {
          finish<acc_t>(s[0], GLU ? s[NH - 1] : acc_t(0), z * M + row, col,
                        N, ep);
        }
      }
    }
    __syncthreads();
  }
  // Rows past MR (only where the caller promised them zero): epilogue(0).
  if (!ws)
    for (int e = threadIdx.x; e < (M - MR) * D_BNO; e += D_THREADS) {
      const int col = blockIdx.x * D_BNO + e % D_BNO;
      if (col < n_out)
        finish<acc_t>(acc_t(0), acc_t(0), z * M + MR + e / D_BNO, col, N,
                      ep);
    }
}

// The split-K epilogue: one thread per output element (global row r =
// z * M + row) adds the splits' partial sums in split order, then
// finishes it; rows at or past ``mr`` (the tile's MR) were promised zero.
template <typename Tag, typename acc_t>
__global__ void __launch_bounds__(D_RED_THREADS)
decode_reduce_kernel(const acc_t* __restrict__ ws, int splits, int Z, int M,
                     int mr, int N, Epi ep) {
  const int n_out = ep.glu ? N / 2 : N;
  const long long i = (long long)blockIdx.x * D_RED_THREADS + threadIdx.x;
  if (i >= (long long)Z * M * n_out) return;
  const int r = i / n_out, col = i % n_out;
  acc_t g = 0, u = 0;
  if (r % M < mr)
    for (int s = 0; s < splits; ++s) {
      const acc_t* p = ws + ((size_t)s * Z * M + r) * N;
      g += p[col];
      if (ep.glu) u += p[n_out + col];
    }
  finish<acc_t>(g, u, r, col, N, ep);
}

// Launch arguments shared by the decode tile's entry points.
struct DecodeArgs {
  const void* A;
  const void* B;
  int Z, M, N, K;
  long long stride_a, stride_b;   // elements between problems
  const int* rows;                // (Z,) on the device, or null
  int splits, k_split, vec_b;
  void* ws;   // (splits, Z, M, N) fp32 (int32 for int8) when splits > 1
};

template <typename Tag, typename T, int MR, bool GLU>
void decode_tile_launch_mr(const DecodeArgs& a, const Epi& ep,
                           cudaStream_t stream) {
  using acc_t = typename AccOf<T>::type;
  const int n_out = GLU ? a.N / 2 : a.N;
  acc_t* w = a.splits > 1 ? static_cast<acc_t*>(a.ws) : nullptr;
  dim3 grid((n_out + D_BNO - 1) / D_BNO, a.splits, a.Z);
  decode_tile_kernel<Tag, T, MR, GLU><<<grid, D_THREADS, 0, stream>>>(
      static_cast<const T*>(a.A), static_cast<const T*>(a.B), a.M, a.N, a.K,
      a.stride_a, a.stride_b, a.rows, a.k_split, a.vec_b, w, ep);
  if (w) {
    const long long n = (long long)a.Z * a.M * n_out;
    const int blocks = (int)((n + D_RED_THREADS - 1) / D_RED_THREADS);
    decode_reduce_kernel<Tag, acc_t><<<blocks, D_RED_THREADS, 0, stream>>>(
        w, a.splits, a.Z, a.M, a.M < MR ? a.M : MR, a.N, ep);
  }
}

// The accumulators are sized for MR = 1, 4 or 8 rows, the fewest that
// hold ``mr`` (rows past mr are promised zero; mr = M where nothing is).
template <typename Tag, typename T>
void decode_tile_launch(const DecodeArgs& a, int mr, const Epi& ep,
                        cudaStream_t s) {
  if (ep.glu) {
    if (mr <= 1) decode_tile_launch_mr<Tag, T, 1, true>(a, ep, s);
    else if (mr <= 4) decode_tile_launch_mr<Tag, T, 4, true>(a, ep, s);
    else decode_tile_launch_mr<Tag, T, 8, true>(a, ep, s);
  } else {
    if (mr <= 1) decode_tile_launch_mr<Tag, T, 1, false>(a, ep, s);
    else if (mr <= 4) decode_tile_launch_mr<Tag, T, 4, false>(a, ep, s);
    else decode_tile_launch_mr<Tag, T, 8, false>(a, ep, s);
  }
}

// Dispatch on the input type code; returns the CUDA error of the launch.
template <typename Tag>
int decode_tile_dispatch(int in_code, const DecodeArgs& a, int mr,
                         const Epi& ep, cudaStream_t s) {
  if (a.M < 1 || a.M > 8 || mr < 0 || mr > a.M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (in_code) {
    case IN_F32: decode_tile_launch<Tag, float>(a, mr, ep, s); break;
    case IN_F16: decode_tile_launch<Tag, __half>(a, mr, ep, s); break;
    case IN_BF16: decode_tile_launch<Tag, __nv_bfloat16>(a, mr, ep, s); break;
    case IN_I8: decode_tile_launch<Tag, int8_t>(a, mr, ep, s); break;
    case IN_E4M3: decode_tile_launch<Tag, __nv_fp8_e4m3>(a, mr, ep, s); break;
    case IN_E5M2: decode_tile_launch<Tag, __nv_fp8_e5m2>(a, mr, ep, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
