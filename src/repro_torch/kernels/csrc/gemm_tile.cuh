// The SIMT GEMM tile shared by the fused matmul (K1, fused_matmul.cu) and
// the grouped MoE matmul (K4, grouped_matmul.cu): out = epilogue(A @ B)
// for a batch of independent problems, one per blockIdx.z.
//
// Each block owns one (problem, row tile, column tile), loops over K
// inside itself with its fp32 (int32 for int8) accumulator tile in
// registers (fp8 read a byte an element and decoded as it is staged), and applies the epilogue (scales, bias, softcap, activation,
// GLU, residual, cast) in those registers before its one store.  Operand
// tiles are staged through shared memory with coalesced 16-byte loads
// wherever the row length and alignment allow, and per-element masked
// loads at ragged edges, so any M, N, K works.  One 64x64 tile serves
// what neither the decode tile (M <= 8, decode_tile.cuh) nor the
// tensor-core tile (bf16/fp16, tc_tile.cuh) takes: fp32, int8, fp8 and
// rows TMA refuses.  The epilogue is in epilogue.cuh.
//
// ``Tag`` only names the instantiation (a profiler then tells K1's
// launches from K4's); it changes no code.
//
// Batch z reads A + z * stride_a and B + z * stride_b (in elements); its
// output row r is row z * M + r of one (batch * M, N_out) output, so the
// epilogue operands (bias, scale_a, scale_b, residual) serve only a batch
// of one: a batched caller (K4) passes none of them.  ``rows`` (K4,
// optional, on the device): rows[z] promises that A[z, rows[z]:] is zero;
// a row tile at or past it loads nothing and writes epilogue(0).
//
// Under GLU, B is (K, 2, N/2) flattened to (K, N): output column j reads
// gate column j and up column N/2 + j.  A block's shared B tile holds its
// gate half in columns [0, BN/2) and its up half in [BN/2, BN).

#pragma once

#include "epilogue.cuh"

namespace {

template <typename Tag, typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_tile_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 int M, int N, int K, long long stride_a, long long stride_b,
                 const int* __restrict__ rows, int vec_a, int vec_b,
                 Epi ep) {
  using acc_t = typename AccOf<T>::type;
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int VEC = 16 / sizeof(T);   // elements in one 16-byte load
  static_assert(BK % VEC == 0 && (BN / 2) % VEC == 0, "tile vs 16B loads");
  static_assert(TN % 2 == 0, "GLU pairs gate and up columns in a thread");

  __shared__ acc_t As[BK][BM + 1];   // A tile, transposed; +1: no conflicts
  __shared__ acc_t Bs[BK][BN];

  A += blockIdx.z * stride_a;
  B += blockIdx.z * stride_b;

  const int glu = ep.glu;
  const int n_out = glu ? N / 2 : N;     // output columns
  const int limit = n_out;               // column bound within one half
  const int bno = glu ? BN / 2 : BN;     // output columns per block
  const int o0 = blockIdx.x * bno;
  const int m0 = blockIdx.y * BM;
  // a row tile at or past rows[z] holds only zero rows: no K step
  const int k_end = rows && m0 >= rows[blockIdx.z] ? 0 : K;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  // Shared-tile column of each of this thread's TN accumulators.
  int cols[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j)
    cols[j] = glu ? (j < TN / 2 ? tx * (TN / 2) + j
                                : BN / 2 + tx * (TN / 2) + j - TN / 2)
                  : tx * TN + j;

  acc_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // A tile: BM rows x BK, consecutive threads along K (coalesced).
    for (int q = tid; q < BM * BK / VEC; q += THREADS) {
      const int m = q / (BK / VEC);
      const int kc = (q % (BK / VEC)) * VEC;
      const int gm = m0 + m, gk = k0 + kc;
      const T* src = A + (size_t)gm * K + gk;
      if (vec_a && gm < M && gk + VEC <= K) {
        uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < VEC; ++v) As[kc + v][m] = conv(e[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          As[kc + v][m] = (gm < M && gk + v < K) ? conv(src[v]) : acc_t(0);
      }
    }
    // B tile: BK x BN, consecutive threads along N (coalesced).
    for (int q = tid; q < BK * BN / VEC; q += THREADS) {
      const int k = q / (BN / VEC);
      const int c = (q % (BN / VEC)) * VEC;
      const int gk = k0 + k;
      const int up = glu && c >= BN / 2;
      const int ocol = o0 + (up ? c - BN / 2 : c);
      const T* src = B + (size_t)gk * N + (up ? n_out + ocol : ocol);
      if (vec_b && gk < K && ocol + VEC <= limit) {
        uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < VEC; ++v) Bs[k][c + v] = conv(e[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          Bs[k][c + v] = (gk < K && ocol + v < limit) ? conv(src[v])
                                                      : acc_t(0);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      acc_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][cols[j]];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  // Epilogue on the accumulators in registers, then the one store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {   // under GLU: j < TN/2 pairs j + TN/2
      if (glu && j >= TN / 2) continue;
      const int col = o0 + (glu ? tx * (TN / 2) : tx * TN) + j;
      if (col < n_out)
        finish<acc_t>(acc[i][j], glu ? acc[i][(j + TN / 2) % TN] : acc_t(0),
                      blockIdx.z * M + row, col, N, ep);
    }
  }
}

// 64x64 outputs, 256 threads of 4x4 each.
constexpr int L_BM = 64, L_BN = 64, L_BK = 32, L_TM = 4, L_TN = 4;

// ``batch`` problems of (M, K) @ (K, N); see the strides above.
template <typename Tag, typename T>
void gemm_tile_launch(const void* A, const void* B, int M, int N, int K,
                      int batch, long long stride_a, long long stride_b,
                      const int* rows, int vec_a, int vec_b, const Epi& ep,
                      cudaStream_t stream) {
  const int n_out = ep.glu ? N / 2 : N;
  const int bno = ep.glu ? L_BN / 2 : L_BN;
  dim3 grid((n_out + bno - 1) / bno, (M + L_BM - 1) / L_BM, batch);
  constexpr int threads = (L_BM / L_TM) * (L_BN / L_TN);
  gemm_tile_kernel<Tag, T, L_BM, L_BN, L_BK, L_TM, L_TN>
      <<<grid, threads, 0, stream>>>(static_cast<const T*>(A),
                                     static_cast<const T*>(B), M, N, K,
                                     stride_a, stride_b, rows, vec_a, vec_b,
                                     ep);
}

// Dispatch on the input type code; returns the CUDA error of the launch.
template <typename Tag>
int gemm_tile_dispatch(int in_code, const void* A, const void* B, int M,
                       int N, int K, int batch, long long stride_a,
                       long long stride_b, const int* rows, int vec_a,
                       int vec_b, const Epi& ep, cudaStream_t s) {
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (in_code) {
    case IN_F32:
      gemm_tile_launch<Tag, float>(A, B, M, N, K, batch, stride_a, stride_b,
                                   rows, vec_a, vec_b, ep, s);
      break;
    case IN_F16:
      gemm_tile_launch<Tag, __half>(A, B, M, N, K, batch, stride_a, stride_b,
                                    rows, vec_a, vec_b, ep, s);
      break;
    case IN_BF16:
      gemm_tile_launch<Tag, __nv_bfloat16>(A, B, M, N, K, batch, stride_a,
                                           stride_b, rows, vec_a, vec_b, ep,
                                           s);
      break;
    case IN_I8:
      gemm_tile_launch<Tag, int8_t>(A, B, M, N, K, batch, stride_a, stride_b,
                                    rows, vec_a, vec_b, ep, s);
      break;
    case IN_E4M3:
      gemm_tile_launch<Tag, __nv_fp8_e4m3>(A, B, M, N, K, batch, stride_a,
                                           stride_b, rows, vec_a, vec_b, ep,
                                           s);
      break;
    case IN_E5M2:
      gemm_tile_launch<Tag, __nv_fp8_e5m2>(A, B, M, N, K, batch, stride_a,
                                           stride_b, rows, vec_a, vec_b, ep,
                                           s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
