// The tensor-core tile for Hopper (sm_90a), shared by the fused matmul
// (K1, fused_matmul_sm90.cu) and the grouped MoE matmul (K4,
// grouped_matmul_sm90.cu): out[z] = epilogue(A[z] @ B[z]) for bf16 and
// fp16, one problem per blockIdx.z (K1 has one, K4 one per expert).
// Card-only: TMA and wgmma have no CPU stand-in, so the emulated tests
// leave out the sources that include this header.
//
// The design (the notes on what bounds each caller are in its source):
//   * the products run on the tensor cores: wgmma.mma_async m64n128k16,
//     bf16/fp16 in, fp32 accumulators in registers;
//   * a block owns 64 * WG rows (WG warpgroups of 64, WG = 1 to 3) by
//     128 columns of B (under GLU 64 gate and the matching 64 up columns,
//     so 64 outputs), and walks K in 64-deep steps.  K1 runs WG = 2; K4
//     picks WG from its row count;
//   * operands arrive by TMA: rank-3 tensor maps of A (Z, M, K) and B
//     (Z, K, N), the problem outermost, one thread issuing the loads into
//     a ring of 4 stages in dynamic shared memory, an mbarrier per stage
//     reporting their arrival.  A box stops at its own problem's edge and
//     TMA fills zeros past M, N and K, so ragged edges need no masked
//     loads and no tile reads the next problem's rows;
//   * A is K-major.  B (K, N) row-major is MN-major: it arrives as two
//     panels of 64 columns (128 bytes) by 64 rows with the 128-byte
//     swizzle, and wgmma reads it with the B-transpose flag (16-bit types
//     only).  Under GLU the two panels are the gate columns o0..o0+63 and
//     the up columns N/2+o0.., so a thread's accumulators hold each gate
//     column beside its up column and the GLU pairs in registers;
//   * a stage is refilled only after the wgmma that read it has retired
//     (wait_group 1, then a block barrier);
//   * the epilogue (epilogue.cuh) runs on the accumulators in registers,
//     with row and column masks, before the one store.  Output row r of
//     problem z is row z * M + r of one (Z * M, N_out) output, so the
//     epilogue operands (scales, bias, residual) serve only Z = 1: K4
//     passes none;
//   * ``rows`` (optional, on the device): rows[z] promises that A[z,
//     rows[z]:] is zero.  A block whose rows all lie at or past it loads
//     nothing and writes epilogue(0), so the result is the same function
//     of A.
// The grid runs x over row tiles first, so the blocks that share one
// column panel of B[z] run together and the panel streams from device
// memory about once.
// Later work: a producer warp (warp specialisation), persistent blocks,
// clusters, TMA stores.
//
// The host side encodes the two tensor maps on every call with
// cuTensorMapEncodeTiled (sm90.cuh's encode_fn), so the libraries need no
// -lcuda.

#pragma once

#include "epilogue.cuh"
#include "sm90.cuh"

namespace {

constexpr int TC_BN = 128;                 // columns of B: two panels
constexpr int TC_BK = 64;                  // K rows a stage holds
constexpr int TC_STAGES = 4;
constexpr int TC_PANEL = 64;               // columns of a B panel (128 B)
constexpr int TC_P_BYTES = TC_BK * TC_PANEL * 2;       // 8 KB

// The block of WG warpgroups: 64 rows each.
template <int WG> struct TcShape {
  static constexpr int BM = 64 * WG;
  static constexpr int THREADS = 128 * WG;
  static constexpr int A_BYTES = BM * TC_BK * 2;              // 8 KB a WG
  static constexpr int STAGE_BYTES = A_BYTES + 2 * TC_P_BYTES;
  static constexpr int SMEM_BYTES = TC_STAGES * STAGE_BYTES + 1024;
};

// d += A (64 x 16, K-major) @ B (16 x 128, MN-major), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da,
                                          uint64_t db);

template <>
__device__ __forceinline__ void wgmma_128<__nv_bfloat16>(float* d,
                                                         uint64_t da,
                                                         uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_128<__half>(float* d, uint64_t da,
                                                  uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// One thread loads K step ``kt`` of problem z into its stage: A's BM x 64
// box at (kt * 64, m0) and B's two 64 x 64 panels at columns nb0 and nb1.
template <int WG>
__device__ __forceinline__ void issue_stage(uint8_t* base, uint64_t* full,
                                            const CUtensorMap* map_a,
                                            const CUtensorMap* map_b, int kt,
                                            int m0, int nb0, int nb1, int z) {
  using S = TcShape<WG>;
  const int s = kt % TC_STAGES;
  uint8_t* st = base + s * S::STAGE_BYTES;
  mbar_expect_tx(&full[s], S::STAGE_BYTES);
  tma_load(st, map_a, &full[s], kt * TC_BK, m0, z);
  tma_load(st + S::A_BYTES, map_b, &full[s], nb0, kt * TC_BK, z);
  tma_load(st + S::A_BYTES + TC_P_BYTES, map_b, &full[s], nb1, kt * TC_BK,
           z);
}

template <typename Tag, typename T, int WG>
__global__ void __launch_bounds__(TcShape<WG>::THREADS, 1)
tc_tile_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, int M, int N,
               int K, const int* __restrict__ rows, Epi ep) {
  using S = TcShape<WG>;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ uint64_t full[TC_STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: stages start there
  uint8_t* base = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);

  const int glu = ep.glu;
  const int n_out = glu ? N / 2 : N;
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * S::BM;
  const int o0 = blockIdx.y * (glu ? TC_PANEL : TC_BN);  // first output col
  const int nb0 = o0;                                    // the two panels'
  const int nb1 = glu ? n_out + o0 : o0 + TC_PANEL;      // first B columns
  // a row tile at or past rows[z] holds only zero rows: it loads nothing
  // and its accumulators stay 0
  const int kt_n = rows && m0 >= rows[z] ? 0 : (K + TC_BK - 1) / TC_BK;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int kt = 0; kt < TC_STAGES - 1 && kt < kt_n; ++kt)
      issue_stage<WG>(base, full, &map_a, &map_b, kt, m0, nb0, nb1, z);

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_acc(d);

  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % TC_STAGES;
    mbar_wait(&full[s], (kt / TC_STAGES) & 1);
    __syncwarp();                 // wgmma below is warp-aligned
    const uint32_t a0 = smem_u32(base + s * S::STAGE_BYTES) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(base + s * S::STAGE_BYTES + S::A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      // A: 128-byte rows of 64 K values, 8-row groups 1024 bytes apart; a
      // 16-deep step is 32 bytes along the row.  B: rows of 128 bytes
      // (one panel's 64 columns), 8-row groups 1024 bytes apart, the next
      // panel TC_P_BYTES on; a 16-deep step is 16 rows.
      wgmma_128<T>(d, sw128_desc(a0 + kk * 32, 16, 1024),
                   sw128_desc(b0 + kk * 16 * 128, TC_P_BYTES, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous step's products have retired, so its stage is free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);
    __syncthreads();
    if (tid == 0 && kt + TC_STAGES - 1 < kt_n)
      issue_stage<WG>(base, full, &map_a, &map_b, kt + TC_STAGES - 1, m0,
                      nb0, nb1, z);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // Accumulator layout of m64n128: register 4j + q of lane l in warp w of
  // the warpgroup holds row 16w + l/4 (+8 for q >= 2), column
  // 8j + 2(l%4) + (q & 1) of the 128 B columns.
  const int w = (tid % 128) / 32, l = tid % 32;
  const int r0 = m0 + wg * 64 + w * 16 + l / 4;
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (glu && j >= TC_PANEL / 8) continue;
      const int row = r0 + (q >= 2 ? 8 : 0);
      const int col = o0 + 8 * j + 2 * (l % 4) + (q & 1);
      if (row < M && col < n_out)
        finish<float>(d[4 * j + q], glu ? d[(4 * j + q + 32) % 64] : 0.f,
                      z * M + row, col, N, ep);
    }
  }
}

// Z row-major (rows, cols) 16-bit matrices, one after another, loaded as
// boxes of (box_rows, box_cols) of one matrix with the 128-byte swizzle
// and zeros past its extent.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int Z, int rows, int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(Z)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_fn()(map, type, 3, const_cast<void*>(ptr), dims, strides,
                     box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename Tag, typename T, int WG>
int tc_tile_launch(CUtensorMapDataType type, const void* A, const void* B,
                   int Z, int M, int N, int K, const int* rows,
                   const Epi& ep, cudaStream_t stream) {
  using S = TcShape<WG>;
  CUtensorMap map_a, map_b;
  if (encode(&map_a, type, A, Z, M, K, S::BM, TC_BK) != CUDA_SUCCESS ||
      encode(&map_b, type, B, Z, K, N, TC_BK, TC_PANEL) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      tc_tile_kernel<Tag, T, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  const int n_out = ep.glu ? N / 2 : N;
  const int bno = ep.glu ? TC_PANEL : TC_BN;
  dim3 grid((M + S::BM - 1) / S::BM, (n_out + bno - 1) / bno, Z);
  tc_tile_kernel<Tag, T, WG><<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      map_a, map_b, M, N, K, rows, ep);
  return static_cast<int>(cudaGetLastError());
}

// Z problems of A (M, K) @ B (K, N), row-major bf16 or fp16 one after
// another, both 16-byte aligned, K and N (and N/2 under GLU) multiples of
// 8; out (Z * M, N) or (Z * M, N/2) under GLU.  Returns the CUDA error
// code of the launch (0 = success).
template <typename Tag, int WG>
int tc_tile_dispatch(int in_code, const void* A, const void* B, int Z, int M,
                     int N, int K, const int* rows, const Epi& ep,
                     cudaStream_t s) {
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (in_code) {
    case IN_F16:
      return tc_tile_launch<Tag, __half, WG>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                                             A, B, Z, M, N, K, rows, ep, s);
    case IN_BF16:
      return tc_tile_launch<Tag, __nv_bfloat16, WG>(
          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, B, Z, M, N, K, rows, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
