// Flash (online-softmax) attention on Hopper's tensor cores (sm_90a), for
// bf16 and fp16 at head_dim 64, 128 and 256: K2's tensor-core tile.
//
// Replaces the TPU kernel src/repro/kernels/attention/attention.py:34
// (flash_attention_kernel; its pallas_call in kernels/attention/ops.py:72)
// on the port's prefill path.  The wrapper's rule
// (kernels/attention/attention.py::select_tile) sends it every bf16/fp16
// call at those head dims whose pointers and strides TMA can take;
// flash_attention.cu (SIMT) serves the rest: fp32, other head dims and
// unaligned views.  It computes the same function: causal mask, sliding
// window, logit softcap, GQA/MQA (query head h reads KV head
// h / (H / Hkv)), the key length Sk and a q_start offset, fp32 statistics
// and accumulator, output in q's dtype, and a query that sees no key
// gives exactly 0.  Card-only: TMA, mbarriers and wgmma have no CPU
// stand-in, so the emulated tests leave this source out.
//
// What bounds it on an H100: at the served prefill shapes (a few hundred
// tokens, B = 4) a call reads a few MB and does about a GFLOP, so its
// roofline bound is the bytes (a few microseconds) and what it really
// waits on is the chain inside one block: load a key tile, multiply,
// softmax, multiply again.  What the design does about that:
//   * both products run on the tensor cores: S = Q K^T as
//     wgmma m64n64k16 with Q and K K-major in shared memory, and
//     O += P V as wgmma with P (rounded to q's dtype) taken from
//     registers, since the m64nN accumulator layout of S is the A
//     fragment layout, and V read MN-major through the transpose flag;
//   * q, k and v arrive by TMA through rank-4 tensor maps over
//     (D, S, H, B) built from the caller's strides, so the transposed
//     views the models pass need no copy; D is split into 64-column
//     (128-byte) panels with the 128-byte swizzle, and TMA fills zeros
//     past Sq and Sk, so no load is masked;
//   * a ring of 2 K/V stages, one mbarrier each for K and for V: the load
//     of key tile j+1 is in flight while tile j computes, S starts as
//     soon as K has landed, and a stage is refilled only after the wgmma
//     that read it has retired (wait_group 0, then a block barrier);
//   * the softmax runs on the S accumulators in registers: each row lives
//     in the four lanes of a quad, so its max is two shuffles, and the
//     row sums stay per lane until the epilogue; masks are applied only
//     to the tiles that straddle the causal diagonal, the window's edge
//     or Sk, and tiles wholly outside the band are never loaded;
//   * a block is one warpgroup that owns one (b, h), 64 query rows and
//     64-key tiles: 80 KB of shared memory at head_dim 128, so two blocks
//     share an SM and one's loads overlap the other's products (at 256,
//     160 KB, one block an SM: its O accumulator alone is 128 registers a
//     thread).  On an H100 this ran faster at the served head_dim-128
//     shapes than two warpgroups on 128 rows with 128-key tiles (one
//     block an SM), and 32-key tiles, which would fit two blocks an SM at
//     256, ran slower there (PERF.md §6).  The grid runs the query tiles
//     of one head, then the next head, so the heads that share a KV head
//     run side by side and K and V stream from device memory about once,
//     and the longest causal tiles start first.
// Later work: a producer warp, S of tile j+1 overlapping the softmax of
// tile j, TMA stores of O.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

enum DtypeCode { DT_F16 = 1, DT_BF16 = 2 };

constexpr int PANEL = 64;        // head-dim columns of a panel: 128 bytes
constexpr int STAGES = 2;        // the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIG = -1e30f;   // the running max before any key

constexpr int BQ = 64;           // query rows a block: one warpgroup
constexpr int BKV = 64;          // keys a tile
constexpr int THREADS = 128;

template <int D> struct FaShape {
  static constexpr int NP = D / PANEL;             // panels of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;     // K (or V) of a stage
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// The wgmma forms this kernel issues, for 32 or 64 fp32 accumulators a
// thread (N = 64 or 128): "ss" reads A and B from shared memory (both
// K-major), "rs" reads A from four registers of packed pairs and B
// MN-major (transpose flag).  scale_d = 0 overwrites the accumulators.
#define FA_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define FA_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define FA_OUT8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
  "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_OUT32(d) FA_OUT8(d, 0), FA_OUT8(d, 8), FA_OUT8(d, 16), FA_OUT8(d, 24)
#define FA_OUT64(d)                                                        \
  FA_OUT32(d), FA_OUT8(d, 32), FA_OUT8(d, 40), FA_OUT8(d, 48), FA_OUT8(d, 56)
#define FA_SS(N, TY, REGS, OUTS, A, B, P)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."    \
               TY " " REGS ", " A ", " B ", p, 1, 1, 0, 0;\n}\n"           \
               : OUTS : "l"(da), "l"(db), "r"(scale_d))
#define FA_RS(N, TY, REGS, OUTS, A, B, P)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "."    \
               TY " " REGS ", " A ", " B ", p, 1, 1, 1;\n}\n"              \
               : OUTS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),       \
                 "l"(db), "r"(scale_d))

// d (64 x 64) (+)= A (64 x 16) @ B (16 x 64), A and B in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    FA_SS(64, "bf16", FA_REGS32, FA_OUT32(d), "%32", "%33", "%34");
  else
    FA_SS(64, "f16", FA_REGS32, FA_OUT32(d), "%32", "%33", "%34");
}

// d (64 x N) += A (64 x 16, four registers a thread) @ B (16 x N, in
// shared memory MN-major).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "O panels are 64 or 128 columns");
  const int scale_d = 1;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (N == 64)
      FA_RS(64, "bf16", FA_REGS32, FA_OUT32(d), "{%32, %33, %34, %35}",
            "%36", "%37");
    else
      FA_RS(128, "bf16", FA_REGS64, FA_OUT64(d), "{%64, %65, %66, %67}",
            "%68", "%69");
  } else {
    if constexpr (N == 64)
      FA_RS(64, "f16", FA_REGS32, FA_OUT32(d), "{%32, %33, %34, %35}",
            "%36", "%37");
    else
      FA_RS(128, "f16", FA_REGS64, FA_OUT64(d), "{%64, %65, %66, %67}",
            "%68", "%69");
  }
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Two floats rounded to T, packed with the first in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float a,
                                                                float b);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a,
                                                              float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One thread loads key tile j (keys key0..) into stage j % STAGES: each of
// K and V as NP boxes of BKV rows by 64 columns, each reported to its own
// barrier.
template <int D>
__device__ __forceinline__ void issue_kv(uint8_t* ring, uint64_t* k_full,
                                         uint64_t* v_full,
                                         const CUtensorMap* map_k,
                                         const CUtensorMap* map_v, int j,
                                         int key0, int hk, int b) {
  using S = FaShape<D>;
  const int s = j % STAGES;
  uint8_t* ks = ring + s * 2 * S::KV_BYTES;
  uint8_t* vs = ks + S::KV_BYTES;
  mbar_expect_tx(&k_full[s], S::KV_BYTES);
#pragma unroll
  for (int p = 0; p < S::NP; ++p)
    tma_load_4d(ks + p * BKV * 128, map_k, &k_full[s], p * PANEL, key0, hk,
                b);
  mbar_expect_tx(&v_full[s], S::KV_BYTES);
#pragma unroll
  for (int p = 0; p < S::NP; ++p)
    tma_load_4d(vs + p * BKV * 128, map_v, &v_full[s], p * PANEL, key0, hk,
                b);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          T* __restrict__ o, int H, int Hkv, int Sq, int Sk,
                          long long ob, long long oh, long long os,
                          float sm_scale, int causal, int window,
                          float softcap, int q_start) {
  using S = FaShape<D>;
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  __shared__ uint64_t q_full, k_full[STAGES], v_full[STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: every panel starts there
  uint8_t* qs = fa_smem + ((1024 - (smem_u32(fa_smem) & 1023)) & 1023);
  uint8_t* ring = qs + S::Q_BYTES;   // stage s: K, then V

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;

  // The key tiles that can hold a key some row of this block sees; tiles
  // wholly outside the causal/window band add p = 0 and are skipped.
  const int q_last = q_start + min(q0 + BQ, Sq) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q_start + q0 - window + 1) : 0;
  const int t0 = lo / BKV;
  const int nt = hi > lo ? (hi + BKV - 1) / BKV - t0 : 0;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&q_full, S::Q_BYTES);
#pragma unroll
    for (int p = 0; p < S::NP; ++p)
      tma_load_4d(qs + p * BQ * 128, &map_q, &q_full, p * PANEL, q0, h, b);
    for (int j = 0; j < STAGES && j < nt; ++j)
      issue_kv<D>(ring, k_full, v_full, &map_k, &map_v, j, (t0 + j) * BKV,
                  hk, b);
  }

  // Accumulator layout of m64nN: register 4j + q of lane l in warp w
  // holds row 16w + l/4 (+8 for q >= 2), column 8j + 2(l%4) + (q & 1).
  // So a thread holds two rows, r = 0 and 1.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_BIG, NEG_BIG};   // running max, log2 units
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sum
  const int row0 = q0 + w * 16 + lane / 4;
  const int qpos0 = q_start + row0;              // row 0's position
  const int warp_q = q_start + q0 + w * 16;      // the warp's first position
  const float scale2 = sm_scale * LOG2E;

  mbar_wait(&q_full, 0);
  const uint32_t qa = smem_u32(qs);

  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES, parity = (j / STAGES) & 1;
    const int kv0 = (t0 + j) * BKV;
    const uint32_t ka = smem_u32(ring + s * 2 * S::KV_BYTES);
    const uint32_t va = ka + S::KV_BYTES;

    // S = Q K^T: Q's and K's rows are 128-byte panel rows of 64 head-dim
    // values, 8-row groups 1024 bytes apart; a 16-deep step is 32 bytes
    // along the row, and every fourth step the next panel.
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], parity);
    __syncwarp();                 // wgmma below is warp-aligned
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<T>(sc,
                  sw128_desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16,
                             1024),
                  sw128_desc(ka + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16,
                             1024),
                  kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<BKV / 2>(sc);

    // Scores in log2 units, masked where the tile straddles an edge.
    if (softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sc[i] = tanhf(sc[i] * sm_scale / softcap) * (softcap * LOG2E);
    } else {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale2;
    }
    const bool edge = kv0 + BKV > Sk || (causal && kv0 + BKV - 1 > warp_q)
                      || (window > 0 && warp_q + 15 - kv0 >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const int qp = qpos0 + 8 * ((i % 4) / 2);
        const bool ok = key < Sk && (!causal || key <= qp)
                        && (window <= 0 || qp - key < window);
        if (!ok) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
    // P in q's dtype, packed as the A fragment of P V: register 4kk + r
    // of the fragment of key step kk is the pair S registers 8kk + 2r,
    // 8kk + 2r + 1.  Masked scores are -inf and give p = 0.
    uint32_t pa[BKV / 4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BKV / 2; i += 2) {
      const int r = (i % 4) / 2;
      const float p0 = exp2f(sc[i] - mx[r]), p1 = exp2f(sc[i + 1] - mx[r]);
      ps[r] += p0 + p1;
      pa[i / 2] = pack2<T>(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ps[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

    // O += P V: V's panels are BKV rows of 64 head-dim columns, read
    // MN-major; a 16-deep step is 16 rows, the two panels of one wgmma
    // BKV * 128 bytes apart, 8-row groups 1024 bytes apart.
    mbar_wait(&v_full[s], parity);
    __syncwarp();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs<T, 64>(acc, pa + 4 * kk,
                        sw128_desc(va + kk * 16 * 128, BKV * 128, 1024));
      } else {
#pragma unroll
        for (int n = 0; n < D / 128; ++n)
          wgmma_rs<T, 128>(acc + 64 * n, pa + 4 * kk,
                           sw128_desc(va + 2 * n * BKV * 128 + kk * 16 * 128,
                                      BKV * 128, 1024));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<D / 2>(acc);
    fence_regs<BKV / 4>(pa);
    __syncthreads();   // every warp's products of stage s retired
    if (tid == 0 && j + STAGES < nt)
      issue_kv<D>(ring, k_full, v_full, &map_k, &map_v, j + STAGES,
                  (t0 + j + STAGES) * BKV, hk, b);
  }

  // O / l in q's dtype; a row that saw no key has l = 0 and gives 0.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  T* ob_h = o + b * ob + h * oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    T* orow = ob_h + row * os + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj) =
          pack2<T>(acc[4 * jj + 2 * r] * inv[r],
                   acc[4 * jj + 2 * r + 1] * inv[r]);
  }
}

// (B, N, S, D) 16-bit values at element strides (sb, sn, ss, 1), loaded
// as boxes of 64 head-dim columns by ``rows`` positions of one (b, n),
// with the 128-byte swizzle and zeros past S.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int D, int S, int N, int B, long long ss, long long sn,
                long long sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {PANEL, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_fn()(map, type, 4, const_cast<void*>(ptr), dims, strides,
                     box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, int D>
int launch(CUtensorMapDataType type, const void* q, const void* k,
           const void* v, void* o, int B, int H, int Hkv, int Sq, int Sk,
           const long long* st, float sm_scale, int causal, int window,
           float softcap, int q_start, cudaStream_t stream) {
  using S = FaShape<D>;
  CUtensorMap map_q, map_k, map_v;
  if (encode(&map_q, type, q, D, Sq, H, B, st[2], st[1], st[0], BQ) !=
          CUDA_SUCCESS ||
      encode(&map_k, type, k, D, Sk, Hkv, B, st[5], st[4], st[3], BKV) !=
          CUDA_SUCCESS ||
      encode(&map_v, type, v, D, Sk, Hkv, B, st[8], st[7], st[6], BKV) !=
          CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      flash_attention_tc_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_tc_kernel<T, D><<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      map_q, map_k, map_v, static_cast<T*>(o), H, Hkv, Sq, Sk, st[9],
      st[10], st[11], sm_scale, causal, window, softcap, q_start);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(CUtensorMapDataType type, int D, const void* q,
               const void* k, const void* v, void* o, int B, int H, int Hkv,
               int Sq, int Sk, const long long* st, float sm_scale,
               int causal, int window, float softcap, int q_start,
               cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(type, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                  sm_scale, causal, window, softcap,
                                  q_start, s);
    case 128: return launch<T, 128>(type, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                    sm_scale, causal, window, softcap,
                                    q_start, s);
    case 256: return launch<T, 256>(type, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                    sm_scale, causal, window, softcap,
                                    q_start, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Sk, D), o like q, bf16 or fp16, each with
// unit stride along D, a 16-byte aligned base and the element strides in
// `strides` (q b/h/s, k b/h/s, v b/h/s, o b/h/s), all but o's whole
// 16-byte units; D is 64, 128 or 256; Sq, Sk > 0.  Returns the CUDA error
// code of the launch (0 = success).
extern "C" int flash_attention_tc_launch(
    int dtype_code, int D, const void* q, const void* k, const void* v,
    void* o, int B, int H, int Hkv, int Sq, int Sk,
    const long long* strides, float sm_scale, int causal, int window,
    float softcap, int q_start, void* stream) {
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (dtype_code) {
    case DT_F16:
      return dispatch_d<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, D, q, k, v,
                                o, B, H, Hkv, Sq, Sk, strides, sm_scale,
                                causal, window, softcap, q_start, s);
    case DT_BF16:
      return dispatch_d<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, D, q,
                                       k, v, o, B, H, Hkv, Sq, Sk, strides,
                                       sm_scale, causal, window, softcap,
                                       q_start, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
