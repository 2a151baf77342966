// Flash (online-softmax) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/attention.py
// (flash_attention_kernel, wrapped by kernels/attention/ops.py::
// flash_attention): causal mask, sliding window, logit softcap, GQA,
// the key-length mask and a q_start offset for chunked prefill, fp32
// statistics and accumulator, output in q's dtype, and a fully masked
// row gives 0, not NaN.  Inputs fp32, fp16, bf16 or int8: int8 q, k and
// v are read as they lie and converted to fp32, as the reference casts
// them, and the output is (acc / l) truncated toward zero into int8, as
// its astype does.
//
// What bounds it on an H100: at the prefill shapes of the serving path
// (a few hundred tokens, head_dim 128) the QK^T and PV products dominate
// and it is compute-bound; the (Sq x Sk) score matrix is what must stay
// out of device memory.  What the design does:
//   * one block per (batch*head, 64-query tile) keeps its queries, its
//     running max/sum and its (64 x D) fp32 accumulator on chip, and
//     loops over 32-key tiles inside the block; that loop replaces the
//     TPU's sequential grid axis, since blocks run in parallel here;
//   * scores and probabilities live only in registers and one small
//     shared tile, so device memory sees q, k, v once and o once;
//   * key tiles wholly outside the causal/window band are skipped,
//     which changes no result (they add p = 0 and leave the max alone);
//   * this first version is SIMT fp32 arithmetic, not tensor cores;
//     wgmma is later work.
// Four threads share a query row: each holds 8 of the tile's 32 scores
// and D/4 of the row's output columns, and row reductions are two warp
// shuffles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DtypeCode { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2, DT_I8 = 3 };

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // queries per block
constexpr int BKV = 32;       // keys per inner step
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int PER = BKV / 4;  // scores per thread per key tile

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float conv(float x) { return x; }
__device__ __forceinline__ float conv(__half x) { return __half2float(x); }
__device__ __forceinline__ float conv(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float conv(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// Toward zero, as a float-to-int cast; the output is a convex combination
// of int8 values, and the clamp keeps a rounding past the ends in range.
template <> __device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return static_cast<int8_t>(fminf(fmaxf(x, -128.f), 127.f));
}

// rows x D tile from a (rows, D) slab with row stride `stride` into
// shared memory with row pitch `pitch`; rows at or past `valid` are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* src, long long stride,
                                          int rows, int valid, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  for (int q = threadIdx.x; q < rows * D / VEC; q += THREADS) {
    const int r = q / (D / VEC);
    const int c = (q % (D / VEC)) * VEC;
    float* d = dst + r * pitch + c;
    if (r >= valid) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = 0.f;
      continue;
    }
    const T* s = src + r * stride + c;
    if (vec) {
      uint4 raw = *reinterpret_cast<const uint4*>(s);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = conv(e[v]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = conv(s[v]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int Sq, int Sk, Strides st, float sm_scale,
                       int causal, int window, float softcap, int q_start,
                       int vec) {
  extern __shared__ float smem[];
  constexpr int QP = D + 1;      // padded pitches: no bank conflicts
  constexpr int KP = D + 1;
  constexpr int PP = BKV + 1;
  float* Qs = smem;              // BQ x QP
  float* Ks = Qs + BQ * QP;      // BKV x KP
  float* Vs = Ks + BKV * KP;     // BKV x D
  float* Ps = Vs + BKV * D;      // BQ x PP

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);  // GQA: query head -> its KV head
  const int r = threadIdx.x / 4; // this thread's query row in the tile
  const int g = threadIdx.x % 4; // its quarter of the row

  const T* qg = q + b * st.qb + h * st.qh + (long long)q0 * st.qs;
  const T* kg = k + b * st.kb + hk * st.kh;
  const T* vg = v + b * st.vb + hk * st.vh;
  load_tile<T, D>(Qs, QP, qg, st.qs, BQ, Sq - q0, vec);

  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;
  const int qpos = q_start + q0 + r;

  // Key tiles that can hold an unmasked key for some row of this block.
  const int q_last = q_start + min(q0 + BQ, Sq) - 1;
  int hi = Sk;
  if (causal) hi = min(hi, q_last + 1);
  int lo = 0;
  if (window > 0) lo = max(0, q_start + q0 - window + 1);

  for (int kv0 = (lo / BKV) * BKV; kv0 < hi; kv0 += BKV) {
    load_tile<T, D>(Ks, KP, kg + kv0 * st.ks, st.ks, BKV, Sk - kv0, vec);
    load_tile<T, D>(Vs, D, vg + kv0 * st.vs, st.vs, BKV, Sk - kv0, vec);
    __syncthreads();

    float s[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * QP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < PER; ++i) s[i] += qd * Ks[(g + 4 * i) * KP + d];
    }

    bool ok[PER];
    float mloc = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int kpos = kv0 + g + 4 * i;
      float x = s[i] * sm_scale;
      if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
      bool valid = kpos < Sk;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && (qpos - kpos) < window;
      s[i] = x;
      ok[i] = valid;
      if (valid) mloc = fmaxf(mloc, x);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m_run, mloc);

    float psum = 0.f;
    float* prow = Ps + r * PP;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float p = ok[i] ? expf(s[i] - m_new) : 0.f;
      prow[g + 4 * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncthreads();   // the whole P row is in shared memory

#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < BKV; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * D + g;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] += p * vrow[4 * j];
    }
    __syncthreads();   // K, V and P tiles are free for the next step
  }

  const int row = q0 + r;
  if (row < Sq) {
    const float l = (l_run == 0.f) ? 1.f : l_run;   // fully masked -> 0
    T* orow = o + b * st.ob + h * st.oh + (long long)row * st.os + g;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[4 * j] = from_f<T>(acc[j] / l);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D +
                          BQ * (BKV + 1));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, const Strides& st, float sm_scale,
           int causal, int window, float softcap, int q_start, int vec,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, st,
      sm_scale, causal, window, softcap, q_start, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int Hkv, int Sq, int Sk, const Strides& st,
               float sm_scale, int causal, int window, float softcap,
               int q_start, int vec, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                  sm_scale, causal, window, softcap,
                                  q_start, vec, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                  sm_scale, causal, window, softcap,
                                  q_start, vec, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                    sm_scale, causal, window, softcap,
                                    q_start, vec, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                    sm_scale, causal, window, softcap,
                                    q_start, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, Hkv, Sk, D), o like q; each with unit stride
// along D and the element strides in `strides` (q b/h/s, k b/h/s,
// v b/h/s, o b/h/s).  D is 32, 64, 128 or 256 (RecurrentGemma's
// heads; 140 KB of dynamic shared memory a block).  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int flash_attention_launch(
    int dtype_code, int D, const void* q, const void* k, const void* v,
    void* o, int B, int H, int Hkv, int Sq, int Sk,
    const long long* strides, float sm_scale, int causal, int window,
    float softcap, int q_start, int vec, void* stream) {
  Strides st = {strides[0], strides[1], strides[2],  strides[3],
                strides[4], strides[5], strides[6],  strides[7],
                strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (dtype_code) {
    case DT_F32:
      return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                               sm_scale, causal, window, softcap, q_start,
                               vec, s);
    case DT_F16:
      return dispatch_d<__half>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                sm_scale, causal, window, softcap, q_start,
                                vec, s);
    case DT_BF16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                       sm_scale, causal, window, softcap,
                                       q_start, vec, s);
    case DT_I8:
      return dispatch_d<int8_t>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                sm_scale, causal, window, softcap, q_start,
                                vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
