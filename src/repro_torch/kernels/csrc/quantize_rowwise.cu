// Per-row absmax int8 quantisation for Hopper (sm_90a):
//   scale[r] = absmax(x[r]) / 127 (1 where the absmax is 0),
//   q[r, k]  = clamp(round_half_even(x[r, k] / scale[r]), -127, 127).
//
// Replaces the TPU kernel src/repro/kernels/quant/quant.py
// (quantize_rowwise_kernel, wrapped by kernels/quant/ops.py::
// quantize_rowwise): the activation prologue of the W8A8 layer.
//
// What bounds it on an H100: bytes.  It reads x once and writes one int8
// per element, with three operations per element, so (884, 4096) in fp32
// moves 18 MB, 5.4 us at 3.35 TB/s.  What the design does about it, in
// two paths chosen at launch:
// - the register path, for rows that fit in registers (at most
//   PER_THREAD elements a thread, blocks of up to MAX_THREADS threads)
//   and start on 16-byte boundaries: a row's threads read it from device
//   memory once, with 16-byte vector loads (consecutive threads on
//   consecutive vectors), and keep it in registers; the absmax is reduced
//   in registers, then across each warp with shuffles and across the row
//   through shared memory; the quotients come from the registers and go
//   out packed, 4 int8 a store for fp32 and 8 for 16-bit inputs.  One
//   block a row, of as many whole warps as the row needs.
// - the loop path, for every other row (a ragged or longer K, an
//   unaligned base): one block per row; consecutive threads read
//   consecutive elements, once for the absmax and again, from L1/L2, for
//   the quotient.
//
// Bit-exact against the plain version (and the TPU kernel) on both
// paths: a maximum is exact in any order; the scale and the quotient use
// IEEE division (never a multiplication by a reciprocal, and no
// --use_fast_math); rintf rounds half to even, as jnp.round and
// torch.round do.  A NaN in a row is not propagated into its scale
// (fmaxf drops it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum InCode { IN_F32 = 0, IN_F16 = 1, IN_BF16 = 2 };

constexpr int THREADS = 256;        // the loop path's block
// The register path's largest block: with two blocks an SM it leaves a
// thread 40 registers, enough to hold 16 elements without spilling, and
// 768 threads cover yi-6b's 11,008-wide rows.
constexpr int MAX_THREADS = 768;
constexpr int PER_THREAD = 16;      // elements a thread holds in registers

__device__ __forceinline__ float conv(float x) { return x; }
__device__ __forceinline__ float conv(__half x) { return __half2float(x); }
__device__ __forceinline__ float conv(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Vector i (16 bytes) of a row, as floats: fp32 as one float4, 16-bit
// types as one uint4 of eight.
__device__ __forceinline__ void load_vec(const float* row, int i,
                                         float (&f)[4]) {
  const float4 v = reinterpret_cast<const float4*>(row)[i];
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* row, int i,
                                         float (&f)[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = conv(e[k]);
}

__device__ __forceinline__ float quantized(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// The max of every thread's m over the block (one row): across each warp
// with shuffles, then across the warps through shared memory.
__device__ __forceinline__ float row_max(float m, float* warp_max) {
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  float absmax = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w)
    absmax = fmaxf(absmax, warp_max[w]);
  return absmax;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_rowwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int K) {
  __shared__ float warp_max[THREADS / 32];
  const size_t base = (size_t)blockIdx.x * K;
  const int tid = threadIdx.x;

  float m = 0.f;
  for (int k = tid; k < K; k += THREADS)
    m = fmaxf(m, fabsf(conv(x[base + k])));
  const float absmax = row_max(m, warp_max);
  const float s = absmax == 0.f ? 1.f : absmax / 127.f;

  for (int k = tid; k < K; k += THREADS)
    q[base + k] = static_cast<int8_t>(quantized(conv(x[base + k]), s));
  if (tid == 0) scale[blockIdx.x] = s;
}

// The register path: the block's threads on the row's 16-byte vectors,
// thread tid on vectors tid, tid + blockDim.x, ...
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
quantize_rowwise_regs_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                             float* __restrict__ scale, int K) {
  constexpr int V = 16 / sizeof(T);       // elements a vector
  constexpr int NV = PER_THREAD / V;      // vectors a thread
  __shared__ float warp_max[MAX_THREADS / 32];
  const int tid = threadIdx.x, nvec = K / V;
  const T* xr = x + (size_t)blockIdx.x * K;

  float v[NV][V] = {};
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = tid + j * blockDim.x;
    if (i < nvec) load_vec(xr, i, v[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(v[j][k]));
  }
  const float absmax = row_max(m, warp_max);
  const float s = absmax == 0.f ? 1.f : absmax / 127.f;

  int8_t* qr = q + (size_t)blockIdx.x * K;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = tid + j * blockDim.x;
    if (i >= nvec) continue;
    unsigned w[V / 4] = {};
#pragma unroll
    for (int k = 0; k < V; ++k)
      w[k / 4] |= (static_cast<unsigned>(static_cast<int>(
                       quantized(v[j][k], s))) & 0xffu) << (8 * (k % 4));
    if constexpr (V == 4) {
      reinterpret_cast<unsigned*>(qr)[i] = w[0];
    } else {
      reinterpret_cast<uint2*>(qr)[i] = uint2{w[0], w[1]};
    }
  }
  if (tid == 0) scale[blockIdx.x] = s;
}

template <typename T>
void launch(const void* x, int8_t* q, float* scale, int M, int K,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (aligned && K > 0 && K % V == 0 && K <= PER_THREAD * MAX_THREADS) {
    const int per_thread = PER_THREAD / V;
    const int warps = ((K / V + per_thread - 1) / per_thread + 31) / 32;
    quantize_rowwise_regs_kernel<T><<<M, warps * 32, 0, stream>>>(
        static_cast<const T*>(x), q, scale, K);
  } else {
    quantize_rowwise_kernel<T><<<M, THREADS, 0, stream>>>(
        static_cast<const T*>(x), q, scale, K);
  }
}

}  // namespace

// x (M, K) row-major float32/float16/bfloat16; q (M, K) int8; scale (M,)
// float32.  Returns the CUDA error code of the launch (0 = success).
extern "C" int quantize_rowwise_launch(int in_code, const void* x, void* q,
                                       void* scale, int M, int K,
                                       void* stream) {
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  switch (in_code) {
    case IN_F32: launch<float>(x, qo, so, M, K, s); break;
    case IN_F16: launch<__half>(x, qo, so, M, K, s); break;
    case IN_BF16: launch<__nv_bfloat16>(x, qo, so, M, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
