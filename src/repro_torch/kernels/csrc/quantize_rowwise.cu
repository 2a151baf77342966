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
// moves 18 MB, 5.4 us at 3.35 TB/s.  What the design does about it: one
// block per row; consecutive threads read consecutive elements
// (coalesced); the absmax is reduced in registers, then across the warp
// with shuffles and across the block through shared memory, so x is read
// from device memory once and its second read (for the division) comes
// from L1/L2, which hold the row.
//
// Bit-exact against the plain version (and the TPU kernel): a maximum is
// exact in any order; the scale and the quotient use IEEE division
// (never a multiplication by a reciprocal, and no --use_fast_math);
// rintf rounds half to even, as jnp.round and torch.round do.  A NaN in
// a row is not propagated into its scale (fmaxf drops it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum InCode { IN_F32 = 0, IN_F16 = 1, IN_BF16 = 2 };

constexpr int THREADS = 256;

__device__ __forceinline__ float conv(float x) { return x; }
__device__ __forceinline__ float conv(__half x) { return __half2float(x); }
__device__ __forceinline__ float conv(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tid % 32 == 0) warp_max[tid / 32] = m;
  __syncthreads();
  float absmax = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) absmax = fmaxf(absmax, warp_max[w]);
  const float s = absmax == 0.f ? 1.f : absmax / 127.f;

  for (int k = tid; k < K; k += THREADS) {
    const float r = rintf(conv(x[base + k]) / s);
    q[base + k] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (tid == 0) scale[blockIdx.x] = s;
}

template <typename T>
void launch(const void* x, int8_t* q, float* scale, int M, int K,
            cudaStream_t stream) {
  quantize_rowwise_kernel<T><<<M, THREADS, 0, stream>>>(
      static_cast<const T*>(x), q, scale, K);
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
