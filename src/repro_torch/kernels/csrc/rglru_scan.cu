// RG-LRU scan for Hopper (sm_90a):
//   h_t = exp(la_t) * h_{t-1} + sqrt(-expm1(2 la_t)) * x_t,
// channels independent, time sequential, from h0 (zeros if none), with
// the final state h_T written out on request.
//
// Replaces the TPU kernel src/repro/kernels/rglru/rglru.py (rglru_kernel,
// wrapped by kernels/rglru/ops.py::rglru_scan), which is the zero-state
// case; this kernel computes the whole of rglru_ref's function, so the
// stateful prefill pass runs it too.
//
// What bounds it on an H100: bytes.  It reads log_a and x and writes h,
// 12 bytes per element with about ten operations per element (an exp, an
// expm1, a sqrt and two multiply-adds), so RecurrentGemma's prefill
// shape (4, 221, 2560) moves 27 MB, 8 us at 3.35 TB/s.  What the design
// does about it: one thread per (batch, channel) walks the time axis with
// its state in a register; consecutive threads hold consecutive channels,
// so every step's loads and store are coalesced.  That is B * C threads
// (10,240 at that shape), too few to fill 132 SMs with loads in flight;
// an associative-scan form or a split of the time axis is later work.
//
// beta is sqrt(-expm1(2 la)), never sqrt(1 - a^2), which loses every
// digit near a = 1; no fast math, and the products and the sum are
// rounded one by one (no fused multiply-add), as the plain version's
// separate tensor ops round them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ x, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_last, int T,
                  int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const long long row = (long long)b * C + c;
  float state = h0 != nullptr ? h0[row] : 0.f;
  long long i = (long long)b * T * C + c;
  for (int t = 0; t < T; ++t, i += C) {
    const float la = log_a[i];
    const float gated = __fmul_rn(sqrtf(-expm1f(2.f * la)), x[i]);
    state = __fadd_rn(__fmul_rn(expf(la), state), gated);
    h[i] = state;
  }
  if (h_last != nullptr) h_last[row] = state;
}

}  // namespace

// log_a, x, h (B, T, C) contiguous float32; h0 and h_last (B, C) float32
// or null.  Returns the CUDA error code of the launch (0 = success).
extern "C" int rglru_scan_launch(const void* log_a, const void* x,
                                 const void* h0, void* h, void* h_last,
                                 int B, int T, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), T, C);
  return static_cast<int>(cudaGetLastError());
}
