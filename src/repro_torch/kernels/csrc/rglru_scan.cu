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
// does about it:
// - Fill the card: a block owns 32 consecutive channels of one batch row
//   (one 128-byte line a time step), so that shape runs 80 x 4 = 320
//   blocks, all resident at once on every SM.
// - Keep loads in flight, off the chain: the time axis goes in chunks of
//   CHUNK steps.  While warp 0 runs the chain over chunk k, the other
//   warps (the loaders) load log_a and x of chunk k + 1, STEPS coalesced
//   rows each, all issued before any is used, and write a = exp(la) and
//   g = sqrt(-expm1(2 la)) x, which do not depend on the state, into a
//   double-buffered ring in shared memory.  One __syncthreads ends a
//   chunk.  The chain reads a and g from the ring, keeps the state in a
//   register and stores each h_t as it is produced (one 128-byte store a
//   step).
//
// Bit-identical to the plain version: each channel's chain stays in one
// thread, in time order.  beta is sqrt(-expm1(2 la)), never
// sqrt(1 - a^2), which loses every digit near a = 1; no fast math, and
// the products and the sum are rounded one by one (no fused
// multiply-add), as the plain version's separate tensor ops round them.
// A time split or an associative scan would round otherwise.

#include <cuda_runtime.h>

namespace {

// 8 warps of 8 rows each (a chunk of 56 steps, a 28 KB ring) ran fastest
// at (4, 221, 2560) of the splits probed, 2-16 loaders of 4-16 rows.
constexpr int LANES = 32;                    // channels a block owns
constexpr int WARPS = 8;                     // warp 0 chains, the rest load
constexpr int STEPS = 8;                     // rows a loader takes a chunk
constexpr int CHUNK = (WARPS - 1) * STEPS;   // time steps a chunk
constexpr int THREADS = WARPS * 32;
// the ring: two buffers of a chunk's a and g
constexpr int RING_FLOATS = 2 * 2 * CHUNK * LANES;
static_assert(WARPS >= 2 && STEPS >= 1, "one chain warp and a loader");
static_assert(RING_FLOATS * 4 <= 48 * 1024, "the ring fits 48 KB");

// Loader warp `loader` (0-based) of the block: chunk k's a and g for
// this lane's channel into buffer k % 2.
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ log_a, const float* __restrict__ x,
    float* ring, long long col, int k, int T, int C, bool live, int loader,
    int lane) {
  float* ra = ring + (k & 1) * 2 * CHUNK * LANES;
  float* rg = ra + CHUNK * LANES;
  float la[STEPS], xv[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int t = k * CHUNK + loader + s * (WARPS - 1);
    la[s] = 0.f;
    xv[s] = 0.f;
    if (live && t < T) {
      const long long i = col + (long long)t * C;
      la[s] = log_a[i];
      xv[s] = x[i];
    }
  }
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int j = (loader + s * (WARPS - 1)) * LANES + lane;
    ra[j] = expf(la[s]);
    rg[j] = __fmul_rn(sqrtf(-expm1f(2.f * la[s])), xv[s]);
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ x, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_last, int T,
                  int C) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * LANES + lane;
  const int b = blockIdx.y;
  const bool live = c < C;                   // ragged C: masked, not gone
  const long long row = (long long)b * C + c;
  const long long col = (long long)b * T * C + c;
  const int chunks = (T + CHUNK - 1) / CHUNK;

  float state = 0.f;
  if (warp == 0 && live && h0 != nullptr) state = h0[row];
  if (warp > 0)
    load_chunk(log_a, x, smem, col, 0, T, C, live, warp - 1, lane);
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    if (warp == 0) {
      const float* ra = smem + (k & 1) * 2 * CHUNK * LANES;
      const float* rg = ra + CHUNK * LANES;
      const int n = min(CHUNK, T - k * CHUNK);
      long long i = col + (long long)k * CHUNK * C;
#pragma unroll 8
      for (int j = 0; j < n; ++j, i += C) {
        state = __fadd_rn(__fmul_rn(ra[j * LANES + lane], state),
                          rg[j * LANES + lane]);
        if (live) h[i] = state;
      }
    } else if (k + 1 < chunks) {
      load_chunk(log_a, x, smem, col, k + 1, T, C, live, warp - 1, lane);
    }
    __syncthreads();
  }
  if (warp == 0 && live && h_last != nullptr) h_last[row] = state;
}

}  // namespace

// log_a, x, h (B, T, C) contiguous float32; h0 and h_last (B, C) float32
// or null.  Returns the CUDA error code of the launch (0 = success).
extern "C" int rglru_scan_launch(const void* log_a, const void* x,
                                 const void* h0, void* h, void* h_last,
                                 int B, int T, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  dim3 grid((C + LANES - 1) / LANES, B);
  rglru_scan_kernel<<<grid, THREADS, RING_FLOATS * sizeof(float), s>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), T, C);
  return static_cast<int>(cudaGetLastError());
}
