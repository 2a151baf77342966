// Chunked RWKV-6 (Finch) WKV for Hopper (sm_90a).  Per (batch, head),
// with state S (C x C, S[c_k][c_v]) and log decay lw <= 0:
//
//   o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//
// computed a chunk of L tokens at a time: with la the inclusive prefix sum
// of lw over the chunk and la_prev = la - lw,
//
//   o   = (r * exp(la_prev)) @ S  +  P @ V  +  ((r * u) . k) v,
//   P[t][s] = sum_c r[t][c] k[s][c] exp(la_prev[t][c] - la[s][c]),  s < t,
//   S  <- diag(exp(la_L)) S  +  (k * exp(la_L - la))^T V.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py (rwkv6_kernel,
// wrapped by kernels/rwkv6/ops.py::rwkv6_scan), with an initial state and
// the final state besides, as repro/models/rwkv6.py::rwkv6_chunked_jnp.
//
// What bounds it on an H100: at RWKV-6-7B's prefill shape (4 x 64 heads,
// 221 tokens, C = 64, bf16) it moves about 43 MB (r, k, v, o in bf16, lw
// in fp32, the fp32 states) and does about 2 GFLOP, a third of it the
// pairwise exponentials of P; per byte that is under the card's balance,
// so bytes bound it in principle, but this SIMT version runs its
// products on the fp32 pipes and its exponentials on the special-function
// units, far from either bound.  What the design does:
//   * one block per (batch, head) keeps the fp32 state in shared memory
//     for the whole sequence and walks the chunks in order: that loop is
//     the TPU's sequential grid axis, and the state never goes to device
//     memory between chunks;
//   * each chunk's r, k, v, lw tiles are read once (coalesced, converted
//     to fp32), and every intermediate (la, la_prev, P, the scaled q and
//     k) lives in shared memory;
//   * the pairwise difference stays inside one exp: lw reaches -exp(6)
//     per token, so over a 64-token chunk la reaches about -25,800, and a
//     factorised exp(la_prev) * exp(-la) would overflow to inf * 0 = NaN;
//   * the inter-chunk product reads the state before the update, with a
//     barrier between them;
//   * the ragged last chunk is masked here: its missing rows read as
//     r = k = v = 0 and lw = 0, which leave the state as the reference's
//     padding leaves it;
//   * la is a sequential prefix sum per channel, in the order the plain
//     version's cumulative sum adds, so the exponents agree bit for bit.
// Tensor-core products and a two-level (GLA-style) split of the chunk
// are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DtypeCode { DT_F32 = 0, DT_F16 = 1, DT_BF16 = 2 };

constexpr int THREADS = 256;

__device__ __forceinline__ float conv(float x) { return x; }
__device__ __forceinline__ float conv(__half x) { return __half2float(x); }
__device__ __forceinline__ float conv(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Floats of shared memory for chunk L and head size C.
inline int smem_floats(int L, int C) {
  return 6 * L * (C + 1) + C * (C + 1) + L * (L + 1) + L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ o, float* __restrict__ s_out, int H,
                 int T_len, int C, int L) {
  extern __shared__ float smem[];
  const int CP = C + 1;          // padded pitch: no bank conflicts
  const int PP = L + 1;
  float* R = smem;               // r, then r * exp(la_prev)       L x CP
  float* K = R + L * CP;         // k, then k * exp(la_L - la)     L x CP
  float* V = K + L * CP;         // v                              L x CP
  float* LW = V + L * CP;        // lw                             L x CP
  float* LP = LW + L * CP;       // la_prev = la - lw              L x CP
  float* LA = LP + L * CP;       // la, inclusive prefix sum       L x CP
  float* S = LA + L * CP;        // state                          C x CP
  float* P = S + C * CP;         // intra-chunk scores             L x PP
  float* BON = P + L * PP;       // (r * u) . k per row            L

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const float* ug = u + (bh % H) * C;
  const long long base = (long long)bh * T_len * C;
  const long long sbase = (long long)bh * C * C;

  for (int e = tid; e < C * C; e += THREADS)
    S[(e / C) * CP + e % C] = s0 != nullptr ? s0[sbase + e] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += L) {
    const int valid = min(L, T_len - t0);
    __syncthreads();   // the last chunk's readers of the tiles are done
    for (int e = tid; e < L * C; e += THREADS) {
      const int t = e / C, c = e % C, i = t * CP + c;
      if (t < valid) {
        const long long g = base + (long long)(t0 + t) * C + c;
        R[i] = conv(r[g]);
        K[i] = conv(k[g]);
        V[i] = conv(v[g]);
        LW[i] = lw[g];
      } else {
        R[i] = K[i] = V[i] = LW[i] = 0.f;
      }
    }
    __syncthreads();

    for (int c = tid; c < C; c += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += LW[t * CP + c];
        LA[t * CP + c] = acc;
        LP[t * CP + c] = acc - LW[t * CP + c];
      }
    }
    for (int t = tid; t < L; t += THREADS) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc += R[t * CP + c] * ug[c] * K[t * CP + c];
      BON[t] = acc;
    }
    __syncthreads();

    for (int e = tid; e < L * L; e += THREADS) {
      const int t = e / L, s = e % L;
      float acc = 0.f;
      if (s < t) {
        const float* rt = R + t * CP;
        const float* ks = K + s * CP;
        const float* lp = LP + t * CP;
        const float* la = LA + s * CP;
        for (int c = 0; c < C; ++c)
          acc += rt[c] * ks[c] * expf(lp[c] - la[c]);
      }
      P[t * PP + s] = acc;
    }
    __syncthreads();

    const float* la_last = LA + (L - 1) * CP;
    for (int e = tid; e < L * C; e += THREADS) {
      const int t = e / C, c = e % C, i = t * CP + c;
      R[i] *= expf(LP[i]);
      K[i] *= expf(la_last[c] - LA[i]);
    }
    __syncthreads();

    for (int e = tid; e < valid * C; e += THREADS) {
      const int t = e / C, d = e % C;
      const float* q = R + t * CP;
      float inter = 0.f;
      for (int c = 0; c < C; ++c) inter += q[c] * S[c * CP + d];
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += P[t * PP + s] * V[s * CP + d];
      o[base + (long long)(t0 + t) * C + d] =
          from_f<T>(inter + intra + BON[t] * V[t * CP + d]);
    }
    __syncthreads();   // the state is read above and written below

    for (int e = tid; e < C * C; e += THREADS) {
      const int i = e / C, j = e % C;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc += K[s * CP + i] * V[s * CP + j];
      S[i * CP + j] = expf(la_last[i]) * S[i * CP + j] + acc;
    }
  }
  __syncthreads();
  if (s_out != nullptr)
    for (int e = tid; e < C * C; e += THREADS)
      s_out[sbase + e] = S[(e / C) * CP + e % C];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, void* o, float* s_out, int B,
           int H, int T_len, int C, int L, cudaStream_t stream) {
  auto kernel = rwkv6_wkv_kernel<T>;
  const int smem = (int)sizeof(float) * smem_floats(L, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, s0, static_cast<T*>(o), s_out, H,
      T_len, C, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, o (B, H, T, C) contiguous in one dtype (float32, float16 or
// bfloat16); lw (B, H, T, C) and u (H, C) float32; s0 and s_out
// (B, H, C, C) float32 or null (a zero initial state; no final state).
// C <= 64 and L in {32, 64}.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int rwkv6_wkv_launch(int dtype_code, const void* r, const void* k,
                                const void* v, const void* lw, const void* u,
                                const void* s0, void* o, void* s_out, int B,
                                int H, int T_len, int C, int L,
                                void* stream) {
  const float* lwf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error so the check below is ours
  if (C < 1 || C > 64 || (L != 32 && L != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype_code) {
    case DT_F32:
      return launch<float>(r, k, v, lwf, uf, s0f, o, sof, B, H, T_len, C, L,
                           s);
    case DT_F16:
      return launch<__half>(r, k, v, lwf, uf, s0f, o, sof, B, H, T_len, C, L,
                            s);
    case DT_BF16:
      return launch<__nv_bfloat16>(r, k, v, lwf, uf, s0f, o, sof, B, H, T_len,
                                   C, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
