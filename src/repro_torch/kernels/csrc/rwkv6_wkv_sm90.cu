// Chunked RWKV-6 (Finch) WKV on Hopper's tensor cores (sm_90a), for bf16
// and fp16 r, k, v at head size C = 64: K6's tensor-core tile.  Per
// (batch, head), with state S (C x C, S[c_k][c_v]) and log decay lw <= 0:
//
//   o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py:32
// (rwkv6_kernel; its pallas_call in kernels/rwkv6/ops.py:40) on the
// port's prefill path, with an initial and a final state besides.  The
// wrapper's rule (kernels/rwkv6/rwkv6.py::select_tile) sends it every
// bf16/fp16 call at C = 64 and chunk 32 or 64 whose pointers and strides
// allow 16-byte loads; rwkv6_wkv.cu (SIMT) serves the rest.  Card-only:
// mma.sync has no CPU stand-in, so the emulated tests leave it out.
// kernels/rwkv6/rwkv6.py::rwkv6_chunked_tc is this file's arithmetic in
// plain tensor ops.
//
// One chunk of L tokens, with LA[0] = 0 and LA[t + 1] = la[t], la the
// inclusive prefix sum of lw over the chunk (so LA[t] is la_prev[t]):
//
//   o   = (r * exp(LA[t])) @ S  +  P @ V  +  ((r * u) . k) v
//   P[t][s] = sum_c r[t][c] k[s][c] exp(LA[t][c] - LA[s + 1][c]),  s < t
//   S  <- diag(exp(LA[L])) S  +  (k * exp(LA[L] - LA[s + 1]))^T V
//
// What bounds it on an H100: at RWKV-6-7B's prefill shape (4 x 64 heads,
// 221 tokens, bf16) a call moves about 52 MB (r, k, v, o in bf16, lw in
// fp32, the fp32 states) in 15.5 us at 3.35 TB/s; its products are about
// 1.1 GFLOP (about 1 us on the tensor cores) and its exponentials and
// scalings about 0.3 GFLOP on the fp32 pipes, of which the exponentials
// go through the special-function units (16 a clock an SM).  So bytes
// bound it, and the exponentials are what a block spends its time on.
// What the design does:
//   * the prefix sums are warp-level scans (shuffles) in registers: lw is
//     loaded so that lane l holds token l of each 32-token segment for
//     the warp's 64 / warps channels, the channels' shuffles interleave,
//     and la goes to shared memory once, in log2 units, so each decay
//     factor is one ex2;
//   * the chunk is cut into sub-chunks of 16 tokens (GLA's two-level
//     split).  Off the diagonal (sub-chunk i against j < i) the decay
//     is split at ref_i = LA[16 i], the la of the last token before
//     sub-chunk i:
//       exp(LA[t] - LA[s + 1]) = exp(LA[t] - ref_i) * exp(ref_i - LA[s + 1])
//     and P's block is a tensor-core product of r_i * exp(LA[t] - ref_i)
//     and k_j * exp(ref_i - LA[s + 1]), both rounded to the input dtype.
//     la does not increase, so both exponents are <= 0: neither factor
//     overflows, and a factor that underflows to 0 does so only where
//     the true product, no larger than either factor, is 0 in fp32.
//     (A split at the chunk's start, exp(LA[t]) * exp(-LA[s + 1]), gives
//     inf * 0 at lw = -e^6, where la reaches -25,800 over 64 tokens.)
//     On the diagonal (s < t within one sub-chunk) the pairwise exp stays
//     explicit, in fp32;
//   * P, rounded to the input dtype as K2's tile rounds its P, meets V on
//     the tensor cores (mma.sync m16n8k16, fp32 accumulators; V's
//     fragments by ldmatrix.trans from row-major V);
//   * the inter-chunk term is a tensor-core product in bf16 whatever the
//     input dtype (the state has no bound, and fp16 ends at 65504), with
//     both operands split into hi + lo (three products: hi hi, hi lo,
//     lo hi), so its error is about 2^-16 of each term: at lw = -e^6 a
//     row's output is (r_t . k_{t-1}) v_{t-1}, and a single rounding of
//     r and S would lose that scalar to cancellation;
//   * the bonus ((r * u) . k) v is fp32;
//   * the state is fp32 in registers (the accumulators of the update's
//     product) across the whole sequence.  Its update multiplies
//     k^ = k * exp(LA[L] - LA[s + 1]), split into hi + lo in the input
//     dtype, by V, which that dtype holds exactly: two products whose
//     sum is within about 2^-16 of k^ V, where one rounding of k^ (2^-9
//     in bf16) would miss the state's 1e-4.  The update writes the next
//     of two state buffers, so it follows the output without a barrier;
//   * a block owns one (batch, head) and walks its chunks in order; two
//     warps share each 16-row block of the chunk (half the diagonal's
//     pairs and 8 of each 16 columns of the blocks left of it; then 32 of
//     o's 64 columns), and warp w updates state rows 16 (w % 4) ..
//     16 (w % 4) + 15 in its columns.  At the served shape that is 256
//     blocks of 8 warps, two blocks an SM (92 KB of shared memory each):
//     the chain of one chunk (load, scan, P, o, state) is latency-bound,
//     and the warps of the two blocks hide each other's waits;
//   * the next chunk's r, k, v and lw are loaded into registers while
//     this chunk computes;
//   * r, k, v and lw are read through the caller's strides with 16-byte
//     loads, so the models' (B, T, H, C) memory seen as (B, H, T, C)
//     needs no copy, and o is written through strides too; rows past T
//     read as r = k = v = 0, lw = 0, which leaves the state as the
//     reference's padding does, and are not written.
// Not taken: slicing a head's value columns over 2 or 4 blocks, each
// recomputing P (more blocks for the card, o[:, d] and S[:, d] need only
// V[:, d]), ran slower on an H100 than one block a head: the block's
// time goes to the exponentials and shared-memory reads of P, which each
// slice repeats; the block keeps the whole head and adds warps instead.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DtypeCode { DT_F16 = 1, DT_BF16 = 2 };

constexpr int C = 64;            // head size
constexpr int SUB = 16;          // sub-chunk: one mma row block
constexpr int RP = C + 8;        // pitch (elements) of R, K and the state
constexpr int LAP = C + 4;       // pitch (floats) of LA
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// One 16 x 8 x 16 product on the tensor cores: d += a b, fp32 accumulate.
template <typename T>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, bf16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Two values rounded to T, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t u;
  if constexpr (std::is_same<T, bf16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    u = *reinterpret_cast<uint32_t*>(&v);
  }
  return u;
}

// x0, x1 as hi + lo, each a pair of T.
template <typename T>
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const T h0 = from_f<T>(x0), h1 = from_f<T>(x1);
  hi = pack<T>(to_f(h0), to_f(h1));
  lo = pack<T>(x0 - to_f(h0), x1 - to_f(h1));
}

// Two adjacent values (p even) as floats, in one 32-bit load.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else
    return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;
  const float* s0;       // (B, H, C, C) or null: a zero initial state
  void* o;
  float* s_out;          // (B, H, C, C)
  long long st[5][3];    // r, k, v, lw, o: element strides along B, H, T
  int H, T;
};

// B fragments of two 8-column tiles (columns d, d + 8) of rows
// s .. s + 15 of a row-major 16-bit matrix, transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* b, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

template <int L> struct Shape {
  static constexpr int NB = L / SUB;         // 16-row blocks of a chunk
  static constexpr int WARPS = 2 * NB;       // two warps a row block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NH = 8 / WARPS;       // state column halves a warp
  static constexpr int PP = L + 8;           // pitch of P
  // 16-byte pieces of r, k and v a thread loads a chunk
  static constexpr int NX = L * C / 8 / THREADS;
  static constexpr int BYTES = 2 * (3 * L * RP + L * PP + 4 * C * RP)
                               + 4 * ((L + 1) * LAP + C);
};

template <typename T, int L>
__global__ void __launch_bounds__(Shape<L>::THREADS, 2)
rwkv6_wkv_tc_kernel(const WkvArgs a) {
  using Sh = Shape<L>;
  constexpr int WARPS = Sh::WARPS, THREADS = Sh::THREADS, NB = Sh::NB;
  constexpr int NH = Sh::NH, PP = Sh::PP, NX = Sh::NX;
  constexpr int TPL = L / 32, CPW = C / WARPS;  // the scan's tokens, channels
  extern __shared__ __align__(16) unsigned char smem[];
  T* R = reinterpret_cast<T*>(smem);           // r                 L x RP
  T* K = R + L * RP;                           // k                 L x RP
  T* V = K + L * RP;                           // v                 L x RP
  T* P = V + L * RP;                           // intra scores      L x PP
  bf16* SHI = reinterpret_cast<bf16*>(P + L * PP);  // S^T hi, 2 x  C x RP
  bf16* SLO = SHI + 2 * C * RP;                // S^T lo, two buffers
  float* LA = reinterpret_cast<float*>(SLO + 2 * C * RP);  // (L+1) x LAP
  float* U = LA + (L + 1) * LAP;               // u                 C

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const T* rg = static_cast<const T*>(a.r) + b * a.st[0][0] + h * a.st[0][1];
  const T* kg = static_cast<const T*>(a.k) + b * a.st[1][0] + h * a.st[1][1];
  const T* vg = static_cast<const T*>(a.v) + b * a.st[2][0] + h * a.st[2][1];
  const float* lwg = a.lw + b * a.st[3][0] + h * a.st[3][1];
  T* og = static_cast<T*>(a.o) + b * a.st[4][0] + h * a.st[4][1];
  const long long sr = a.st[0][2], sk = a.st[1][2], sv = a.st[2][2];
  const long long sl = a.st[3][2], so = a.st[4][2];
  const long long sbase = (long long)bh * C * C;

  // The next chunk's r, k, v and lw, loaded into registers while this
  // chunk computes; rows past T read as 0.  Lane l holds lw of tokens
  // l + 32 i for the warp's CPW channels, the layout the scan wants.
  uint4 xr[NX], xk[NX], xv[NX];
  float4 xl[TPL][CPW / 4];
  auto prefetch = [&](int t0) {
    const int valid = min(L, a.T - t0);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * THREADS, t = e / (C / 8), c = (e % (C / 8)) * 8;
      xr[i] = xk[i] = xv[i] = make_uint4(0, 0, 0, 0);
      if (t < valid) {
        const long long tt = t0 + t;
        xr[i] = __ldg(reinterpret_cast<const uint4*>(rg + tt * sr + c));
        xk[i] = __ldg(reinterpret_cast<const uint4*>(kg + tt * sk + c));
        xv[i] = __ldg(reinterpret_cast<const uint4*>(vg + tt * sv + c));
      }
    }
#pragma unroll
    for (int i = 0; i < TPL; ++i)
#pragma unroll
      for (int j = 0; j < CPW / 4; ++j) {
        const int t = lane + 32 * i, c = warp * CPW + 4 * j;
        xl[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < valid)
          xl[i][j] = __ldg(
              reinterpret_cast<const float4*>(lwg + (t0 + t) * sl + c));
      }
  };
  prefetch(0);

  // The state in mma accumulator layout: warp w holds rows (channels)
  // 16 (w % 4) + g (+ 8) and, for each of its NH column halves nh, the
  // columns 32 nh + 8 nt + 2 tg (+ 1).
  const int m0 = SUB * (warp % 4) + g;
  float S[NH][4][4];
  for (int x = 0; x < NH; ++x)
    for (int nt = 0; nt < 4; ++nt)
      for (int q = 0; q < 4; ++q) {
        const int c = m0 + 8 * (q >> 1);
        const int d = 32 * (warp / 4 + x) + 8 * nt + 2 * tg + (q & 1);
        S[x][nt][q] = a.s0 != nullptr ? a.s0[sbase + c * C + d] : 0.f;
      }
  // S^T as hi + lo bf16, the inter-chunk product's B operand.
  auto store_state = [&](int buf) {
    bf16* hi_s = SHI + buf * C * RP;
    bf16* lo_s = SLO + buf * C * RP;
    for (int x = 0; x < NH; ++x)
      for (int nt = 0; nt < 4; ++nt)
        for (int q = 0; q < 4; ++q) {
          const int c = m0 + 8 * (q >> 1);
          const int d = 32 * (warp / 4 + x) + 8 * nt + 2 * tg + (q & 1);
          const bf16 hi = __float2bfloat16_rn(S[x][nt][q]);
          hi_s[d * RP + c] = hi;
          lo_s[d * RP + c] =
              __float2bfloat16_rn(S[x][nt][q] - __bfloat162float(hi));
        }
  };
  store_state(0);
  for (int c = tid; c < C; c += THREADS) {
    LA[c] = 0.f;
    U[c] = a.u[h * C + c];
  }

  const int rb = warp % NB, hf = warp / NB;    // row block, its half
  const int tr = SUB * rb;
  int cb = 0;                                  // the state buffer read
  for (int t0 = 0; t0 < a.T; t0 += L) {
    const int valid = min(L, a.T - t0);
    __syncthreads();   // the last chunk's readers are done
    for (int i = 0; i < NX; ++i) {
      const int e = tid + i * THREADS, t = e / (C / 8), c = (e % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(R + t * RP + c) = xr[i];
      *reinterpret_cast<uint4*>(K + t * RP + c) = xk[i];
      *reinterpret_cast<uint4*>(V + t * RP + c) = xv[i];
    }

    // ---- la: warp-level inclusive scans of lw, in log2 units ---------
    // Lane l holds token l of each 32-token segment for the warp's CPW
    // channels; the channels' shuffles interleave, and each segment adds
    // the last token's la of the one before it.
    {
      float carry[CPW] = {};
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        float y[CPW];
#pragma unroll
        for (int j = 0; j < CPW / 4; ++j) {
          y[4 * j] = xl[i][j].x;
          y[4 * j + 1] = xl[i][j].y;
          y[4 * j + 2] = xl[i][j].z;
          y[4 * j + 3] = xl[i][j].w;
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
#pragma unroll
          for (int ch = 0; ch < CPW; ++ch) {
            const float z = __shfl_up_sync(FULL, y[ch], off);
            if (lane >= off) y[ch] += z;
          }
#pragma unroll
        for (int ch = 0; ch < CPW; ++ch) {
          y[ch] += carry[ch];
          carry[ch] = __shfl_sync(FULL, y[ch], 31);
        }
#pragma unroll
        for (int j = 0; j < CPW / 4; ++j)
          *reinterpret_cast<float4*>(LA + (1 + lane + 32 * i) * LAP
                                     + warp * CPW + 4 * j) =
              make_float4(y[4 * j] * LOG2E, y[4 * j + 1] * LOG2E,
                          y[4 * j + 2] * LOG2E, y[4 * j + 3] * LOG2E);
      }
    }
    __syncthreads();
    if (t0 + L < a.T) prefetch(t0 + L);

    // ---- P, rows tr .. tr + 15; this warp's half of the work ---------
    if (tr < valid) {
      // the diagonal block: explicit pairwise decay, zeros on and above
      for (int e = hf * 128 + lane; e < hf * 128 + 128; e += 32) {
        const int tt = e / SUB, ss = e % SUB;
        if (ss >= tt) P[(tr + tt) * PP + tr + ss] = from_f<T>(0.f);
      }
      {
        constexpr int PAIRS = SUB * (SUB - 1) / 4;   // this half's pairs
        const int p0 = hf * PAIRS + lane, p1 = p0 + 32;
        const bool two = lane + 32 < PAIRS;
        int tt0 = 1, ss0 = p0, tt1 = 1, ss1 = two ? p1 : p0;
        while (ss0 >= tt0) ss0 -= tt0++;
        while (ss1 >= tt1) ss1 -= tt1++;
        const T* r0 = R + (tr + tt0) * RP;
        const T* k0 = K + (tr + ss0) * RP;
        const float* l0 = LA + (tr + tt0) * LAP;
        const float* m0p = LA + (tr + ss0 + 1) * LAP;
        const T* r1 = R + (tr + tt1) * RP;
        const T* k1 = K + (tr + ss1) * RP;
        const float* l1 = LA + (tr + tt1) * LAP;
        const float* m1p = LA + (tr + ss1 + 1) * LAP;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
        for (int c = 0; c < C; c += 2) {
          const float2 ra = load2(r0 + c), ka = load2(k0 + c);
          const float2 xa = *reinterpret_cast<const float2*>(l0 + c);
          const float2 ya = *reinterpret_cast<const float2*>(m0p + c);
          const float2 rb2 = load2(r1 + c), kb = load2(k1 + c);
          const float2 xb = *reinterpret_cast<const float2*>(l1 + c);
          const float2 yb = *reinterpret_cast<const float2*>(m1p + c);
          acc0 += ra.x * ka.x * ex2(xa.x - ya.x) + ra.y * ka.y * ex2(xa.y - ya.y);
          acc1 += rb2.x * kb.x * ex2(xb.x - yb.x)
                  + rb2.y * kb.y * ex2(xb.y - yb.y);
        }
        P[(tr + tt0) * PP + tr + ss0] = from_f<T>(acc0);
        if (two) P[(tr + tt1) * PP + tr + ss1] = from_f<T>(acc1);
      }
      // the blocks left of it, 8 of each 16 columns a half:
      // (r_i exp(LA[t] - ref)) . (k_j exp(ref - LA[s + 1])) on the tensor
      // cores, ref = LA[tr]
      if (rb > 0) {
        const float* ref = LA + tr * LAP;
        uint32_t ar[C / 16][4];
        for (int kk = 0; kk < C / 16; ++kk)
          for (int q = 0; q < 4; ++q) {
            const int t = tr + g + 8 * (q & 1);
            const int c = 16 * kk + 2 * tg + 8 * (q >> 1);
            const float2 rv = load2(R + t * RP + c);
            const float2 lt = *reinterpret_cast<const float2*>(LA + t * LAP + c);
            ar[kk][q] = pack<T>(rv.x * ex2(lt.x - ref[c]),
                                rv.y * ex2(lt.y - ref[c + 1]));
          }
        for (int j = 0; j < rb; ++j) {
          const int s = SUB * j + 8 * hf + g;
          const T* ks = K + s * RP;
          const float* ls = LA + (s + 1) * LAP;
          float acc[4] = {};
          for (int kk = 0; kk < C / 16; ++kk) {
            uint32_t bk[2];
            for (int q = 0; q < 2; ++q) {
              const int c = 16 * kk + 2 * tg + 8 * q;
              const float2 kv = load2(ks + c);
              const float2 lv = *reinterpret_cast<const float2*>(ls + c);
              bk[q] = pack<T>(kv.x * ex2(ref[c] - lv.x),
                              kv.y * ex2(ref[c + 1] - lv.y));
            }
            mma<T>(acc, ar[kk], bk[0], bk[1]);
          }
          const int col = SUB * j + 8 * hf + 2 * tg;
          *reinterpret_cast<uint32_t*>(P + (tr + g) * PP + col) =
              pack<T>(acc[0], acc[1]);
          *reinterpret_cast<uint32_t*>(P + (tr + g + 8) * PP + col) =
              pack<T>(acc[2], acc[3]);
        }
      }
    }
    __syncthreads();   // P's row blocks are whole

    // ---- o, rows tr .. tr + 15, columns 32 hf .. 32 hf + 31 -----------
    if (tr < valid) {
      const int dh = 32 * hf;
      float o[4][4] = {};
      // P @ V over the sub-chunks up to the diagonal
      for (int kk = 0; kk <= rb; ++kk) {
        uint32_t ap[4];
        for (int q = 0; q < 4; ++q)
          ap[q] = ld32(P + (tr + g + 8 * (q & 1)) * PP + 16 * kk + 2 * tg
                       + 8 * (q >> 1));
        for (int np = 0; np < 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, V + (16 * kk + (lane & 15)) * RP + dh + 16 * np
                                + 8 * (lane >> 4));
          mma<T>(o[2 * np], ap, bv[0], bv[1]);
          mma<T>(o[2 * np + 1], ap, bv[2], bv[3]);
        }
      }
      // (r * exp(LA[t])) @ S in bf16, hi + lo on both sides
      const bf16* hi_s = SHI + cb * C * RP;
      const bf16* lo_s = SLO + cb * C * RP;
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t qh[4], ql[4];
        for (int q = 0; q < 4; ++q) {
          const int t = tr + g + 8 * (q & 1);
          const int c = 16 * kk + 2 * tg + 8 * (q >> 1);
          const float2 rv = load2(R + t * RP + c);
          const float2 lt = *reinterpret_cast<const float2*>(LA + t * LAP + c);
          split<bf16>(rv.x * ex2(lt.x), rv.y * ex2(lt.y), qh[q], ql[q]);
        }
        for (int nt = 0; nt < 4; ++nt) {
          const int off = (dh + 8 * nt + g) * RP + 16 * kk + 2 * tg;
          const uint32_t h0 = ld32(hi_s + off), h1 = ld32(hi_s + off + 8);
          mma<bf16>(o[nt], qh, h0, h1);
          mma<bf16>(o[nt], qh, ld32(lo_s + off), ld32(lo_s + off + 8));
          mma<bf16>(o[nt], ql, h0, h1);
        }
      }
      // the bonus ((r * u) . k) of row tr + lane / 2, in fp32
      float bon = 0.f;
      {
        const int t = tr + (lane >> 1), c0 = (lane & 1) * (C / 2);
        for (int c = c0; c < c0 + C / 2; c += 2) {
          const float2 rv = load2(R + t * RP + c), kv = load2(K + t * RP + c);
          bon += rv.x * U[c] * kv.x + rv.y * U[c + 1] * kv.y;
        }
        bon += __shfl_xor_sync(FULL, bon, 1);
      }
      const float bon0 = __shfl_sync(FULL, bon, 2 * g);
      const float bon1 = __shfl_sync(FULL, bon, 2 * g + 16);
      for (int nt = 0; nt < 4; ++nt) {
        const int d = dh + 8 * nt + 2 * tg;
        for (int half = 0; half < 2; ++half) {
          const int t = tr + g + 8 * half;
          if (t >= valid) continue;
          const float bb = half ? bon1 : bon0;
          const float2 vv = load2(V + t * RP + d);
          *reinterpret_cast<uint32_t*>(og + (t0 + t) * so + d) =
              pack<T>(o[nt][2 * half] + bb * vv.x,
                      o[nt][2 * half + 1] + bb * vv.y);
        }
      }
    }

    // ---- S <- exp(la_L) S + (k^ hi + k^ lo)^T V, into the other buffer
    // (the inter-chunk products above read this one: no barrier needed)
    {
      const float* lL = LA + L * LAP;
      const float f0 = ex2(lL[m0]), f1 = ex2(lL[m0 + 8]);
      for (int x = 0; x < NH; ++x)
        for (int nt = 0; nt < 4; ++nt) {
          S[x][nt][0] *= f0;
          S[x][nt][1] *= f0;
          S[x][nt][2] *= f1;
          S[x][nt][3] *= f1;
        }
      for (int kk = 0; kk < L / 16; ++kk) {
        uint32_t hi[4], lo[4];
        for (int q = 0; q < 4; ++q) {
          const int c = m0 + 8 * (q & 1), s = 16 * kk + 2 * tg + 8 * (q >> 1);
          const float x0 = to_f(K[s * RP + c])
                           * ex2(lL[c] - LA[(s + 1) * LAP + c]);
          const float x1 = to_f(K[(s + 1) * RP + c])
                           * ex2(lL[c] - LA[(s + 2) * LAP + c]);
          split<T>(x0, x1, hi[q], lo[q]);
        }
        for (int x = 0; x < NH; ++x)
          for (int np = 0; np < 2; ++np) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, V + (16 * kk + (lane & 15)) * RP
                                  + 32 * (warp / 4 + x) + 16 * np
                                  + 8 * (lane >> 4));
            mma<T>(S[x][2 * np], hi, bv[0], bv[1]);
            mma<T>(S[x][2 * np], lo, bv[0], bv[1]);
            mma<T>(S[x][2 * np + 1], hi, bv[2], bv[3]);
            mma<T>(S[x][2 * np + 1], lo, bv[2], bv[3]);
          }
      }
    }
    cb ^= 1;
    store_state(cb);
  }

  if (a.s_out != nullptr)
    for (int x = 0; x < NH; ++x)
      for (int nt = 0; nt < 4; ++nt)
        for (int half = 0; half < 2; ++half) {
          const int c = m0 + 8 * half;
          const int d = 32 * (warp / 4 + x) + 8 * nt + 2 * tg;
          *reinterpret_cast<float2*>(a.s_out + sbase + c * C + d) =
              make_float2(S[x][nt][2 * half], S[x][nt][2 * half + 1]);
        }
}

template <typename T, int L>
int launch(const WkvArgs& a, int BH, cudaStream_t stream) {
  using Sh = Shape<L>;
  auto kernel = rwkv6_wkv_tc_kernel<T, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<BH, Sh::THREADS, Sh::BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk(const WkvArgs& a, int BH, int L, cudaStream_t s) {
  return L == 32 ? launch<T, 32>(a, BH, s) : launch<T, 64>(a, BH, s);
}

}  // namespace

// r, k, v, o (B, H, T, 64) in one dtype (float16 or bfloat16) and lw
// (B, H, T, 64) float32, each with unit stride along the head dim and the
// element strides along B, H and T given in ``strides`` (r, k, v, lw, o;
// 15 values), every pointer and stride a whole number of 16 bytes; u
// (H, 64) float32; s0 (B, H, 64, 64) float32 or null (a zero initial
// state); s_out (B, H, 64, 64) float32.  L in {32, 64}.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int rwkv6_wkv_tc_launch(int dtype_code, const void* r,
                                   const void* k, const void* v,
                                   const void* lw, const void* u,
                                   const void* s0, void* o, void* s_out,
                                   int B, int H, int T_len, int L,
                                   const long long* strides, void* stream) {
  cudaGetLastError();   // clear any stale error so the check below is ours
  if (L != 32 && L != 64) return static_cast<int>(cudaErrorInvalidValue);
  WkvArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = static_cast<const float*>(lw);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.o = o;
  a.s_out = static_cast<float*>(s_out);
  for (int i = 0; i < 15; ++i) a.st[i / 3][i % 3] = strides[i];
  a.H = H;
  a.T = T_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case DT_F16: return launch_chunk<__half>(a, B * H, L, s);
    case DT_BF16: return launch_chunk<bf16>(a, B * H, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
