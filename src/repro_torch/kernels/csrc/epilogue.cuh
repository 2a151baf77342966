// The epilogue shared by every tile of the fused matmul (K1: the SIMT
// tile of gemm_tile.cuh, the decode tile of decode_tile.cuh and the
// tensor-core tile of fused_matmul_sm90.cu) and by the grouped MoE matmul
// (K4): the type codes, the epilogue operands and ``finish``, which turns
// one accumulator (and, under GLU, its paired up-column accumulator) into
// one stored output element.
//
// Order, as the reference defines it: scale_a per row, scale_b per
// column, bias (zero, row or full), softcap, activation, GLU, residual,
// cast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum InCode { IN_F32 = 0, IN_F16 = 1, IN_BF16 = 2, IN_I8 = 3 };
enum OutCode { OUT_F32 = 0, OUT_F16 = 1, OUT_BF16 = 2, OUT_I32 = 3 };
enum BiasCode { BIAS_ZERO = 0, BIAS_ROW = 1, BIAS_FULL = 2 };
// Activation ids follow repro_torch.core.fusion.ACTIVATIONS.
enum Act { ACT_NONE = 0, ACT_RELU, ACT_RELU2, ACT_GELU, ACT_GELU_TANH,
           ACT_SILU, ACT_SIGMOID, ACT_TANH };

struct Epi {
  int bias_type;
  const float* bias;      // (N,) row bias or (M, N) full bias, fp32
  const float* scale_a;   // (M,) or null
  const float* scale_b;   // (N,) or null
  const float* residual;  // (M, N_out) or null
  float softcap;          // 0 = off
  int act;
  int glu;
  int trivial;            // no vector work: cast the accumulator only
  int out_code;
  void* out;              // (M, N_out)
};

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float conv(float x) { return x; }
__device__ __forceinline__ float conv(__half x) { return __half2float(x); }
__device__ __forceinline__ float conv(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int conv(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_RELU2: { float r = fmaxf(x, 0.f); return r * r; }
    case ACT_GELU:        // jax.nn.gelu defaults to the tanh form
    case ACT_GELU_TANH:
      return 0.5f * x * (1.f + tanhf(0.7978845608028654f *
                                     (x + 0.044715f * x * x * x)));
    case ACT_SILU: return x / (1.f + expf(-x));
    case ACT_SIGMOID: return 1.f / (1.f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ void store(void* out, size_t i, int code,
                                      float v) {
  switch (code) {
    case OUT_F32: static_cast<float*>(out)[i] = v; break;
    case OUT_F16: static_cast<__half*>(out)[i] = __float2half_rn(v); break;
    case OUT_BF16:
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v); break;
    default: static_cast<int*>(out)[i] = static_cast<int>(v); break;
  }
}

// The trivial epilogue keeps an int32 accumulator exact.
__device__ __forceinline__ void store_acc(void* out, size_t i, int code,
                                          int v) {
  if (code == OUT_I32) static_cast<int*>(out)[i] = v;
  else store(out, i, code, static_cast<float>(v));
}
__device__ __forceinline__ void store_acc(void* out, size_t i, int code,
                                          float v) {
  store(out, i, code, v);
}

// Epilogue steps before the activation: scales, bias, softcap.
__device__ __forceinline__ float pre_act(float y, int row, int col, int N,
                                         const Epi& ep) {
  if (ep.scale_a) y *= ep.scale_a[row];
  if (ep.scale_b) y *= ep.scale_b[col];
  if (ep.bias_type == BIAS_ROW) y += ep.bias[col];
  else if (ep.bias_type == BIAS_FULL) y += ep.bias[(size_t)row * N + col];
  if (ep.softcap != 0.f) y = tanhf(y / ep.softcap) * ep.softcap;
  return y;
}

// Everything after the accumulator for one output element (column
// ``col`` of the output; under GLU ``up`` is the paired up-column sum).
// Kept out of line: the tile loop is unrolled, and inlining the
// activation and store switches into every element made the compiler's
// front end run for minutes.
template <typename acc_t>
__device__ __noinline__ void finish(acc_t acc, acc_t up, int row, int col,
                                    int N, Epi ep) {
  const int n_out = ep.glu ? N / 2 : N;
  const size_t o = (size_t)row * n_out + col;
  if (ep.trivial) {
    store_acc(ep.out, o, ep.out_code, acc);
    return;
  }
  float y = activate(pre_act(static_cast<float>(acc), row, col, N, ep),
                     ep.act);
  if (ep.glu)
    y *= pre_act(static_cast<float>(up), row, n_out + col, N, ep);
  if (ep.residual) y += ep.residual[o];
  store(ep.out, o, ep.out_code, y);
}

// The epilogue of one call, from the C entry points' arguments.
inline Epi make_epi(int glu, int bias_type, const void* bias,
                    const void* scale_a, const void* scale_b,
                    const void* residual, float softcap, int act,
                    int trivial, int out_code, void* out) {
  Epi ep;
  ep.bias_type = bias_type;
  ep.bias = static_cast<const float*>(bias);
  ep.scale_a = static_cast<const float*>(scale_a);
  ep.scale_b = static_cast<const float*>(scale_b);
  ep.residual = static_cast<const float*>(residual);
  ep.softcap = softcap;
  ep.act = act;
  ep.glu = glu;
  ep.trivial = trivial;
  ep.out_code = out_code;
  ep.out = out;
  return ep;
}

}  // namespace
