// Shared pieces of the two SpMM kernels: dtype conversion, the fused
// epilogue y = act(C + bias) * scale + residual (applied in float32, cast
// once to the output type), and the C-ABI dtype/activation codes that the
// ctypes wrappers in repro_torch/kernels/_cuda.py pass in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Dtype codes (must match kernels/_cuda.py DTYPE_CODES).
enum Dtype : int { kF32 = 0, kBF16 = 1 };
// Activation codes (must match kernels/_cuda.py ACT_CODES).
enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };

constexpr int kWarp = 32;
// Columns of C one lane owns: lane l of a warp handles columns
// c0 + l + 32*q for q < kColsPerLane, so one warp covers 128 columns and
// every load of a B row is 32 neighbouring elements (coalesced).
constexpr int kColsPerLane = 4;
constexpr int kSliceCols = kWarp * kColsPerLane;
constexpr int kWarpsPerBlock = 8;
constexpr int kBlock = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as XLA's convert
}

// The epilogue operands.  bias is (m,) float32, residual (batch, m, n)
// float32 (the wrappers cast both, which is exact for f32/bf16 inputs);
// a null pointer means the stage is off.
struct Epilogue {
  const float* bias;
  const float* residual;
  int act;
  int has_scale;
  float scale;
};

// jax.nn.gelu's default (tanh) approximation.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// row: the C row (for bias); idx: the flat (batch, m, n) index (residual).
__device__ __forceinline__ float apply_epilogue(float c, const Epilogue& ep,
                                                int64_t row, int64_t idx) {
  if (ep.bias != nullptr) c += ep.bias[row];
  if (ep.act == kRelu) {
    c = fmaxf(c, 0.0f);
  } else if (ep.act == kGelu) {
    c = gelu_tanh(c);
  }
  if (ep.has_scale) c *= ep.scale;
  if (ep.residual != nullptr) c += ep.residual[idx];
  return c;
}

// The epilogue on K consecutive columns starting at flat index idx0 (a
// multiple of 4, residual 16-byte aligned): residual read as float4s.
template <int K>
__device__ __forceinline__ void apply_epilogue_vec(const float* c, float* y,
                                                   const Epilogue& ep,
                                                   int64_t row,
                                                   int64_t idx0) {
  static_assert(K % 4 == 0, "K must be a multiple of 4");
  const float bias = ep.bias != nullptr ? ep.bias[row] : 0.0f;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float x = c[q];
    if (ep.bias != nullptr) x += bias;
    if (ep.act == kRelu) {
      x = fmaxf(x, 0.0f);
    } else if (ep.act == kGelu) {
      x = gelu_tanh(x);
    }
    if (ep.has_scale) x *= ep.scale;
    y[q] = x;
  }
  if (ep.residual != nullptr) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 r =
          *reinterpret_cast<const float4*>(ep.residual + idx0 + q);
      y[q] += r.x;
      y[q + 1] += r.y;
      y[q + 2] += r.z;
      y[q + 3] += r.w;
    }
  }
}

// K values cast to TO and stored at dst with 16-byte stores (8-byte for
// four bf16); dst aligned to the store's size.
template <typename TO, int K>
__device__ __forceinline__ void store_vec(TO* dst, const float* y) {
  static_assert(K % 4 == 0, "K must be a multiple of 4");
#pragma unroll
  for (int q = 0; q < K; q += 4) {
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float4*>(dst + q) =
          make_float4(y[q], y[q + 1], y[q + 2], y[q + 3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[q], y[q + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[q + 2], y[q + 3]);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + q) = v;
    }
  }
}

inline bool known_dtype(int code) { return code == kF32 || code == kBF16; }

// Calls f(T{}) with T the C++ type of a dtype code (checked beforehand
// with known_dtype).
template <typename F>
void with_dtype(int code, F&& f) {
  if (code == kBF16) {
    f(__nv_bfloat16{});
  } else {
    f(float{});
  }
}

}  // namespace repro
