// Shared pieces of the SpMM and SDDMM kernels: dtype conversion, the fused
// epilogue y = act(C + bias) * scale + residual (applied in float32, cast
// once to the output type), the C-ABI dtype/activation/body codes that the
// ctypes wrappers in repro_torch/kernels/_cuda.py pass in or read back, and
// the three bodies that read a 128-column slice of a row-major row (B of
// the SpMMs, dC and B of the SDDMM).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

// Dtype codes (must match kernels/_cuda.py DTYPE_CODES).
enum Dtype : int { kF32 = 0, kBF16 = 1 };
// Activation codes (must match kernels/_cuda.py ACT_CODES).
enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };
// Body codes (must match kernels/_cuda.py BODIES): how a warp reads a
// 128-column slice of a row.  f32x4 -- a lane reads 4 consecutive f32
// columns with one 16-byte load, a warp covers 128; bf16x8 -- a lane reads
// 8 bf16 columns, so a half-warp covers 128 and the two half-warps take
// two rows at once; scalar -- 4-byte loads of columns lane + 32 q, for the
// n and alignments the vector bodies do not take (n = 1, for example);
// staged -- the row-split kernel's f32x4 body fed from B windows staged
// in shared memory (csrc/rowsplit_spmm.cu), which the merge and SDDMM
// kernels do not have.
enum SpmmBody : int {
  kBodyScalar = 0, kBodyF32x4 = 1, kBodyBf16x8 = 2, kBodyStaged = 3
};

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

// The columns a lane owns in its 128-column slice: kPer values, kStride
// apart, starting at first_col; kSlots rows consumed at once by kSlots
// groups of 32 / kSlots lanes.
template <int kBody>
struct Layout {
  static constexpr int kPer = kBody == kBodyBf16x8 ? 8 : 4;
  static constexpr int kStride = kBody == kBodyScalar ? kWarp : 1;
  static constexpr int kSlots = kBody == kBodyBf16x8 ? 2 : 1;
  static constexpr int kLanes = kWarp / kSlots;
  // A vector body's kPer columns are all inside n or all past it (n %
  // kPer == 0).
  __device__ static int first_col(int slice, int lane) {
    return slice * kSliceCols +
           (kStride == 1 ? (lane % kLanes) * kPer : lane);
  }
};

// One lane's share of a row, as loaded: raw until its FMAs.
template <int kBody, typename TB, bool kVec = kBody != kBodyScalar>
struct BRaw {
  TB x[4];
  __device__ void load(const TB* row, int c0, int n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q * kWarp;
      x[q] = c < n ? row[c] : from_f32<TB>(0.0f);
    }
  }
  __device__ void clear() {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = from_f32<TB>(0.0f);
  }
  __device__ void accumulate(float v, float* acc) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = fmaf(v, to_f32(x[q]), acc[q]);
  }
  __device__ void unpack(float* f) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = to_f32(x[q]);
  }
};

template <int kBody, typename TB>
struct BRaw<kBody, TB, true> {
  uint4 x;
  __device__ void load(const TB* row, int c0, int n) {
    x = c0 < n ? __ldg(reinterpret_cast<const uint4*>(row + c0))
               : make_uint4(0, 0, 0, 0);
  }
  __device__ void clear() { x = make_uint4(0, 0, 0, 0); }
  __device__ void accumulate(float v, float* acc) const {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    if constexpr (kBody == kBodyF32x4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(v, __uint_as_float(w[q]),
                                               acc[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // bf16 -> f32 is exact: the 16 bits become the high half.
        acc[2 * q] = fmaf(v, __uint_as_float(w[q] << 16), acc[2 * q]);
        acc[2 * q + 1] =
            fmaf(v, __uint_as_float(w[q] & 0xffff0000u), acc[2 * q + 1]);
      }
    }
  }
  __device__ void unpack(float* f) const {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    if constexpr (kBody == kBodyF32x4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = __uint_as_float(w[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        f[2 * q] = __uint_as_float(w[q] << 16);
        f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
      }
    }
  }
};

// Row `row` of C from a lane's float32 sums: the epilogue, one cast, one
// store of kPer values (16 or 32 bytes a lane in the vector bodies).
template <int kBody, typename TO>
__device__ __forceinline__ void store_row(TO* out, const float* acc,
                                          const Epilogue& ep, int64_t row,
                                          int64_t obase, int c0, int n) {
  using L = Layout<kBody>;
  float y[L::kPer];
  if constexpr (kBody == kBodyScalar) {
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) {
      const int c = c0 + q * kWarp;
      if (c < n) {
        out[obase + c] = from_f32<TO>(apply_epilogue(acc[q], ep, row,
                                                     obase + c));
      }
    }
  } else {
    if (c0 >= n) return;
    apply_epilogue_vec<L::kPer>(acc, y, ep, row, obase + c0);
    store_vec<TO, L::kPer>(out + obase + c0, y);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The body a launch runs: f32x4 for float32 rows with n % 4 == 0, bf16x8
// for bfloat16 rows with n % 8 == 0, both only when every row-major
// operand it reads or writes with vector accesses is 16-byte aligned
// (vec_ok); scalar otherwise (kernels/_cuda.py body_for).
inline int pick_body(int dtype, int n, bool vec_ok) {
  if (vec_ok && dtype == kF32 && n % 4 == 0) return kBodyF32x4;
  if (vec_ok && dtype == kBF16 && n % 8 == 0) return kBodyBf16x8;
  return kBodyScalar;
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

// Calls f(std::integral_constant<int, kBody>{}) for a body code.
template <typename F>
void with_body(int code, F&& f) {
  if (code == kBodyF32x4) {
    f(std::integral_constant<int, kBodyF32x4>{});
  } else if (code == kBodyBf16x8) {
    f(std::integral_constant<int, kBodyBf16x8>{});
  } else {
    f(std::integral_constant<int, kBodyScalar>{});
  }
}

// Whether a body reads rows of element type T (f32x4 float32, bf16x8
// bfloat16; scalar either): the instances a launch never picks are not
// compiled.
template <int kBody, typename T>
constexpr bool body_reads() {
  if constexpr (kBody == kBodyF32x4) return std::is_same_v<T, float>;
  if constexpr (kBody == kBodyBf16x8) {
    return std::is_same_v<T, __nv_bfloat16>;
  }
  return true;
}

}  // namespace repro
