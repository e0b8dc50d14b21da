// Grouped (expert) GEMM for Hopper (sm_90a):
//   out[i, :] = x[i, :] @ w[block_expert[i / tt], :, :]
// for token-replicas sorted by expert and padded to blocks of tt rows, with
// float32 accumulation and the output written in x's type (float32 or
// bfloat16).
//
// Replaces: src/repro/kernels/moe_gemm.py, _moe_kernel /
// moe_group_gemm_pallas (the TPU kernel).
//
// What bounds it on this card: bytes.  On the MoE path every expert owns
// one block of 64 rows (capacity 64 at OLMoE's prefill and decode sizes),
// so one launch reads all 64 experts' weights once: at d_in 2048, d_out
// 1024 in bf16 that is 268 MB of weights beside 25 MB of x and out, 0.088
// ms at 3.35 TB/s, against 17.2 GFLOP, 0.017 ms at 989 TFLOP/s (bf16
// tensor cores).
//
// What the design does about it.  The TPU kernel walks a sequential grid
// (token block, 128 output lanes, 512-deep k tile) and fetches the
// expert's weight tile through a scalar-prefetched index_map.  Here one
// thread block owns (a 64-row slice of one token block, 128 output
// columns) and reads its expert from block_expert in device memory; the
// blocks run concurrently, so every weight element is read from device
// memory by the one block that needs it (the blocks of one token block
// share x through L2).  d_in is walked in 32-deep tiles staged in shared
// memory.  Two bodies:
//
// * bf16 operands (the model path): the tiles stay bf16 in shared memory,
//   loaded 16 bytes a thread where d_in and d_out are multiples of 8, and
//   the tensor cores multiply them (WMMA 16x16x16, mma.sync underneath):
//   each of the 8 warps owns a 32 x 32 piece of the output as 2 x 2 float32
//   accumulator fragments.  The result goes through shared memory once, so
//   the output is written row-major with the edges masked.
// * float32 operands: plain SIMT FMA, the tiles staged as float32 — x's
//   transposed (a thread reads its 8 rows with warp-wide broadcasts), w's
//   row-major (a warp reads 32 neighbouring columns, conflict-free); each of
//   the 256 threads keeps an 8 x 4 tile of accumulators in registers, rows
//   ty + 8*i and columns tx + 32*j, so every store is 32 neighbouring
//   elements.  Each k tile is summed into its own partials before it joins
//   the accumulators, which keeps the rounding of a 2048-deep sum near that
//   of a blocked product.
//
// The ragged d_in, d_out and row edges are masked (loaded as zeros, not
// stored), so no operand is padded; a block whose expert is out of range
// is written as zeros.  Later work: cp.async/TMA double buffering and
// wgmma.
#include <mma.h>

#include "spmm_common.cuh"

namespace repro {

constexpr int kMoeBM = 64;                // rows of a thread block's tile
constexpr int kMoeBN = 128;               // columns of a thread block's tile
constexpr int kMoeBK = 32;                // depth of a shared-memory k tile
constexpr int kMoeThreads = 256;
constexpr int kMoeRowsPerThread = kMoeBM / (kMoeThreads / kWarp);  // 8
constexpr int kMoeColsPerThread = kMoeBN / kWarp;                   // 4
// The bf16 body: WMMA tiles, and shared-memory row strides padded by 16
// bytes (a multiple of 8 bf16 / 4 floats, as WMMA requires).
constexpr int kWmma = 16;
constexpr int kWarpTile = 32;             // a warp's rows and columns
constexpr int kLdX = kMoeBK + 8;          // bf16
constexpr int kLdW = kMoeBN + 8;          // bf16
constexpr int kLdO = kMoeBN + 4;          // float
constexpr int kChunk = 8;                 // bf16 in a 16-byte load

__device__ __forceinline__ void moe_block(int tt, int row_tiles, int* blk,
                                          int64_t* row0, int* rows) {
  *blk = blockIdx.x / row_tiles;
  const int sub = blockIdx.x % row_tiles;
  *row0 = static_cast<int64_t>(*blk) * tt + static_cast<int64_t>(sub) * kMoeBM;
  *rows = min(kMoeBM, tt - sub * kMoeBM);
}

// The float32 body.
__global__ void __launch_bounds__(kMoeThreads)
moe_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int32_t* __restrict__ block_expert,
                    float* __restrict__ out, int d_in, int d_out,
                    int n_experts, int tt, int row_tiles) {
  // xs[k][row] is x's tile transposed; +1 keeps the transposing stores
  // conflict-free.
  __shared__ float xs[kMoeBK][kMoeBM + 1];
  __shared__ float ws[kMoeBK][kMoeBN];

  const int tid = threadIdx.x;
  const int tx = tid % kWarp;  // column group: columns tx + 32 * j
  const int ty = tid / kWarp;  // row group: rows ty + 8 * i
  int blk, rows;
  int64_t row0;
  moe_block(tt, row_tiles, &blk, &row0, &rows);
  const int col0 = blockIdx.y * kMoeBN;
  const int e = block_expert[blk];
  const bool live = e >= 0 && e < n_experts;
  const float* wexp = w + static_cast<int64_t>(live ? e : 0) * d_in * d_out;

  float acc[kMoeRowsPerThread][kMoeColsPerThread];
#pragma unroll
  for (int i = 0; i < kMoeRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kMoeColsPerThread; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; live && k0 < d_in; k0 += kMoeBK) {  // uniform per block
    // x tile: kMoeBM rows x kMoeBK columns; a warp reads 32 neighbouring
    // columns of one row.
#pragma unroll
    for (int it = 0; it < kMoeBM * kMoeBK / kMoeThreads; ++it) {
      const int idx = tid + it * kMoeThreads;
      const int r = idx / kMoeBK;
      const int c = idx % kMoeBK;
      float v = 0.0f;
      if (r < rows && k0 + c < d_in) {
        v = x[(row0 + r) * d_in + k0 + c];
      }
      xs[c][r] = v;
    }
    // w tile: kMoeBK rows x kMoeBN columns of the expert's (d_in, d_out).
#pragma unroll
    for (int it = 0; it < kMoeBK * kMoeBN / kMoeThreads; ++it) {
      const int idx = tid + it * kMoeThreads;
      const int r = idx / kMoeBN;
      const int c = idx % kMoeBN;
      float v = 0.0f;
      if (k0 + r < d_in && col0 + c < d_out) {
        v = wexp[static_cast<int64_t>(k0 + r) * d_out + col0 + c];
      }
      ws[r][c] = v;
    }
    __syncthreads();
    float part[kMoeRowsPerThread][kMoeColsPerThread];
#pragma unroll
    for (int i = 0; i < kMoeRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kMoeColsPerThread; ++j) part[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int kk = 0; kk < kMoeBK; ++kk) {
      float a[kMoeRowsPerThread], b[kMoeColsPerThread];
#pragma unroll
      for (int i = 0; i < kMoeRowsPerThread; ++i) a[i] = xs[kk][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < kMoeColsPerThread; ++j) {
        b[j] = ws[kk][tx + kWarp * j];
      }
#pragma unroll
      for (int i = 0; i < kMoeRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kMoeColsPerThread; ++j) {
          part[i][j] = fmaf(a[i], b[j], part[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMoeRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kMoeColsPerThread; ++j) acc[i][j] += part[i][j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMoeRowsPerThread; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kMoeColsPerThread; ++j) {
      const int c = col0 + tx + kWarp * j;
      if (c < d_out) out[(row0 + r) * d_out + c] = acc[i][j];
    }
  }
}

// The bf16 body.  kVec: d_in and d_out are multiples of 8 and x, w are
// 16-byte aligned, so every tile row loads as whole 16-byte chunks that lie
// entirely inside or outside the edges.
template <bool kVec>
__global__ void __launch_bounds__(kMoeThreads)
moe_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const int32_t* __restrict__ block_expert,
                     __nv_bfloat16* __restrict__ out, int d_in, int d_out,
                     int n_experts, int tt, int row_tiles) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[kMoeBM][kLdX];
  __shared__ __align__(32) __nv_bfloat16 ws[kMoeBK][kLdW];
  __shared__ __align__(32) float os[kMoeBM][kLdO];

  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int wr = (warp / (kMoeBN / kWarpTile)) * kWarpTile;  // warp's rows
  const int wc = (warp % (kMoeBN / kWarpTile)) * kWarpTile;  // and columns
  int blk, rows;
  int64_t row0;
  moe_block(tt, row_tiles, &blk, &row0, &rows);
  const int col0 = blockIdx.y * kMoeBN;
  const int e = block_expert[blk];
  const bool live = e >= 0 && e < n_experts;
  const __nv_bfloat16* wexp =
      w + static_cast<int64_t>(live ? e : 0) * d_in * d_out;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  constexpr int kFrags = kWarpTile / kWmma;  // 2 x 2 fragments a warp
  wmma::fragment<wmma::accumulator, kWmma, kWmma, kWmma, float>
      acc[kFrags][kFrags];
#pragma unroll
  for (int i = 0; i < kFrags; ++i) {
#pragma unroll
    for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  for (int k0 = 0; live && k0 < d_in; k0 += kMoeBK) {  // uniform per block
    if (kVec) {
      // x tile: kMoeBM rows x kMoeBK / 8 chunks; w tile: kMoeBK rows x
      // kMoeBN / 8 chunks.
#pragma unroll
      for (int it = 0; it < kMoeBM * kMoeBK / kChunk / kMoeThreads; ++it) {
        const int idx = tid + it * kMoeThreads;
        const int r = idx / (kMoeBK / kChunk);
        const int c = (idx % (kMoeBK / kChunk)) * kChunk;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < rows && k0 + c < d_in) {
          v = *reinterpret_cast<const uint4*>(x + (row0 + r) * d_in + k0 + c);
        }
        *reinterpret_cast<uint4*>(&xs[r][c]) = v;
      }
#pragma unroll
      for (int it = 0; it < kMoeBK * kMoeBN / kChunk / kMoeThreads; ++it) {
        const int idx = tid + it * kMoeThreads;
        const int r = idx / (kMoeBN / kChunk);
        const int c = (idx % (kMoeBN / kChunk)) * kChunk;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k0 + r < d_in && col0 + c < d_out) {
          v = *reinterpret_cast<const uint4*>(
              wexp + static_cast<int64_t>(k0 + r) * d_out + col0 + c);
        }
        *reinterpret_cast<uint4*>(&ws[r][c]) = v;
      }
    } else {
#pragma unroll
      for (int it = 0; it < kMoeBM * kMoeBK / kMoeThreads; ++it) {
        const int idx = tid + it * kMoeThreads;
        const int r = idx / kMoeBK;
        const int c = idx % kMoeBK;
        xs[r][c] = r < rows && k0 + c < d_in
                       ? x[(row0 + r) * d_in + k0 + c] : zero;
      }
#pragma unroll
      for (int it = 0; it < kMoeBK * kMoeBN / kMoeThreads; ++it) {
        const int idx = tid + it * kMoeThreads;
        const int r = idx / kMoeBN;
        const int c = idx % kMoeBN;
        ws[r][c] = k0 + r < d_in && col0 + c < d_out
                       ? wexp[static_cast<int64_t>(k0 + r) * d_out + col0 + c]
                       : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMoeBK; kk += kWmma) {
      wmma::fragment<wmma::matrix_a, kWmma, kWmma, kWmma, __nv_bfloat16,
                     wmma::row_major> a[kFrags];
      wmma::fragment<wmma::matrix_b, kWmma, kWmma, kWmma, __nv_bfloat16,
                     wmma::row_major> b[kFrags];
#pragma unroll
      for (int i = 0; i < kFrags; ++i) {
        wmma::load_matrix_sync(a[i], &xs[wr + kWmma * i][kk], kLdX);
        wmma::load_matrix_sync(b[i], &ws[kk][wc + kWmma * i], kLdW);
      }
#pragma unroll
      for (int i = 0; i < kFrags; ++i) {
#pragma unroll
        for (int j = 0; j < kFrags; ++j) {
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFrags; ++i) {
#pragma unroll
    for (int j = 0; j < kFrags; ++j) {
      wmma::store_matrix_sync(&os[wr + kWmma * i][wc + kWmma * j], acc[i][j],
                              kLdO, wmma::mem_row_major);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int it = 0; it < kMoeBM * kMoeBN / kMoeThreads; ++it) {
    const int idx = tid + it * kMoeThreads;
    const int r = idx / kMoeBN;
    const int c = idx % kMoeBN;
    if (r < rows && col0 + c < d_out) {
      out[(row0 + r) * d_out + col0 + c] = __float2bfloat16_rn(os[r][c]);
    }
  }
}

}  // namespace repro

// C entry: out (tokens, d_out) = x (tokens, d_in) times, block by block of
// tt rows, w[block_expert[block]] (w (n_experts, d_in, d_out)); x, w and out
// row-major and all of one dtype; block_expert (tokens / tt,) int32.
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int repro_moe_gemm(const void* x, const void* w, int dtype,
                              const void* block_expert, void* out, int tokens,
                              int d_in, int d_out, int n_experts, int tt,
                              int device, void* stream) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dtype) || tt <= 0 || tokens % tt != 0 || d_in < 0 ||
      d_out <= 0 || n_experts <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = tokens / tt;
  const int row_tiles = (tt + kMoeBM - 1) / kMoeBM;
  const int64_t grid_x = static_cast<int64_t>(n_blocks) * row_tiles;
  const int grid_y = (d_out + kMoeBN - 1) / kMoeBN;
  if (grid_x == 0) return static_cast<int>(cudaGetLastError());
  if (grid_x > 0x7fffffffLL || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(grid_x), grid_y);
  const auto* be = static_cast<const int32_t*>(block_expert);
  if (dtype == kF32) {
    moe_gemm_f32_kernel<<<grid, kMoeThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), be,
        static_cast<float*>(out), d_in, d_out, n_experts, tt, row_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const bool vec = d_in % kChunk == 0 && d_out % kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) {
    moe_gemm_bf16_kernel<true><<<grid, kMoeThreads, 0, s>>>(
        xb, wb, be, ob, d_in, d_out, n_experts, tt, row_tiles);
  } else {
    moe_gemm_bf16_kernel<false><<<grid, kMoeThreads, 0, s>>>(
        xb, wb, be, ob, d_in, d_out, n_experts, tt, row_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
