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
// tensor cores).  What counts is keeping device memory busy.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// (token block, 128 output lanes, 512-deep k tile) and fetches the
// expert's weight tile through a scalar-prefetched index_map.  Here the
// expert is read from block_expert in device memory, every weight element
// is read from device memory by the one tile that needs it, and the tiles
// of one token block share x through L2.  Three bodies (the C entry
// reports which one ran):
//
// * wgmma (bf16, tt a multiple of 64, d_in a positive multiple of 8,
//   d_out a multiple of 8, x / w / out 16-byte aligned: the model path).
//   Persistent: about one block an SM, each walking (64-row tile, 128
//   columns) work items, the column tiles of one token block next to each
//   other.  A producer warp feeds a ring of kGmStages stages by TMA (x's 64
//   x 64 tile and W's 64 x 128 tile as two 64-column boxes, 128-byte
//   swizzle, zero-filled past d_in and d_out), and keeps loading across
//   item boundaries, so device memory stays busy through each epilogue;
//   one consumer warpgroup multiplies with wgmma m64n128k16 (x K-major, W
//   MN-major, both in shared memory), stages the result in shared memory
//   as bf16 and writes it with 16-byte stores.  See the body's comment.
// * wmma (the other bf16 cases: the reference's tt-8 sweep, ragged tt or
//   d): one thread block owns (a 64-row slice of one token block, 128
//   output columns); d_in is walked in 32-deep tiles staged in shared
//   memory, loaded 16 bytes a thread where d_in and d_out are multiples
//   of 8, and the tensor cores multiply them (WMMA 16x16x16, mma.sync
//   underneath): each of the 8 warps owns a 32 x 32 piece of the output
//   as 2 x 2 float32 accumulator fragments.  The result goes through
//   shared memory once, so the output is written row-major with the edges
//   masked.
// * simt (float32 operands): the same tiles, plain SIMT FMA, staged as
//   float32 — x's transposed (a thread reads its 8 rows with warp-wide
//   broadcasts), w's row-major (a warp reads 32 neighbouring columns,
//   conflict-free); each of the 256 threads keeps an 8 x 4 tile of
//   accumulators in registers, rows ty + 8*i and columns tx + 32*j, so
//   every store is 32 neighbouring elements.  Each k tile is summed into
//   its own partials before it joins the accumulators, which keeps the
//   rounding of a 2048-deep sum near that of a blocked product.
//
// The ragged d_in, d_out and row edges are masked (loaded as zeros, not
// stored), so no operand is padded; a block whose expert is out of range
// is written as zeros.
#include <mma.h>

#include <algorithm>

#include "hopper.cuh"
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

// ----------------------------------------------------------- wgmma body --
//
// Warps 0-3 are the consumer warpgroup, warp 4 the producer, whose one
// thread issues every load.  Stage s of the ring holds x's tile (64 rows x
// 64 k, K-major) and W's (64 k x 128 columns, MN-major, as two 64-column
// boxes), each stage with a "full" mbarrier (the expected bytes) and an
// "empty" one (one arrival from each consumer warp).  Both sides walk the
// same items in the same order and skip the dead ones (expert out of
// range: written as zeros, nothing loaded), so the ring's stage and phase
// advance in step across items.  The consumer keeps one k step's wgmma in
// flight while it issues the next, and releases a stage as soon as the
// products that read it are done.
//
// Sizes: on the H100, four stages (96 KB in flight a block, one block an
// SM) were as fast as five, six or eight stages, as two blocks an SM of
// three stages, as a 256-column item over two consumer warpgroups (which
// halves x's reads from L2) and as L2 eviction hints (x last, W first):
// device memory, not L2 or the ring, sets the pace.

constexpr int kGmBM = 64;       // rows of an item: one wgmma's M
constexpr int kGmBN = 128;      // columns of an item: one wgmma's N
constexpr int kGmBK = 64;       // depth of a stage: a 128-byte row
constexpr int kGmBox = 64;      // bf16 columns of a 128-byte box row
constexpr int kGmBoxes = kGmBN / kGmBox;
constexpr int kGmStages = 4;
constexpr int kGmThreads = 128 + kWarp;  // the consumers + the producer
constexpr uint32_t kGmXBytes = kGmBM * kGmBK * 2;
constexpr uint32_t kGmWBoxBytes = kGmBK * kGmBox * 2;
constexpr uint32_t kGmStageBytes = kGmXBytes + kGmBoxes * kGmWBoxBytes;
// The staged output tile: rows padded by 16 bytes, so the accumulator
// stores (8 rows x 4 column pairs a warp) hit 32 distinct banks.
constexpr int kGmLdO = kGmBN + 8;
// The ring, the staged output, and slack to align the base to 1024 bytes
// (TMA's 128-byte swizzle repeats every 1024).
constexpr int kGmSmem =
    kGmStages * kGmStageBytes + kGmBM * kGmLdO * 2 + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Work item `item`: row tile item / col_tiles, column tile item %
// col_tiles.  tt is a multiple of 64, so a row tile lies inside one token
// block.
struct GmItem {
  int row0;   // first row (< tokens < 2^31)
  int col0;
  int e;      // the block's expert
  bool live;  // 0 <= e < n_experts
};

__device__ __forceinline__ GmItem gm_item(
    int item, const int32_t* __restrict__ block_expert, int n_experts,
    int tt, int col_tiles) {
  GmItem g;
  g.row0 = (item / col_tiles) * kGmBM;
  g.col0 = (item % col_tiles) * kGmBN;
  g.e = block_expert[g.row0 / tt];
  g.live = g.e >= 0 && g.e < n_experts;
  return g;
}

__global__ void __launch_bounds__(kGmThreads, 1)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const int32_t* __restrict__ block_expert,
                      __nv_bfloat16* __restrict__ out, int d_in, int d_out,
                      int n_experts, int tt, int col_tiles, int n_items) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kGmStages], empty[kGmStages];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  __nv_bfloat16* os =
      reinterpret_cast<__nv_bfloat16*>(ring + kGmStages * kGmStageBytes);
  const int k_steps = (d_in + kGmBK - 1) / kGmBK;
  const int warp = threadIdx.x / kWarp;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kGmStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 4);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: one thread starts every load.
    if (threadIdx.x != 4 * kWarp) return;
    hopper::prefetch_tensor_map(&tx);
    hopper::prefetch_tensor_map(&tw);
    int st = 0;
    uint32_t ph = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const GmItem g = gm_item(item, block_expert, n_experts, tt, col_tiles);
      if (!g.live) continue;
      // W's boxes that lie wholly past d_out at a ragged last column tile
      // are not loaded: they feed only columns that are not stored.
      const int boxes =
          min(kGmBoxes, (d_out - g.col0 + kGmBox - 1) / kGmBox);
      const uint32_t bytes = kGmXBytes + boxes * kGmWBoxBytes;
      for (int ks = 0; ks < k_steps; ++ks) {
        hopper::mbar_wait(&empty[st], ph ^ 1);
        uint8_t* stage = ring + st * kGmStageBytes;
        const int k0 = ks * kGmBK;
        hopper::mbar_expect_tx(&full[st], bytes);
        hopper::tma_load_2d(stage, &tx, &full[st], k0, g.row0);
        for (int b = 0; b < boxes; ++b) {
          hopper::tma_load_3d(stage + kGmXBytes + b * kGmWBoxBytes, &tw,
                              &full[st], g.col0 + b * kGmBox, k0, g.e);
        }
        if (++st == kGmStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: the accumulator layout of m64n128 puts rows r_a and
  // r_a + 8, columns c_q + 8 j and c_q + 8 j + 1 in this thread.
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int r_a = 16 * warp + (lane >> 2);
  const int c_q = 2 * (lane & 3);
  const uint32_t ring_addr = hopper::smem_u32(ring);
  constexpr int kChunks = kGmBN / 8;  // 16-byte chunks of an item's row
  float acc[kGmBN / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const GmItem g = gm_item(item, block_expert, n_experts, tt, col_tiles);
    __nv_bfloat16* ob = out + static_cast<int64_t>(g.row0) * d_out + g.col0;
    if (!g.live) {
      for (int idx = tid; idx < kGmBM * kChunks; idx += 128) {
        const int r = idx / kChunks;
        const int c = (idx % kChunks) * 8;
        if (g.col0 + c < d_out) {
          *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(r) * d_out +
                                    c) = make_uint4(0, 0, 0, 0);
        }
      }
      continue;
    }
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      hopper::mbar_wait(&full[st], ph);
      const uint32_t xa = ring_addr + st * kGmStageBytes;
      const uint32_t wa = xa + kGmXBytes;
      hopper::wgmma_fence();
      hopper::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kGmBK / 16; ++kk) {
        // x: a k16 step moves 32 bytes along the swizzled row; W: 16 rows
        // of 128 bytes, LBO the next 64-column box, SBO 8 rows.
        hopper::wgmma_ss_tb(
            acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
            hopper::desc_sw128(wa + kk * 16 * 128, kGmWBoxBytes, 1024),
            ks > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();  // step ks - 1's products are done
      hopper::fence_regs(acc);
      if (ks > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = st;
      if (++st == kGmStages) {
        st = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // Epilogue: bf16 into the staged tile, then 16-byte rows out.  The
    // first barrier keeps the previous item's reads ahead of these writes.
    hopper::bar_sync(1, 128);
#pragma unroll
    for (int j = 0; j < kGmBN / 8; ++j) {
      const int c = 8 * j + c_q;
      *reinterpret_cast<uint32_t*>(&os[r_a * kGmLdO + c]) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(&os[(r_a + 8) * kGmLdO + c]) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    hopper::bar_sync(1, 128);
#pragma unroll 4
    for (int idx = tid; idx < kGmBM * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      if (g.col0 + c < d_out) {
        *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(r) * d_out + c) =
            *reinterpret_cast<const uint4*>(&os[r * kGmLdO + c]);
      }
    }
  }
}

constexpr int kGmMaxDevices = 64;

// The body a call ran (must match kernels/moe_gemm.py BODIES).
enum MoeBody : int { kBodySimt = 0, kBodyWmma = 1, kBodyWgmma = 2 };

// The map of a bf16 tensor of `rank` dims (innermost first, `strides` in
// bytes for dims 1..rank-1) in boxes of `box` with the 128-byte swizzle;
// a box is zero-filled where it leaves the tensor.
cudaError_t gm_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_moe_wgmma(const void* x, const void* w,
                             const int32_t* block_expert, void* out,
                             int tokens, int d_in, int d_out, int n_experts,
                             int tt, int device, cudaStream_t stream) {
  // x as {d_in, tokens}, w as {d_out, d_in, n_experts}: the expert is a
  // coordinate of W's box.
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(d_in),
                                static_cast<cuuint64_t>(tokens)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(d_in) * 2};
  const cuuint32_t x_box[2] = {kGmBK, kGmBM};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(d_out),
                                static_cast<cuuint64_t>(d_in),
                                static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t w_strides[2] = {
      static_cast<cuuint64_t>(d_out) * 2,
      static_cast<cuuint64_t>(d_out) * 2 * static_cast<cuuint64_t>(d_in)};
  const cuuint32_t w_box[3] = {kGmBox, kGmBK, 1};
  cudaError_t err = gm_tensor_map(&tx, x, 2, x_dims, x_strides, x_box);
  if (err == cudaSuccess) {
    err = gm_tensor_map(&tw, w, 3, w_dims, w_strides, w_box);
  }
  if (err != cudaSuccess) return err;

  // Once per device: the shared-memory opt-in and the number of blocks
  // the card holds at once.
  static int resident[kGmMaxDevices] = {};
  if (resident[device] == 0) {
    err = cudaFuncSetAttribute(moe_gemm_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGmSmem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, moe_gemm_wgmma_kernel, kGmThreads, kGmSmem);
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int col_tiles = (d_out + kGmBN - 1) / kGmBN;
  const int64_t n_items = static_cast<int64_t>(tokens / kGmBM) * col_tiles;
  if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid =
      static_cast<int>(std::min<int64_t>(n_items, resident[device]));
  moe_gemm_wgmma_kernel<<<grid, kGmThreads, kGmSmem, stream>>>(
      tx, tw, block_expert, static_cast<__nv_bfloat16*>(out), d_in, d_out,
      n_experts, tt, col_tiles, static_cast<int>(n_items));
  return cudaGetLastError();
}

}  // namespace repro

// C entry: out (tokens, d_out) = x (tokens, d_in) times, block by block of
// tt rows, w[block_expert[block]] (w (n_experts, d_in, d_out)); x, w and out
// row-major and all of one dtype; block_expert (tokens / tt,) int32.
// Launches on `stream` without synchronising, writes the body it launched
// (0 SIMT f32, 1 WMMA bf16, 2 wgmma bf16) to *body and returns
// cudaGetLastError() (or the error that kept it from launching: a tensor
// map that does not encode, a refused shared-memory opt-in).
extern "C" int repro_moe_gemm(const void* x, const void* w, int dtype,
                              const void* block_expert, void* out, int tokens,
                              int d_in, int d_out, int n_experts, int tt,
                              int device, void* stream, int* body) {
  using namespace repro;
  *body = -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dtype) || tt <= 0 || tokens % tt != 0 || d_in < 0 ||
      d_out <= 0 || n_experts <= 0 || device < 0 ||
      device >= kGmMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA takes row strides that are multiples of 16 bytes and no empty
  // dimension.
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int chosen = dtype == kF32 ? kBodySimt
                     : tt % kGmBM == 0 && d_in > 0 && d_in % kChunk == 0 &&
                             d_out % kChunk == 0 && aligned
                         ? kBodyWgmma
                         : kBodyWmma;
  *body = chosen;
  const int n_blocks = tokens / tt;
  const int row_tiles = (tt + kMoeBM - 1) / kMoeBM;
  const int64_t grid_x = static_cast<int64_t>(n_blocks) * row_tiles;
  const int grid_y = (d_out + kMoeBN - 1) / kMoeBN;
  if (grid_x == 0) return static_cast<int>(cudaGetLastError());
  if (grid_x > 0x7fffffffLL || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const auto* be = static_cast<const int32_t*>(block_expert);
  if (chosen == kBodyWgmma) {
    return static_cast<int>(launch_moe_wgmma(x, w, be, out, tokens, d_in,
                                             d_out, n_experts, tt, device,
                                             s));
  }
  const dim3 grid(static_cast<unsigned>(grid_x), grid_y);
  if (chosen == kBodySimt) {
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
