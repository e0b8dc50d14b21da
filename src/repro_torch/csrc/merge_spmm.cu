// Merge-based SpMM (paper §4.2) for Hopper (sm_90a): C = A @ B over the
// equal-nonzero chunk structure that kernels/merge_spmm.py plans (T
// nonzeros a chunk, chunks broken at 8-row tiles), with the fused
// epilogue act(C + bias) * scale + residual.
//
// Replaces: src/repro/kernels/merge_spmm.py, _merge_kernel /
// merge_spmm_pallas (the TPU kernel).
//
// What bounds it on this card: memory.  Each nonzero costs its chunk slot
// (col, lrow, slot_nz: 12 bytes) plus its value, and feeds n
// multiply-adds against one B row; at the serving path's n <= 160 that is
// far below the H100's operations-per-byte balance, and B (k x n) and C
// fit the 50 MB L2.
//
// What the design does about it.  The TPU kernel zeroes a C tile on a
// chunk marked `first` and flushes it on `last`, which is only right
// because Pallas runs grid steps in order on one core; CUDA blocks run
// concurrently, so that scheme would race.  Here one warp owns one
// (batch, chunk, 128-column slice): lane s < T loads slot s of the chunk
// (coalesced), the warp broadcasts each (col, value, row) with
// __shfl_sync, and the lanes accumulate the chunk's current row in
// registers (4 floats a lane, every B-row read 32 neighbouring elements).
// When the row changes -- rows ascend within a chunk -- the partial row is
// added into a zeroed float32 scratch C with atomicAdd: the carry-out of
// the paper's fix-up, done with atomics.  A second, elementwise launch
// then applies the epilogue to every row of the scratch and casts once,
// so rows with no nonzero still get epilogue(0) and the epilogue sees
// only complete sums.  The atomics make the order of the float32 sums
// vary from run to run (tolerance stated in chip_smoke.py).  Later work:
// the paper's carry-out fix-up without atomics, and B rows staged in
// shared memory.
#include "spmm_common.cuh"

namespace repro {

template <typename TV, typename TB>
__global__ void __launch_bounds__(kBlock)
merge_kernel(const int32_t* __restrict__ cols,
             const int32_t* __restrict__ lrow,
             const int32_t* __restrict__ slot_nz,
             const int32_t* __restrict__ tile, const TV* __restrict__ vals,
             const TB* __restrict__ b, float* __restrict__ scratch,
             int batch, int n_chunks, int t, int tm, int nnz_pad, int m,
             int k, int n, int n_slices) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= static_cast<int64_t>(batch) * n_chunks * n_slices) return;
  const int slice = static_cast<int>(warp % n_slices);
  const int64_t batch_chunk = warp / n_slices;
  const int chunk = static_cast<int>(batch_chunk % n_chunks);
  const int bb = static_cast<int>(batch_chunk / n_chunks);
  const int c0 = slice * kSliceCols + lane;

  int col = 0, row = 0;
  float v = 0.0f;
  bool live = false;
  if (lane < t) {
    const int64_t s = static_cast<int64_t>(chunk) * t + lane;
    const int slot = slot_nz[s];
    if (slot < nnz_pad) {  // the sentinel nnz_pad contributes nothing
      live = true;
      col = cols[s];
      row = lrow[s];
      v = to_f32(vals[slot]);
    }
  }
  unsigned live_mask = __ballot_sync(kFull, live);
  if (live_mask == 0) return;  // uniform: an empty chunk adds nothing

  const TB* bmat = b + static_cast<int64_t>(bb) * k * n;
  const int64_t row0 = static_cast<int64_t>(bb) * m +
                       static_cast<int64_t>(tile[chunk]) * tm;
  float acc[kColsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cur = -1;
  while (live_mask) {
    const int j = __ffs(live_mask) - 1;
    live_mask &= live_mask - 1;
    const int cj = __shfl_sync(kFull, col, j);
    const float vj = __shfl_sync(kFull, v, j);
    const int rj = __shfl_sync(kFull, row, j);
    if (rj != cur) {  // uniform: carry the finished row out
      if (cur >= 0) {
        float* dst = scratch + (row0 + cur) * n;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const int c = c0 + q * kWarp;
          if (c < n) atomicAdd(dst + c, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.0f;
      cur = rj;
    }
    const TB* brow = bmat + static_cast<int64_t>(cj) * n;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int c = c0 + q * kWarp;
      if (c < n) acc[q] = fmaf(vj, to_f32(brow[c]), acc[q]);
    }
  }
  float* dst = scratch + (row0 + cur) * n;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int c = c0 + q * kWarp;
    if (c < n) atomicAdd(dst + c, acc[q]);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kBlock)
epilogue_kernel(const float* __restrict__ scratch, Epilogue ep,
                TO* __restrict__ out, int64_t total, int m, int n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t row = (i / n) % m;
    out[i] = from_f32<TO>(apply_epilogue(scratch[i], ep, row, i));
  }
}

}  // namespace repro

// C entry, phase 1: scratch (batch, m, n) float32, zeroed by the caller,
// += A @ b for the chunk structure cols/lrow/slot_nz (n_chunks, t) and
// tile (n_chunks,), vals (nnz_pad,), b (batch, k, n) row-major.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int repro_merge_spmm(
    const void* cols, const void* lrow, const void* slot_nz,
    const void* tile, const void* vals, int vals_dtype, const void* b,
    int b_dtype, void* scratch, int batch, int n_chunks, int t, int tm,
    int nnz_pad, int m, int k, int n, int device, void* stream) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t > kWarp || !known_dtype(vals_dtype) || !known_dtype(b_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slices = (n + kSliceCols - 1) / kSliceCols;
  const int64_t warps = static_cast<int64_t>(batch) * n_chunks * n_slices;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  with_dtype(vals_dtype, [&](auto tv) {
    using TV = decltype(tv);
    with_dtype(b_dtype, [&](auto tb) {
      using TB = decltype(tb);
      merge_kernel<TV, TB><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
          static_cast<const int32_t*>(cols), static_cast<const int32_t*>(lrow),
          static_cast<const int32_t*>(slot_nz),
          static_cast<const int32_t*>(tile), static_cast<const TV*>(vals),
          static_cast<const TB*>(b), static_cast<float*>(scratch), batch,
          n_chunks, t, tm, nnz_pad, m, k, n, n_slices);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// C entry, phase 2: out (batch, m, n) = epilogue(scratch), cast once to
// the output dtype.
extern "C" int repro_merge_epilogue(const void* scratch, const void* bias,
                                    const void* residual, int act,
                                    int has_scale, float scale, void* out,
                                    int out_dtype, int batch, int m, int n,
                                    int device, void* stream) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(out_dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(batch) * m * n;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int64_t want = (total + kBlock - 1) / kBlock;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  const Epilogue ep{static_cast<const float*>(bias),
                    static_cast<const float*>(residual), act, has_scale,
                    scale};
  auto s = static_cast<cudaStream_t>(stream);
  with_dtype(out_dtype, [&](auto to) {
    using TO = decltype(to);
    epilogue_kernel<TO><<<blocks, kBlock, 0, s>>>(
        static_cast<const float*>(scratch), ep, static_cast<TO*>(out), total,
        m, n);
  });
  return static_cast<int>(cudaGetLastError());
}
