// Row-split SpMM (paper §4.1) for Hopper (sm_90a): C = A @ B over the
// ELL slot layout that kernels/rowsplit_spmm.py plans, with the fused
// epilogue act(C + bias) * scale + residual.
//
// Replaces: src/repro/kernels/rowsplit_spmm.py, _rowsplit_kernel /
// rowsplit_spmm_pallas (the TPU kernel).
//
// What bounds it on this card: memory.  Every stored nonzero is one
// (col, slot, value) triple read once from device memory (12 bytes in
// f32) and feeds n multiply-adds against one B row, so at the tall-skinny
// n <= 160 of the serving path the kernel is far below the H100's
// operations-per-byte balance.  B itself (k x n) and C fit the 50 MB L2,
// so the compulsory traffic is the plan arrays and the values.
//
// What the design does about it: one warp per (batch, row, 128-column
// slice), as in the paper.  Each lane loads one ELL slot of a group of
// 32 (coalesced loads of the plan arrays, the value gathered through
// slot_nz) and the warp broadcasts each (col, value) with __shfl_sync, so
// the plan arrays and values are read once per column slice; every B-row
// read is 32 neighbouring elements.  The accumulator stays in registers
// (4 floats a lane) and the epilogue is applied on it before the single
// store, so C is written once.  Slots whose slot_nz is the sentinel
// nnz_pad read a zero value instead of vals[nnz_pad] (which does not
// exist), exactly the TPU kernel's zero pad.  Later work: stage B rows
// through shared memory, vectorise the loads, cover several rows a warp.
#include "spmm_common.cuh"

namespace repro {

template <typename TV, typename TB, typename TO>
__global__ void __launch_bounds__(kBlock)
rowsplit_kernel(const int32_t* __restrict__ cols,
                const int32_t* __restrict__ slot_nz,
                const TV* __restrict__ vals, const TB* __restrict__ b,
                Epilogue ep, TO* __restrict__ out, int batch, int m, int l,
                int nnz_pad, int k, int n, int n_slices) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= static_cast<int64_t>(batch) * m * n_slices) return;  // uniform
  const int slice = static_cast<int>(warp % n_slices);
  const int64_t batch_row = warp / n_slices;
  const int row = static_cast<int>(batch_row % m);
  const int bb = static_cast<int>(batch_row / m);
  const int c0 = slice * kSliceCols + lane;

  const TB* bmat = b + static_cast<int64_t>(bb) * k * n;
  const int32_t* row_cols = cols + static_cast<int64_t>(row) * l;
  const int32_t* row_slots = slot_nz + static_cast<int64_t>(row) * l;

  float acc[kColsPerLane];
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.0f;

  for (int s0 = 0; s0 < l; s0 += kWarp) {
    const int s = s0 + lane;
    int col = 0;
    float v = 0.0f;
    bool live = false;
    if (s < l) {
      const int slot = row_slots[s];
      if (slot < nnz_pad) {  // the sentinel nnz_pad reads a zero
        live = true;
        col = row_cols[s];
        v = to_f32(vals[slot]);
      }
    }
    const unsigned live_mask = __ballot_sync(kFull, live);
    // Up to the last live slot of the group; a dead slot before it adds
    // 0 * B[0, c], as the TPU kernel's zero pad does.
    const int hi = live_mask ? kWarp - __clz(live_mask) : 0;
#pragma unroll 4
    for (int j = 0; j < hi; ++j) {
      const int cj = __shfl_sync(kFull, col, j);
      const float vj = __shfl_sync(kFull, v, j);
      const TB* brow = bmat + static_cast<int64_t>(cj) * n;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int c = c0 + q * kWarp;
        if (c < n) acc[q] = fmaf(vj, to_f32(brow[c]), acc[q]);
      }
    }
  }

  const int64_t obase = (static_cast<int64_t>(bb) * m + row) * n;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int c = c0 + q * kWarp;
    if (c < n) {
      out[obase + c] = from_f32<TO>(apply_epilogue(acc[q], ep, row,
                                                   obase + c));
    }
  }
}

}  // namespace repro

// C entry: out (batch, m, n) = epilogue(A @ b) for the ELL structure
// cols/slot_nz (m_pad >= m rows of l slots), vals (nnz_pad,), b
// (batch, k, n) row-major.  Launches on `stream` without synchronising
// and returns cudaGetLastError() (cudaErrorInvalidValue for an unknown
// dtype code).
extern "C" int repro_rowsplit_spmm(
    const void* cols, const void* slot_nz, const void* vals, int vals_dtype,
    const void* b, int b_dtype, const void* bias, const void* residual,
    int act, int has_scale, float scale, void* out, int out_dtype,
    int batch, int m, int l, int nnz_pad, int k, int n, int device,
    void* stream) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (n + kSliceCols - 1) / kSliceCols;
  const int64_t warps = static_cast<int64_t>(batch) * m * n_slices;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(bias),
                    static_cast<const float*>(residual), act, has_scale,
                    scale};
  if (!known_dtype(vals_dtype) || !known_dtype(b_dtype) ||
      !known_dtype(out_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  with_dtype(vals_dtype, [&](auto tv) {
    using TV = decltype(tv);
    with_dtype(b_dtype, [&](auto tb) {
      using TB = decltype(tb);
      with_dtype(out_dtype, [&](auto to) {
        using TO = decltype(to);
        rowsplit_kernel<TV, TB, TO>
            <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
                static_cast<const int32_t*>(cols),
                static_cast<const int32_t*>(slot_nz),
                static_cast<const TV*>(vals), static_cast<const TB*>(b), ep,
                static_cast<TO*>(out), batch, m, l, nnz_pad, k, n,
                n_slices);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
