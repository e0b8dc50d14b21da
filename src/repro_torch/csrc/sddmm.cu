// Sampled dense-dense matmul (SDDMM) for Hopper (sm_90a): the values
// cotangent of C = A @ B,
//   out[bb, p] = sum_n dc[bb, rows[p], n] * b[bb, cols[p], n]
// for every nonzero slot p of the pattern, per batch element, in float32,
// and 0 in every padded slot (valid[p] == 0).
//
// Replaces: src/repro/kernels/sddmm.py, _sddmm_kernel / sddmm_pallas (the
// TPU kernel).
//
// What bounds it on this card: operations.  The function reads the CSR's
// column indices and row pointers, dc (m x n) and b (k x n) once and
// writes one float per nonzero; at the training path's n = 128 that is
// ~39 MB a Llama-3.2-1B FFN matrix (0.0116 ms at 3.35 TB/s) against
// 2 * nnz * n = 1.07 GFLOP (0.0160 ms at 67 TFLOP/s f32).  What the kernel
// moves is more: every nonzero gathers one b row (n values) from L2, so
// the L2 traffic is nnz * n * 4 bytes (2.1 GB a matrix at n = 128).
//
// What the design does about it.  The TPU kernel chunks the nonzeros 128
// at a time and pads n to 128 lanes, with the reduction over n as a
// sequential grid axis.  Here one warp owns (batch element, a run of 32
// consecutive nonzeros): lane j loads nonzero j's (row, col, valid)
// (coalesced), then the warp walks the run's live nonzeros, broadcasting
// each one's coordinates with __shfl_sync.  Lane l reads columns
// c0 + l + 32q (q < 4) of the dc row and the b row -- both row-major, so
// every load is 32 neighbouring elements -- multiplies in float32, and the
// warp reduces with __shfl_xor_sync; lane j keeps the sum.  Nonzeros of one
// CSR row are consecutive and share their dc row, so the warp keeps the dc
// slice in registers until the row changes: a run inside one row reads its
// dc row once.  n above 128 runs as a loop over 128-column slices; the
// ragged edge is masked, so n needs no padding.  Padded slots are skipped
// and written as 0.  The sum order is fixed, so results do not vary from
// run to run.  Later work: staging b rows in shared memory for reuse across
// runs that share columns, and 16-byte loads.
#include "spmm_common.cuh"

namespace repro {

// Nonzeros a warp owns: one per lane.
constexpr int kRun = kWarp;

template <typename TD, typename TB>
__global__ void __launch_bounds__(kBlock)
sddmm_kernel(const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols,
             const uint8_t* __restrict__ valid, const TD* __restrict__ dc,
             const TB* __restrict__ b, float* __restrict__ out, int batch,
             int nnz_pad, int m, int k, int n, int n_runs) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= static_cast<int64_t>(batch) * n_runs) return;  // whole warps
  const int run = static_cast<int>(warp % n_runs);
  const int bb = static_cast<int>(warp / n_runs);
  const int64_t p = static_cast<int64_t>(run) * kRun + lane;

  int row = 0, col = 0;
  bool live = false;
  if (p < nnz_pad && valid[p] != 0) {
    live = true;
    row = rows[p];
    col = cols[p];
  }
  const unsigned live_mask = __ballot_sync(kFull, live);

  const TD* dmat = dc + static_cast<int64_t>(bb) * m * n;
  const TB* bmat = b + static_cast<int64_t>(bb) * k * n;
  float acc = 0.0f;
  for (int s0 = 0; s0 < n; s0 += kSliceCols) {  // uniform over the warp
    float d[kColsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
    int cur = -1;
    unsigned mask = live_mask;
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int rj = __shfl_sync(kFull, row, j);
      const int cj = __shfl_sync(kFull, col, j);
      if (rj != cur) {  // uniform: load the new row's dc slice
        const TD* drow = dmat + static_cast<int64_t>(rj) * n;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const int c = s0 + lane + q * kWarp;
          d[q] = c < n ? to_f32(drow[c]) : 0.0f;
        }
        cur = rj;
      }
      const TB* brow = bmat + static_cast<int64_t>(cj) * n;
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int c = s0 + lane + q * kWarp;
        if (c < n) part = fmaf(d[q], to_f32(brow[c]), part);
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(kFull, part, off);
      }
      if (lane == j) acc += part;
    }
  }
  if (p < nnz_pad) {
    out[static_cast<int64_t>(bb) * nnz_pad + p] = live ? acc : 0.0f;
  }
}

}  // namespace repro

// C entry: out (batch, nnz_pad) float32 = the sampled dots of dc
// (batch, m, n) and b (batch, k, n), both row-major, at the nonzero
// coordinates rows/cols (nnz_pad,) int32, 0 where valid (nnz_pad,) uint8
// is 0.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int repro_sddmm(const void* rows, const void* cols,
                           const void* valid, const void* dc, int dc_dtype,
                           const void* b, int b_dtype, void* out, int batch,
                           int nnz_pad, int m, int k, int n, int device,
                           void* stream) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dc_dtype) || !known_dtype(b_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_runs = (nnz_pad + kRun - 1) / kRun;
  const int64_t warps = static_cast<int64_t>(batch) * n_runs;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  with_dtype(dc_dtype, [&](auto td) {
    using TD = decltype(td);
    with_dtype(b_dtype, [&](auto tb) {
      using TB = decltype(tb);
      sddmm_kernel<TD, TB><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
          static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
          static_cast<const uint8_t*>(valid), static_cast<const TD*>(dc),
          static_cast<const TB*>(b), static_cast<float*>(out), batch, nnz_pad,
          m, k, n, n_runs);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
