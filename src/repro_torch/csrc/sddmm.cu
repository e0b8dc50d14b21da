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
// sequential grid axis.  Here one warp walks g consecutive groups of 32
// nonzeros (a worker; g from the wrapper, about one wave of warps), the
// next group's (row, col, valid) loaded while the current one is summed.
// Lanes own columns of a 128-column slice as the SpMM bodies do
// (spmm_common.cuh: f32x4 and bf16x8 with one 16-byte load a row, scalar
// otherwise); a lane keeps the dc slice of the current CSR row in
// registers, reloading it only when the row changes, and makes one b-row
// load a nonzero, kSddmmUnroll of them in flight.  Each lane's partial of
// each nonzero of the group (32, or 16 a half-warp in bf16x8, whose two
// half-warps take the group's two halves) goes to a 32 x 33 float tile
// of shared memory as it is computed, and one transposed reduction a
// group reads it back by columns: lane j sums nonzero j's partials, lane
// by lane in order, and stores its dot (one coalesced store a group).
// Kept in registers, the 32 partials would leave too few for the loads in
// flight: a shuffle butterfly over them spilled at the register cap, or
// ran slower with half the loads in flight.  The group's columns go
// through shared memory too (one broadcast read for four), its rows by
// one ballot a run of equal rows; a group that lies in one row and is
// all live (the common case) runs without masks.  n above 128 runs as a
// loop over 128-column slices whose sums are added in slice order; the
// ragged edge is masked, so n needs no padding.  Padded slots load
// nothing and are written as 0.  The sum order is fixed, so results do not
// vary from call to call.
#include "spmm_common.cuh"

namespace repro {

// b-row loads each lane keeps in flight, and the blocks an SM holds (which
// caps the registers: 2 x 256 threads, 128 a thread; each block takes
// 34 KB of shared memory for its warps' partials).
constexpr int kSddmmUnroll = 16;
constexpr int kSddmmBlocksPerSm = 2;

// One lane's dot of dc (d, as floats) and a loaded b row, over its kPer
// columns of the slice.
template <int kPer, typename Raw>
__device__ __forceinline__ float dot_row(const Raw& braw, const float* d) {
  float x[kPer];
  braw.unpack(x);
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kPer; ++q) s = fmaf(d[q], x[q], s);
  return s;
}

// A lane's partials, for the slice at c0, of the nonzeros i of its half of
// the group (columns cols[i]) with bit i of `ours` set, into red[i] (its
// row of the warp's tile): one b-row load each, kSddmmUnroll in flight.
// kWhole: every bit is set (the group lies in one row and is all live),
// so no load or FMA waits on a mask.
template <bool kWhole, int kBody, typename TB, int kNz>
__device__ __forceinline__ void sum_run(unsigned ours, const int32_t* cols,
                                        const TB* __restrict__ bmat, int n,
                                        int c0, const float* d,
                                        float* red) {
#pragma unroll
  for (int i0 = 0; i0 < kNz; i0 += kSddmmUnroll) {
    int cj[kSddmmUnroll];
#pragma unroll
    for (int u = 0; u < kSddmmUnroll; u += 4) {
      const int4 c4 = *reinterpret_cast<const int4*>(cols + i0 + u);
      cj[u] = c4.x;
      cj[u + 1] = c4.y;
      cj[u + 2] = c4.z;
      cj[u + 3] = c4.w;
    }
    BRaw<kBody, TB> braw[kSddmmUnroll];
#pragma unroll
    for (int u = 0; u < kSddmmUnroll; ++u) {
      if (kWhole || ((ours >> (i0 + u)) & 1u)) {
        braw[u].load(bmat + static_cast<int64_t>(cj[u]) * n, c0, n);
      }
    }
#pragma unroll
    for (int u = 0; u < kSddmmUnroll; ++u) {
      if (kWhole || ((ours >> (i0 + u)) & 1u)) {
        red[i0 + u] = dot_row<Layout<kBody>::kPer>(braw[u], d);
      }
    }
  }
}

template <int kBody, typename TD, typename TB>
__global__ void __launch_bounds__(kBlock, kSddmmBlocksPerSm)
sddmm_kernel(const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols,
             const uint8_t* __restrict__ valid, const TD* __restrict__ dc,
             const TB* __restrict__ b, float* __restrict__ out, int batch,
             int nnz_pad, int m, int k, int n, int g, int workers) {
  using L = Layout<kBody>;
  constexpr int kNz = kWarp / L::kSlots;  // nonzeros a lane sums a group
  static_assert(kNz % kSddmmUnroll == 0 && kSddmmUnroll % 4 == 0,
                "a lane's nonzeros must be whole steps of kSddmmUnroll");
  __shared__ __align__(16) int32_t group_cols[kWarpsPerBlock][kWarp];
  // Lane l's partial of its half's nonzero i at [l][i]; the padding
  // column keeps both the row writes and the column reads free of bank
  // conflicts.
  __shared__ float red_all[kWarpsPerBlock][kWarp][kWarp + 1];
  const int warp_in = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp_in;
  if (warp >= static_cast<int64_t>(batch) * workers) return;  // whole warps
  const int w = static_cast<int>(warp % workers);
  const int bb = static_cast<int>(warp / workers);
  const int sub = lane / L::kLanes;  // which half of the group is ours
  const int n_groups = (nnz_pad + kWarp - 1) / kWarp;
  const int n_slices = (n + kSliceCols - 1) / kSliceCols;
  const int g_begin = w * g;
  const int g_end = min(n_groups, g_begin + g);

  const TD* dmat = dc + static_cast<int64_t>(bb) * m * n;
  const TB* bmat = b + static_cast<int64_t>(bb) * k * n;
  float* obatch = out + static_cast<int64_t>(bb) * nnz_pad;
  const int32_t* mine = group_cols[warp_in] + sub * kNz;

  // The dc slice of row cur_row, slice cur_slice, as floats.
  float d[L::kPer];
  int cur_row = -1, cur_slice = -1;

  auto fetch = [&](int grp, int& row, int& col, bool& live) {
    const int64_t p = static_cast<int64_t>(grp) * kWarp + lane;
    row = col = 0;
    live = false;
    if (grp < g_end && p < nnz_pad) {
      live = valid[p] != 0;
      row = rows[p];
      col = cols[p];
    }
  };

  int next_row, next_col;
  bool next_live;
  fetch(g_begin, next_row, next_col, next_live);
  for (int grp = g_begin; grp < g_end; ++grp) {
    const int row = next_row;
    const int col = next_col;
    const bool live = next_live;
    fetch(grp + 1, next_row, next_col, next_live);
    const unsigned live_mask = __ballot_sync(kFull, live);
    float total = 0.0f;
    if (live_mask != 0) {  // uniform
      __syncwarp();        // the previous group's columns are read
      group_cols[warp_in][lane] = col;
      __syncwarp();
      for (int slice = 0; slice < n_slices; ++slice) {
        const int c0 = L::first_col(slice, lane);
        float* red = red_all[warp_in][lane];
        bool zeroed = false;  // a masked run writes only its partials
        // Runs of equal rows (CSR order), one pass each: usually one run
        // of all 32 nonzeros.
        unsigned rest = live_mask;
        while (rest != 0) {
          const int run_row = __shfl_sync(kFull, row, __ffs(rest) - 1);
          const unsigned run = __ballot_sync(kFull, live && row == run_row);
          rest &= ~run;
          if (run_row != cur_row || slice != cur_slice) {  // uniform
            BRaw<kBody, TD> draw;
            draw.load(dmat + static_cast<int64_t>(run_row) * n, c0, n);
            draw.unpack(d);
            cur_row = run_row;
            cur_slice = slice;
          }
          if (run == kFull) {  // uniform
            sum_run<true, kBody, TB, kNz>(kFull, mine, bmat, n, c0, d, red);
          } else {
            if (!zeroed) {
#pragma unroll
              for (int i = 0; i < kNz; ++i) red[i] = 0.0f;
              zeroed = true;
            }
            sum_run<false, kBody, TB, kNz>(run >> (sub * kNz), mine, bmat, n,
                                           c0, d, red);
          }
        }
        // The transposed reduction: lane j sums column j % kLanes over the
        // lanes of its half, in lane order.
        __syncwarp();
        float s = 0.0f;
#pragma unroll 8
        for (int l = 0; l < L::kLanes; ++l) {
          s += red_all[warp_in][sub * L::kLanes + l][lane % L::kLanes];
        }
        total += s;
        __syncwarp();  // read before the next slice or group writes
      }
    }
    const int64_t p = static_cast<int64_t>(grp) * kWarp + lane;
    if (p < nnz_pad) obatch[p] = live ? total : 0.0f;
  }
}

}  // namespace repro

// C entry: out (batch, nnz_pad) float32 = the sampled dots of dc
// (batch, m, n) and b (batch, k, n), both row-major, at the nonzero
// coordinates rows/cols (nnz_pad,) int32, 0 where valid (nnz_pad,) uint8
// is 0; g groups of 32 nonzeros a warp.  Picks the body (f32x4 for
// float32 dc and b with n % 4 == 0, bf16x8 for bfloat16 dc and b with n %
// 8 == 0, each with 16-byte aligned dc and b; scalar otherwise), reports
// it in *body, launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int repro_sddmm(const void* rows, const void* cols,
                           const void* valid, const void* dc, int dc_dtype,
                           const void* b, int b_dtype, void* out, int batch,
                           int nnz_pad, int m, int k, int n, int g,
                           int device, void* stream, int* body) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dc_dtype) || !known_dtype(b_dtype) || g <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = aligned16(dc) && aligned16(b) && dc_dtype == b_dtype;
  const int code = pick_body(b_dtype, n, vec_ok);
  *body = code;
  const int64_t n_groups = (static_cast<int64_t>(nnz_pad) + kWarp - 1) /
                           kWarp;
  const int64_t workers = (n_groups + g - 1) / g;
  const int64_t warps = static_cast<int64_t>(batch) * workers;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  with_body(code, [&](auto body_tag) {
    constexpr int kBody = decltype(body_tag)::value;
    with_dtype(dc_dtype, [&](auto td) {
      using TD = decltype(td);
      with_dtype(b_dtype, [&](auto tb) {
        using TB = decltype(tb);
        if constexpr (body_reads<kBody, TD>() && body_reads<kBody, TB>()) {
          sddmm_kernel<kBody, TD, TB>
              <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
                  static_cast<const int32_t*>(rows),
                  static_cast<const int32_t*>(cols),
                  static_cast<const uint8_t*>(valid),
                  static_cast<const TD*>(dc), static_cast<const TB*>(b),
                  static_cast<float*>(out), batch, nnz_pad, m, k, n, g,
                  static_cast<int>(workers));
        }
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
