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
// so the pace is set by B rows gathered from L2: one row a nonzero.
//
// What the design does about it: the paper's static split by rows, one
// warp per (batch, row, 128-column slice), coalesced row-major B loads and
// the fused epilogue at the single store of C.  Lanes load the row's slots
// 32 at a time (col, and the value gathered through slot_nz), prefetching
// the next 32 while the current ones are consumed; the warp broadcasts
// each slot with __shfl_sync and keeps kUnroll 16-byte B-row loads in
// flight before the FMAs (the bodies of spmm_common.cuh: f32x4, bf16x8
// with two half-warps on two slots, scalar).  An ELL row holds its live
// slots first (kernels/rowsplit_spmm.py ell_slots), so the first group of
// 32 with a dead slot is the row's last: the walk stops there and never
// reads the padding up to the longest row.  Slots whose slot_nz is the
// sentinel nnz_pad read a zero value instead of vals[nnz_pad] (which does
// not exist), exactly the TPU kernel's zero pad.
//
// A short, wide matrix gives too few rows to fill the card (Llama's w2:
// 2048 warps of 2048 slots each), so the wrapper may split each row's
// groups of 32 slots into `parts` contiguous parts (parts divides the 8
// warps of a block): the parts' warps share a block, sum their partials
// through shared memory in part order, and part 0 applies the epilogue and
// stores the row once.  No atomics, no zeroed scratch: the same inputs
// give the same bits on every call.
#include "spmm_common.cuh"

namespace repro {

// B-row loads each lane keeps in flight before its FMAs, and the blocks
// an SM holds (which caps the registers: 4 x 256 threads, 64 a thread).
// A group's steps run as a loop that is not unrolled: unrolled, ptxas
// hoisted the next steps' loads past the cap and spilled.  On the H100 at
// Llama-3.2-1B's FFN shapes this was the fastest of 4 or 8 loads, 2, 3 or
// 4 blocks an SM, 1, 2 or all 8 steps unrolled and a double-buffered
// loop; 8 loads at 3 blocks was faster on the power-law matrix (whose
// time its longest row sets) and slower on the Llama layer.
constexpr int kUnroll = 4;
constexpr int kRowsplitBlocksPerSm = 4;

template <int kBody, typename TV, typename TB, typename TO>
__global__ void __launch_bounds__(kBlock, kRowsplitBlocksPerSm)
rowsplit_kernel(const int32_t* __restrict__ cols,
                const int32_t* __restrict__ slot_nz,
                const TV* __restrict__ vals, const TB* __restrict__ b,
                Epilogue ep, TO* __restrict__ out, int batch, int m, int l,
                int nnz_pad, int k, int n, int n_slices, int parts) {
  using L = Layout<kBody>;
  static_assert(kWarp % (kUnroll * L::kSlots) == 0,
                "a group of 32 slots must be whole steps of kUnroll");
  __shared__ float partial[kWarpsPerBlock][kSliceCols];
  const int warp_in = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int part = warp_in % parts;
  const int64_t item = static_cast<int64_t>(blockIdx.x) *
                           (kWarpsPerBlock / parts) + warp_in / parts;
  // Warps past the last item still reach the block's barrier below.
  const bool active = item < static_cast<int64_t>(batch) * m * n_slices;
  const int slice = active ? static_cast<int>(item % n_slices) : 0;
  const int64_t batch_row = active ? item / n_slices : 0;
  const int row = static_cast<int>(batch_row % m);
  const int bb = static_cast<int>(batch_row / m);
  const int sub = lane / L::kLanes;  // which of the kSlots slots is ours
  const int c0 = L::first_col(slice, lane);

  const TB* bmat = b + static_cast<int64_t>(bb) * k * n;
  const int32_t* row_cols = cols + static_cast<int64_t>(row) * l;
  const int32_t* row_slots = slot_nz + static_cast<int64_t>(row) * l;

  float acc[L::kPer];
#pragma unroll
  for (int q = 0; q < L::kPer; ++q) acc[q] = 0.0f;

  // This part's groups of 32 slots: [g_begin, g_end).
  const int groups = (l + kWarp - 1) / kWarp;
  const int per_part = (groups + parts - 1) / parts;
  const int g_begin = part * per_part;
  const int g_end = active ? min(groups, g_begin + per_part) : g_begin;

  // This lane's slot of group g: fetched while the current group is
  // consumed, its value gathered at the current group's end.
  auto fetch = [&](int g, int& slot, int& col) {
    const int s = g * kWarp + lane;
    slot = nnz_pad;
    col = 0;
    if (g < g_end && s < l) {
      slot = row_slots[s];
      col = row_cols[s];
    }
  };
  auto gather = [&](int slot) {
    return slot < nnz_pad ? to_f32(vals[slot]) : 0.0f;
  };
  // kUnroll steps of kSlots slots from slot j0 of the group: the B rows'
  // loads go out before the FMAs (a dead slot loads nothing and adds
  // 0 * 0).
  auto steps = [&](int j0, unsigned live, int col, float v) {
    BRaw<kBody, TB> braw[kUnroll];
    float vj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int src = j0 + u * L::kSlots + sub;
      const int cj = __shfl_sync(kFull, col, src);
      if ((live >> src) & 1u) {
        braw[u].load(bmat + static_cast<int64_t>(cj) * n, c0, n);
      } else {
        braw[u].clear();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vj[u] = __shfl_sync(kFull, v, j0 + u * L::kSlots + sub);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) braw[u].accumulate(vj[u], acc);
  };

  int slot, col;
  fetch(g_begin, slot, col);
  float v = gather(slot);
  for (int g = g_begin; g < g_end; ++g) {  // uniform over the warp
    const unsigned live = __ballot_sync(kFull, slot < nnz_pad);
    if (live == 0) break;  // the row ended at the previous group
    const int cur_col = col;
    const float cur_v = v;
    fetch(g + 1, slot, col);
    if (live == kFull) {
      // Its own branch, so that no load or FMA of a full group (most of
      // them where rows are long) waits on a mask.
#pragma unroll 1
      for (int j0 = 0; j0 < kWarp; j0 += kUnroll * L::kSlots) {
        steps(j0, kFull, cur_col, cur_v);
      }
    } else {
      // The row's last group: up to its last live slot.
      const int hi = kWarp - __clz(live);
#pragma unroll 1
      for (int j0 = 0; j0 < hi; j0 += kUnroll * L::kSlots) {
        steps(j0, live, cur_col, cur_v);
      }
      break;
    }
    v = gather(slot);
  }
  if constexpr (L::kSlots == 2) {  // the half-warps' partials
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) {
      acc[q] += __shfl_xor_sync(kFull, acc[q], L::kLanes);
    }
  }

  if (parts > 1) {  // uniform over the block
    const int off = L::first_col(0, lane);
    if (part > 0 && sub == 0) {
#pragma unroll
      for (int q = 0; q < L::kPer; ++q) {
        partial[warp_in][off + q * L::kStride] = acc[q];
      }
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < parts; ++p) {
#pragma unroll
      for (int q = 0; q < L::kPer; ++q) {
        acc[q] += partial[warp_in + p][off + q * L::kStride];
      }
    }
  }
  if (active && sub == 0) {
    store_row<kBody>(out, acc, ep, row,
                     (static_cast<int64_t>(bb) * m + row) * n, c0, n);
  }
}

}  // namespace repro

// C entry: out (batch, m, n) = epilogue(A @ b) for the ELL structure
// cols/slot_nz (m_pad >= m rows of l slots, each row's live slots first),
// vals (nnz_pad,), b (batch, k, n) row-major, each row's slot groups split
// in `parts` (1, 2, 4 or 8) contiguous parts.  Picks the body (f32x4 for
// float32 b with n % 4 == 0, bf16x8 for bfloat16 b with n % 8 == 0, each
// with 16-byte aligned b, out and residual; scalar otherwise), reports it
// in *body, launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown dtype code or
// parts).
extern "C" int repro_rowsplit_spmm(
    const void* cols, const void* slot_nz, const void* vals, int vals_dtype,
    const void* b, int b_dtype, const void* bias, const void* residual,
    int act, int has_scale, float scale, void* out, int out_dtype,
    int batch, int m, int l, int nnz_pad, int k, int n, int parts,
    int device, void* stream, int* body) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(vals_dtype) || !known_dtype(b_dtype) ||
      !known_dtype(out_dtype) || parts <= 0 ||
      kWarpsPerBlock % parts != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slices = (n + kSliceCols - 1) / kSliceCols;
  const int64_t warps = static_cast<int64_t>(batch) * m * n_slices * parts;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec_ok = aligned16(b) && aligned16(out) &&
                      (residual == nullptr || aligned16(residual));
  const int code = pick_body(b_dtype, n, vec_ok);
  *body = code;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(bias),
                    static_cast<const float*>(residual), act, has_scale,
                    scale};
  auto s = static_cast<cudaStream_t>(stream);
  with_body(code, [&](auto body_tag) {
    constexpr int kBody = decltype(body_tag)::value;
    with_dtype(vals_dtype, [&](auto tv) {
      using TV = decltype(tv);
      with_dtype(b_dtype, [&](auto tb) {
        using TB = decltype(tb);
        with_dtype(out_dtype, [&](auto to) {
          using TO = decltype(to);
          if constexpr (body_reads<kBody, TB>()) {
            rowsplit_kernel<kBody, TV, TB, TO>
                <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
                    static_cast<const int32_t*>(cols),
                    static_cast<const int32_t*>(slot_nz),
                    static_cast<const TV*>(vals), static_cast<const TB*>(b),
                    ep, static_cast<TO*>(out), batch, m, l, nnz_pad, k, n,
                    n_slices, parts);
          }
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
