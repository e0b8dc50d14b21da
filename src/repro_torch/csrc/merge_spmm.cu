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
// fit the 50 MB L2, so the pace is set by B rows streamed from L2.
//
// What the design does about it: the paper's merge path, not the TPU's
// grid.  The chunk stream is CSR order with dead slots (slot_nz ==
// nnz_pad), so worker w -- one warp per (batch, range, 128-column slice)
// -- takes the G chunks [w G, (w + 1) G): the same number of slots, so
// the same nonzeros, for every worker.  Consecutive workers share exactly
// one row, the split row S_w (split_at below: the tile's first row where
// chunk (w + 1) G opens a tile, else the row of its first slot, or m - 1
// past the last live slot, where the workers hold nothing and return at
// once), so worker w owns the rows [S_{w-1}, S_w] with S_{-1} = 0 and
// S_{W-1} = m - 1.  Rows strictly inside that range,
// empty ones included, are complete: they are summed in registers, the
// epilogue is applied and they are stored once in the output dtype.  The
// two end rows are partial: the worker writes their float32 sums (zero
// where it holds none of the row) to a carry buffer of 2 x W rows a batch
// and column slice, every slot of which is written, so nothing is zeroed.
// A second launch, the fix-up, sums each split row's partials in worker
// order, applies the epilogue and stores the row.  No atomics: the same
// inputs give bit-identical outputs on every call.
//
// Inside a range: lanes load 32 slots at a time (col, row = tile * 8 +
// lrow, the value gathered through slot_nz), prefetching the next 32 while
// the current ones are consumed; the warp broadcasts each slot with
// __shfl_sync and keeps kUnroll B-row loads in flight before the FMAs.  A
// group whose live slots all lie in the current row (most groups, where
// rows are long) skips the row checks; a group where a row ends goes slot
// by slot.
// Three bodies (enum SpmmBody and Layout/BRaw in spmm_common.cuh): f32x4,
// bf16x8 -- two half-warps take two slots at once and their partials are
// merged by one shuffle when a row ends -- and scalar.
#include "spmm_common.cuh"

namespace repro {

// B-row loads each lane keeps in flight before its FMAs, and the blocks
// of the range kernel an SM holds: 4 x 256 threads cap it at 64
// registers.  Uncapped, ptxas hoists every load of a group into
// registers and the SM holds one block; on the H100 the capped kernel
// was the faster at every shape timed.
constexpr int kUnroll = 4;
constexpr int kRangeBlocksPerSm = 4;

// The structure and shapes both launches read.
struct MergeArgs {
  const int32_t* cols;
  const int32_t* lrow;
  const int32_t* slot_nz;
  const int32_t* tile;
  const int32_t* first;
  int batch, n_chunks, t, tm, nnz_pad, m, k, n;
  int g;        // chunks a worker
  int workers;  // ceil(n_chunks / g)
  int n_slices;
};

// S_j, the row that workers j and j + 1 share (S_{-1} = 0, S_{W-1} =
// m - 1; non-decreasing in j).  Chunk c = (j + 1) g opens worker j + 1:
// if it opens a tile, every slot before it lies in earlier tiles and every
// slot from it on in this tile or later, so the tile's first row splits
// them; a chunk inside a tile holds a live slot 0 (a tile's chunks are
// full but its last), whose row splits them; otherwise c lies past the
// last live slot (the pad and unused tail chunks) and nothing follows.
// past_end: worker j + 1 opens past the last live slot, so it and every
// later worker hold no nonzero (their partials are 0 and nobody reads
// them).
struct Split {
  int row;
  bool past_end;
};

__device__ __forceinline__ Split split_at(const MergeArgs& a, int j) {
  if (j < 0) return {0, false};
  if (j >= a.workers - 1) return {a.m - 1, false};
  const int64_t c = static_cast<int64_t>(j + 1) * a.g;
  const int64_t s = c * a.t;
  const int tl = a.tile[c];
  const int opens = a.first[c];
  const int slot = a.slot_nz[s];
  const int lr = a.lrow[s];
  if (opens) return {tl * a.tm, false};
  if (slot < a.nnz_pad) return {tl * a.tm + lr, false};
  return {a.m - 1, true};
}

// A lane's float32 partial of a split row into its carry row.
template <int kBody>
__device__ __forceinline__ void store_carry(float* dst, const float* acc,
                                            int c0, int n) {
  using L = Layout<kBody>;
  if constexpr (kBody == kBodyScalar) {
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) {
      if (c0 + q * kWarp < n) dst[c0 + q * kWarp] = acc[q];
    }
  } else {
    if (c0 < n) store_vec<float, L::kPer>(dst + c0, acc);
  }
}

template <int kBody, typename TV, typename TB, typename TO>
__global__ void __launch_bounds__(kBlock, kRangeBlocksPerSm)
merge_range_kernel(MergeArgs a, const TV* __restrict__ vals,
                   const TB* __restrict__ b, Epilogue ep,
                   TO* __restrict__ out, float* __restrict__ carry) {
  using L = Layout<kBody>;
  static_assert(kWarp % (kUnroll * L::kSlots) == 0,
                "a group of 32 slots must be whole steps of kUnroll");
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (warp >= static_cast<int64_t>(a.batch) * a.workers * a.n_slices) {
    return;  // uniform
  }
  const int slice = static_cast<int>(warp % a.n_slices);
  const int64_t batch_worker = warp / a.n_slices;
  const int w = static_cast<int>(batch_worker % a.workers);
  const int bb = static_cast<int>(batch_worker / a.workers);
  const int sub = lane / L::kLanes;  // which of the kSlots slots is ours
  const int c0 = L::first_col(slice, lane);
  const int n = a.n;

  const Split start = split_at(a, w - 1);
  if (start.past_end) return;  // uniform: nothing to add, nothing to write
  const int lo = start.row;
  const int hi = split_at(a, w).row;
  const TB* bmat = b + static_cast<int64_t>(bb) * a.k * n;
  const int64_t obatch = static_cast<int64_t>(bb) * a.m;
  float* carry_lo = carry + (batch_worker * 2) * n;
  float* carry_hi = carry_lo + n;
  const int64_t s_begin = static_cast<int64_t>(w) * a.g * a.t;
  const int64_t c_end = static_cast<int64_t>(w + 1) * a.g;
  const int64_t s_end = (c_end < a.n_chunks ? c_end : a.n_chunks) * a.t;

  float acc[L::kPer];
  float zero[L::kPer];
#pragma unroll
  for (int q = 0; q < L::kPer; ++q) acc[q] = zero[q] = 0.0f;
  int cur = lo;

  // The current row ends and `next` (> cur) begins; warp-uniform.  The
  // half-warps' partials merge first; rows strictly between are empty.
  auto leave = [&](int next) {
    if constexpr (L::kSlots == 2) {
#pragma unroll
      for (int q = 0; q < L::kPer; ++q) {
        acc[q] += __shfl_xor_sync(kFull, acc[q], L::kLanes);
      }
    }
    if (sub == 0) {
      if (cur == lo) {
        store_carry<kBody>(carry_lo, acc, c0, n);
      } else {
        store_row<kBody>(out, acc, ep, cur, (obatch + cur) * n, c0, n);
      }
      for (int r = cur + 1; r < next; ++r) {
        store_row<kBody>(out, zero, ep, r, (obatch + r) * n, c0, n);
      }
    }
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) acc[q] = 0.0f;
    cur = next;
  };

  // This lane's slot of the next group of 32: fetched while the current
  // group is consumed, its value gathered at the current group's end.
  struct Slot {
    int slot, col, lrow, tile;
  };
  auto fetch = [&](int64_t s) {
    Slot f{a.nnz_pad, 0, 0, 0};
    if (s < s_end) {
      f.slot = a.slot_nz[s];
      f.col = a.cols[s];
      f.lrow = a.lrow[s];
      f.tile = a.tile[s / a.t];
    }
    return f;
  };
  auto gather = [&](const Slot& f) {
    return f.slot < a.nnz_pad ? to_f32(vals[f.slot]) : 0.0f;
  };
  // The B rows of kUnroll steps of kSlots slots from slot j0 of the group
  // (a dead slot loads nothing and adds 0 * 0); loads go out before the
  // values are read.
  auto load_steps = [&](int j0, unsigned live, int col, float v,
                        BRaw<kBody, TB> (&braw)[kUnroll],
                        float (&vj)[kUnroll]) {
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
  };
  Slot next = fetch(s_begin + lane);
  float next_val = gather(next);
  for (int64_t s0 = s_begin; s0 < s_end; s0 += kWarp) {
    const bool is_live = next.slot < a.nnz_pad;
    const int col = next.col;
    const int row = is_live ? next.tile * a.tm + next.lrow : -1;  // dead
    const float v = next_val;
    next = fetch(s0 + kWarp + lane);
    const unsigned live = __ballot_sync(kFull, is_live);
    if (live != 0 && __all_sync(kFull, row < 0 || row == cur)) {
      // The whole group adds to the current row (the common case where
      // rows are long): loads in flight, then FMAs, no row checks.
#pragma unroll
      for (int j0 = 0; j0 < kWarp; j0 += kUnroll * L::kSlots) {
        BRaw<kBody, TB> braw[kUnroll];
        float vj[kUnroll];
        load_steps(j0, live, col, v, braw, vj);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) braw[u].accumulate(vj[u], acc);
      }
    } else if (live != 0) {
      // A row ends inside the group: slot by slot, in order.
#pragma unroll 1
      for (int j0 = 0; j0 < kWarp; j0 += kUnroll * L::kSlots) {
        BRaw<kBody, TB> braw[kUnroll];
        float vj[kUnroll];
        load_steps(j0, live, col, v, braw, vj);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int h = 0; h < L::kSlots; ++h) {
            const int r = __shfl_sync(kFull, row, j0 + u * L::kSlots + h);
            if (r >= 0 && r != cur) leave(r);  // uniform
            if (sub == h) braw[u].accumulate(vj[u], acc);
          }
        }
      }
    }
    next_val = gather(next);
  }
  if (cur < hi) leave(hi);
  // cur == hi: its partial, and lo's if the range holds one row only.
  if constexpr (L::kSlots == 2) {
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) {
      acc[q] += __shfl_xor_sync(kFull, acc[q], L::kLanes);
    }
  }
  if (sub == 0) {
    if (hi == lo) {
      store_carry<kBody>(carry_lo, acc, c0, n);
      store_carry<kBody>(carry_hi, zero, c0, n);
    } else {
      store_carry<kBody>(carry_hi, acc, c0, n);
    }
  }
}

// The fix-up: one warp per (batch, split row j in [-1, W - 1], slice).
// The first j of a run of equal split rows R sums the partials of every
// worker that ends or starts at R, in worker order, applies the epilogue
// and stores row R.  It reads the carry rows with the f32x4 layout (the
// scalar one where the main body was scalar).
template <int kBody, typename TO>
__global__ void __launch_bounds__(kBlock)
merge_fixup_kernel(MergeArgs a, Epilogue ep, const float* __restrict__ carry,
                   TO* __restrict__ out) {
  constexpr int kFix = kBody == kBodyScalar ? kBodyScalar : kBodyF32x4;
  using L = Layout<kFix>;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int items = a.workers + 1;
  if (warp >= static_cast<int64_t>(a.batch) * items * a.n_slices) return;
  const int slice = static_cast<int>(warp % a.n_slices);
  const int64_t batch_item = warp / a.n_slices;
  const int j = static_cast<int>(batch_item % items) - 1;
  const int bb = static_cast<int>(batch_item / items);
  const int c0 = L::first_col(slice, lane);
  const int n = a.n;

  // Lane l reads S_{j-1+l}: the row, whether j starts its run, and how
  // far the run goes, in one round (another 32 a round for longer runs).
  // The run [j, jb] of split rows equal to `row` names the workers that
  // hold part of it, j .. jb + 1 (each starts or ends at the row).  The
  // walk stops at a worker that opens past the last live slot: the tail
  // of a plan's chunk stream splits at m - 1, and those workers hold
  // nothing, so the last worker read is then jb, whose end row is `row`.
  Split mine = split_at(a, j - 1 + lane);
  const int row = __shfl_sync(kFull, mine.row, 1);
  if (j >= 0 && __shfl_sync(kFull, mine.row, 0) == row) return;  // not first
  int jb = j - 1;  // S_{jb} is the last split row known to be in the run
  int w_end;       // the last worker to read
  for (int first_lane = 1;; first_lane = 0) {
    // Lane first_lane + i holds S_{jb+1+i}.
    const int jj = jb + 1 + lane - first_lane;
    const bool ours = lane >= first_lane;
    const unsigned run =
        __ballot_sync(kFull, ours && jj < a.workers && mine.row == row) >>
        first_lane;
    const unsigned past =
        __ballot_sync(kFull, ours && mine.past_end) >> first_lane;
    const int len = run == kFull ? kWarp : __ffs(~run) - 1;
    const int cut = past ? __ffs(past) : kWarp + 1;  // S_{jb+cut}: past
    if (cut <= len) {  // worker jb + cut + 1 opens past the end
      jb += cut;
      w_end = jb;
      break;
    }
    jb += len;
    if (len < kWarp - first_lane) {
      w_end = min(jb + 1, a.workers - 1);
      break;
    }
    mine = split_at(a, jb + 1 + lane);
  }
  float acc[L::kPer];
#pragma unroll
  for (int q = 0; q < L::kPer; ++q) acc[q] = 0.0f;
  for (int w = max(j, 0); w <= w_end; ++w) {
    const float* lo_row =
        carry + ((static_cast<int64_t>(bb) * a.workers + w) * 2) * n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // Worker w starts at the row when S_{w-1} is in the run, ends at it
      // when S_w is.
      if (half == 0 ? w - 1 < j : w > jb) continue;
      const float* src = lo_row + half * n;
      if constexpr (kFix == kBodyScalar) {
#pragma unroll
        for (int q = 0; q < L::kPer; ++q) {
          if (c0 + q * kWarp < n) acc[q] += src[c0 + q * kWarp];
        }
      } else if (c0 < n) {
        const float4 p = *reinterpret_cast<const float4*>(src + c0);
        acc[0] += p.x;
        acc[1] += p.y;
        acc[2] += p.z;
        acc[3] += p.w;
      }
    }
  }
  store_row<kFix>(out, acc, ep, row,
                  (static_cast<int64_t>(bb) * a.m + row) * n, c0, n);
}

}  // namespace repro

// C entry: out (batch, m, n) = epilogue(A @ b) for the chunk structure
// cols/lrow/slot_nz (n_chunks, t), tile/first (n_chunks,), vals
// (nnz_pad,), b (batch, k, n) row-major, in ranges of g chunks a warp;
// carry is (batch, ceil(n_chunks / g), 2, n) float32, written before it
// is read (not zeroed).  Picks the body (f32x4 for float32 b with n % 4
// == 0, bf16x8 for bfloat16 b with n % 8 == 0, each with 16-byte aligned
// b, out, residual and carry; scalar otherwise), reports it in *body,
// launches the range kernel and the fix-up on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int repro_merge_spmm(
    const void* cols, const void* lrow, const void* slot_nz,
    const void* tile, const void* first, const void* vals, int vals_dtype,
    const void* b, int b_dtype, const void* bias, const void* residual,
    int act, int has_scale, float scale, void* out, int out_dtype,
    void* carry, int batch, int n_chunks, int t, int tm, int nnz_pad, int m,
    int k, int n, int g, int device, void* stream, int* body) {
  using namespace repro;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t <= 0 || g <= 0 || n_chunks <= 0 || m <= 0 ||
      !known_dtype(vals_dtype) || !known_dtype(b_dtype) ||
      !known_dtype(out_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergeArgs a{static_cast<const int32_t*>(cols),
              static_cast<const int32_t*>(lrow),
              static_cast<const int32_t*>(slot_nz),
              static_cast<const int32_t*>(tile),
              static_cast<const int32_t*>(first),
              batch, n_chunks, t, tm, nnz_pad, m, k, n, g,
              (n_chunks + g - 1) / g, (n + kSliceCols - 1) / kSliceCols};
  const int64_t warps =
      static_cast<int64_t>(batch) * a.workers * a.n_slices;
  const int64_t fix_warps =
      static_cast<int64_t>(batch) * (a.workers + 1) * a.n_slices;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t fix_blocks =
      (fix_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (fix_blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_ok = aligned16(b) && aligned16(out) && aligned16(carry) &&
                      (residual == nullptr || aligned16(residual));
  const int code = pick_body(b_dtype, n, vec_ok);
  *body = code;
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
            merge_range_kernel<kBody, TV, TB, TO>
                <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
                    a, static_cast<const TV*>(vals),
                    static_cast<const TB*>(b), ep, static_cast<TO*>(out),
                    static_cast<float*>(carry));
            merge_fixup_kernel<kBody, TO>
                <<<static_cast<unsigned>(fix_blocks), kBlock, 0, s>>>(
                    a, ep, static_cast<const float*>(carry),
                    static_cast<TO*>(out));
          }
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
