// Row-split SpMM (paper §4.1) for Hopper (sm_90a): C = A @ B over the
// ELL slot layout that kernels/rowsplit_spmm.py plans, with the fused
// epilogue act(C + bias) * scale + residual.
//
// Replaces: src/repro/kernels/rowsplit_spmm.py, _rowsplit_kernel /
// rowsplit_spmm_pallas (the TPU kernel).
//
// What bounds it on this card: the B rows it reads.  Every stored nonzero
// is one (col, slot, value) triple and feeds n multiply-adds against one B
// row, 4 bytes of B for each f32 multiply-add.  A pruned row is a quarter
// dense, chosen by its own magnitudes, so two rows share a column only by
// chance and no B element is reused from registers: each product needs
// its B element brought to the lane, and the pace is set by where that
// element comes from.
//
// What the design does about it: the paper's static split by rows and the
// fused epilogue at the single store of C, in two bodies.
//
// * Warp-per-row (the f32x4, bf16x8 and scalar bodies): one warp per
//   (batch, row, 128-column slice), coalesced row-major B loads from L2.
//   Lanes load the row's slots 32 at a time (col, and the value gathered
//   through slot_nz), prefetching the next 32 while the current ones are
//   consumed; the warp broadcasts each slot with __shfl_sync and keeps
//   kUnroll 16-byte B-row loads in flight before the FMAs (the bodies of
//   spmm_common.cuh: f32x4, bf16x8 with two half-warps on two slots,
//   scalar).  An ELL row holds its live slots first (kernels/
//   rowsplit_spmm.py ell_slots), so the first group of 32 with a dead slot
//   is the row's last: the walk stops there and never reads the padding up
//   to the longest row.  Slots whose slot_nz is the sentinel nnz_pad read
//   a zero value instead of vals[nnz_pad] (which does not exist), exactly
//   the TPU kernel's zero pad.  B crosses L2 once for every nonzero: at
//   the serving path's tall-skinny n that is the whole cost.
//
//   A short, wide matrix gives too few rows to fill the card (Llama's w2:
//   2048 warps of 2048 slots each), so the wrapper may split each row's
//   groups of 32 slots into `parts` contiguous parts (parts divides the 8
//   warps of a block): the parts' warps share a block, sum their partials
//   through shared memory in part order, and part 0 applies the epilogue
//   and stores the row once.
//
// * Staged (f32 B, 16-byte aligned, each row's columns ascending, B at
//   least a tile wide and enough tiles to fill the card: the wrapper's
//   rule): one block per (batch, kStagedRows consecutive rows, kStagedCols
//   columns) tile, row blocks fastest so that the blocks resident at once
//   read one (batch, slice) panel of B, which stays in L2.  A producer
//   warp brings B to the SM once per block of rows, in windows of
//   kStagedWindow rows of the panel (one TMA box each, zero past k and n)
//   through a ring of stages with "full" and "empty" mbarriers; the
//   consumer warps read each slot's B row from the stage, 16-byte shared
//   loads that cover 512 contiguous bytes a warp (no bank conflict).  A
//   staged B element feeds every row of the block that holds its column,
//   so B leaves L2 once per block of rows, not once per nonzero, and
//   shared memory serves the 4 bytes of each multiply-add: its 128 bytes
//   a clock an SM bound the body at about a quarter of the f32 rate.  A
//   warp walks its few rows in lockstep, without a branch, to keep enough
//   loads in flight (the staged-body notes below).  Columns ascend in a
//   row, so the windows take its slots in slot order: each C element is
//   the same fmaf sequence as the f32x4 body's at one part, bit for bit.
//
// No atomics, no zeroed scratch, one launch: the same inputs give the same
// bits on every call.
#include "hopper.cuh"
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

// ----------------------------------------------------------- staged body --
//
// Warps 0 .. kStagedWarps - 1 are the consumers, the last warp the
// producer, whose one thread issues every TMA load.  Both sides walk the
// same windows in the same order, so the ring's stage and phase advance in
// step.  Every consumer warp walks every window, rows or none, because
// each stage's "empty" barrier waits for all of them.
//
// A tile is kStagedCols = 128 kStagedHalves columns wide: a lane owns 4
// columns in each 128 (Layout<kBodyF32x4> of each half), so one broadcast
// slot feeds kStagedHalves 16-byte loads.  A consumer warp owns
// kStagedRowsPerWarp rows.  Each row keeps, in registers, a cursor into
// its slots and the lane's columns of the three groups of 32 slots from
// the cursor's (A, B, C: a dead slot's column is kNoCol), and in shared
// memory the pairs of A and B, 64 in a line: (the B row's offset in a
// stage, the value).  In a window a row takes the run of slots from its
// cursor whose columns lie below the window's end; two ballots over A and
// B give its length.  The warp then walks its rows' runs in lockstep, step
// t taking slot t of every row's run, with no branch: a row past its run
// loads nothing and adds 0 * 0, as a dead slot does.  So the rows' loads
// are in flight together, and each row's own slots still go in slot
// order.  A row whose cursor leaves A shifts: B's pairs move to A's place,
// C's become B's, the group after C is fetched; C's values are gathered
// at the next window, long before it becomes B.
//
// Sizes: windows of kStagedWindow rows of B, kStagedStages stages in
// flight, kStagedRows = kStagedWarps x kStagedRowsPerWarp rows a block.
// Few rows a warp keep the lockstep's idle steps few (the longest run of
// a warp's rows sets its steps), and many warps keep enough loads in
// flight.  These were the fastest of the grid that PERF.md §6 row 2
// records, on the H100 at the pruned FFN shapes of Granite-3.0-2B and
// Qwen2-72B.
constexpr int kStagedWarps = 24;
constexpr int kStagedRowsPerWarp = 2;
constexpr int kStagedHalves = 2;
constexpr int kStagedWindow = 64;
constexpr int kStagedStages = 3;
constexpr int kStagedRows = kStagedWarps * kStagedRowsPerWarp;
constexpr int kStagedCols = kSliceCols * kStagedHalves;
constexpr int kStagedThreads = (kStagedWarps + 1) * kWarp;
constexpr uint32_t kStagedStageBytes = kStagedWindow * kStagedCols * 4;
static_assert((kStagedWindow & (kStagedWindow - 1)) == 0,
              "a window's rows are a power of two");
// The pairs of each row's groups A and B.
constexpr uint32_t kStagedPairBytes =
    kStagedRows * 2 * kWarp * sizeof(int2);
// The ring, the pairs, and slack to align the ring's base to 128 bytes (a
// TMA destination).
constexpr int kStagedSmem =
    kStagedStages * kStagedStageBytes + kStagedPairBytes + 128;
// The column of a dead slot: past every window.
constexpr int32_t kNoCol = 0x7fffffff;

// x = the 16 bytes at shared address `addr` where `take`, else x as it
// is: a predicated load, so that a step past a row's run neither branches
// nor spends a load.
__device__ __forceinline__ void lds128_if(bool take, uint32_t addr,
                                          float4& x) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %4, 0;\n"
      "@p ld.shared.v4.f32 {%0, %1, %2, %3}, [%5];\n"
      "}\n"
      : "+f"(x.x), "+f"(x.y), "+f"(x.z), "+f"(x.w)
      : "r"(static_cast<int>(take)), "r"(addr));
}

template <int kBody, typename TV, typename TB, typename TO>
__global__ void __launch_bounds__(kStagedThreads, 1)
rowsplit_kernel(const __grid_constant__ CUtensorMap b_map,
                const int32_t* __restrict__ cols,
                const int32_t* __restrict__ slot_nz,
                const TV* __restrict__ vals, Epilogue ep,
                TO* __restrict__ out, int m, int l, int nnz_pad, int k,
                int n, int n_slices, int row_blocks) {
  static_assert(kBody == kBodyStaged && std::is_same_v<TB, float>,
                "the staged body reads float32 B");
  constexpr int kR = kStagedRowsPerWarp;
  constexpr int kH = kStagedHalves;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStagedStages], empty[kStagedStages];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  float* ring =
      reinterpret_cast<float*>(smem_raw + ((128 - (raw & 127)) & 127));
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // Tile blockIdx.x: row blocks fastest, then slices, then the batch.
  const int rb = static_cast<int>(blockIdx.x % row_blocks);
  const int rest = static_cast<int>(blockIdx.x / row_blocks);
  const int slice = rest % n_slices;
  const int bb = rest / n_slices;
  const int windows = (k + kStagedWindow - 1) / kStagedWindow;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStagedStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], kStagedWarps);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kStagedWarps) {
    // ---- producer: B[bb, k0 : k0 + W, the tile's columns] a window,
    // zero-filled past k and n.
    if (lane != 0) return;
    hopper::prefetch_tensor_map(&b_map);
    int st = 0;
    uint32_t ph = 0;
    for (int w = 0; w < windows; ++w) {
      hopper::mbar_wait(&empty[st], ph ^ 1);
      hopper::mbar_expect_tx(&full[st], kStagedStageBytes);
      hopper::tma_load_3d(ring + st * (kStagedStageBytes / 4), &b_map,
                          &full[st], slice * kStagedCols, w * kStagedWindow,
                          bb);
      if (++st == kStagedStages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ---- consumers.
  int2* pairs =
      reinterpret_cast<int2*>(ring + kStagedStages * (kStagedStageBytes / 4)) +
      warp * kR * 2 * kWarp;
  const int row0 = rb * kStagedRows + warp * kR;
  const int c0 = slice * kStagedCols + lane * 4;  // Layout<kBodyF32x4>
  int cur[kR], col_a[kR], col_b[kR], col_c[kR], x_c[kR];
  float acc[kR][4 * kH];
  unsigned pending = 0;  // bit j: x_c[j] is still C's slot id

  auto fetch = [&](int row, int s, int& c, int& slot) {
    c = kNoCol;
    slot = nnz_pad;
    if (row < m && s < l) {
      const int64_t at = static_cast<int64_t>(row) * l + s;
      c = cols[at];
      slot = slot_nz[at];
    }
  };
  auto gather = [&](int slot) {
    return slot < nnz_pad ? to_f32(vals[slot]) : 0.0f;
  };
  // A slot's pair: its B row's offset in a stage (a window's rows are a
  // power of two from a multiple of it), and its value.
  auto pair = [&](int c, int v_bits) {
    return make_int2((c & (kStagedWindow - 1)) * kStagedCols, v_bits);
  };
  // C's values gathered, its dead slots' columns made kNoCol.
  auto resolve = [&](int j) {
    if ((pending >> j) & 1u) {
      const int slot = x_c[j];
      if (slot >= nnz_pad) col_c[j] = kNoCol;
      x_c[j] = __float_as_int(gather(slot));
      pending &= ~(1u << j);
    }
  };
  // Row j's cursor has left A (group g): B becomes A, C becomes B, group
  // g + 3 is fetched.  Each lane moves its own pairs.
  auto shift = [&](int j, int g) {
    resolve(j);
    int2* line = pairs + j * 2 * kWarp;
    line[lane] = line[kWarp + lane];
    line[kWarp + lane] = pair(col_c[j], x_c[j]);
    col_a[j] = col_b[j];
    col_b[j] = col_c[j];
    fetch(row0 + j, (g + 3) * kWarp + lane, col_c[j], x_c[j]);
    pending |= 1u << j;
  };

  {
    int c_a[kR], s_a[kR], c_b[kR], s_b[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      fetch(row0 + j, lane, c_a[j], s_a[j]);
      fetch(row0 + j, kWarp + lane, c_b[j], s_b[j]);
      fetch(row0 + j, 2 * kWarp + lane, col_c[j], x_c[j]);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      col_a[j] = s_a[j] < nnz_pad ? c_a[j] : kNoCol;
      col_b[j] = s_b[j] < nnz_pad ? c_b[j] : kNoCol;
      pairs[j * 2 * kWarp + lane] =
          pair(col_a[j], __float_as_int(gather(s_a[j])));
      pairs[j * 2 * kWarp + kWarp + lane] =
          pair(col_b[j], __float_as_int(gather(s_b[j])));
      cur[j] = 0;
      pending |= 1u << j;
#pragma unroll
      for (int q = 0; q < 4 * kH; ++q) acc[j][q] = 0.0f;
    }
    __syncwarp();
  }

  int st = 0;
  uint32_t ph = 0;
  for (int w = 0; w < windows; ++w) {
    const int kend = (w + 1) * kStagedWindow;
    // This lane's first 16 bytes of the stage's first row.
    const uint32_t stage =
        hopper::smem_u32(ring + st * (kStagedStageBytes / 4) + lane * 4);
#pragma unroll
    for (int j = 0; j < kR; ++j) resolve(j);
    hopper::mbar_wait(&full[st], ph);
    bool more = true;
    while (more) {  // uniform over the warp; a second round is rare
      // Each row's run: the slots from its cursor, over A and B, whose
      // columns lie below kend (ascending columns: the low bits).
      int cnt[kR], at[kR];
      int steps = 0;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const uint64_t in =
            static_cast<uint64_t>(__ballot_sync(kFull, col_a[j] < kend)) |
            static_cast<uint64_t>(__ballot_sync(kFull, col_b[j] < kend))
                << 32;
        const int c = cur[j] % kWarp;
        const uint64_t avail = in >> c;
        cnt[j] = avail == ~0ull ? 64 : __ffsll(static_cast<long long>(
                                              ~avail)) - 1;
        at[j] = j * 2 * kWarp + c;
        steps = max(steps, cnt[j]);
      }
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        float4 bq[kR][kH];
        float v[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const bool ok = t < cnt[j];
          const int2 pv = pairs[at[j] + (ok ? t : 0)];
          v[j] = ok ? __int_as_float(pv.y) : 0.0f;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            bq[j][h] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            lds128_if(ok, stage + 4 * (pv.x + h * kSliceCols), bq[j][h]);
          }
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            acc[j][4 * h + 0] = fmaf(v[j], bq[j][h].x, acc[j][4 * h + 0]);
            acc[j][4 * h + 1] = fmaf(v[j], bq[j][h].y, acc[j][4 * h + 1]);
            acc[j][4 * h + 2] = fmaf(v[j], bq[j][h].z, acc[j][4 * h + 2]);
            acc[j][4 * h + 3] = fmaf(v[j], bq[j][h].w, acc[j][4 * h + 3]);
          }
        }
      }
      __syncwarp();  // every lane is done reading the pairs
      more = false;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int g = cur[j] / kWarp;
        const int end = cur[j] % kWarp + cnt[j];  // in [0, 64]
        cur[j] += cnt[j];
        if (end >= kWarp) shift(j, g);
        if (end == 2 * kWarp) {  // B taken whole: the run may go on
          shift(j, g + 1);
          more = true;
        }
      }
      __syncwarp();
    }
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
    if (++st == kStagedStages) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int row = row0 + j;
    if (row < m) {
      const int64_t obase = (static_cast<int64_t>(bb) * m + row) * n;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        store_row<kBodyF32x4>(out, acc[j] + 4 * h, ep, row, obase,
                              c0 + h * kSliceCols, n);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// The staged launch: B (batch, k, n) float32 as the TMA map {n, k, batch}
// in boxes of {kStagedCols, kStagedWindow, 1}.
template <typename TV, typename TO>
cudaError_t launch_staged(const int32_t* cols, const int32_t* slot_nz,
                          const TV* vals, const float* b, const Epilogue& ep,
                          TO* out, int batch, int m, int l, int nnz_pad,
                          int k, int n, int device, cudaStream_t stream) {
  // The staged overload of rowsplit_kernel, by its parameters.
  using Kernel = void (*)(CUtensorMap, const int32_t*, const int32_t*,
                          const TV*, Epilogue, TO*, int, int, int, int, int,
                          int, int);
  const Kernel kernel = rowsplit_kernel<kBodyStaged, TV, float, TO>;
  // Once per device and instance: the shared-memory opt-in.
  static bool opted[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (!opted[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagedSmem);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(n) * 4,
      static_cast<cuuint64_t>(n) * 4 * static_cast<cuuint64_t>(k)};
  const cuuint32_t box[3] = {kStagedCols, kStagedWindow, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(b), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int n_slices = (n + kStagedCols - 1) / kStagedCols;
  const int row_blocks = (m + kStagedRows - 1) / kStagedRows;
  const int64_t tiles = static_cast<int64_t>(batch) * row_blocks * n_slices;
  if (tiles == 0) return cudaGetLastError();
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), kStagedThreads, kStagedSmem,
           stream>>>(map, cols, slot_nz, vals, ep, out, m, l, nnz_pad, k, n,
                     n_slices, row_blocks);
  return cudaGetLastError();
}

}  // namespace repro

// C entry: out (batch, m, n) = epilogue(A @ b) for the ELL structure
// cols/slot_nz (m_pad >= m rows of l slots, each row's live slots first),
// vals (nnz_pad,), b (batch, k, n) row-major, each row's slot groups split
// in `parts` (1, 2, 4 or 8) contiguous parts.  Picks the body (f32x4 for
// float32 b with n % 4 == 0, bf16x8 for bfloat16 b with n % 8 == 0, each
// with 16-byte aligned b, out and residual; scalar otherwise); where the
// body is f32x4, k > 0 and `staged` is set (the caller vouches that every
// row's live columns ascend), runs the staged body instead, which ignores
// `parts`.  Reports the body in *body, launches on `stream` without
// synchronising and returns cudaGetLastError() (cudaErrorInvalidValue for
// an unknown dtype code or parts; the error that kept the staged body from
// launching: a tensor map that does not encode, a refused shared-memory
// opt-in).
extern "C" int repro_rowsplit_spmm(
    const void* cols, const void* slot_nz, const void* vals, int vals_dtype,
    const void* b, int b_dtype, const void* bias, const void* residual,
    int act, int has_scale, float scale, void* out, int out_dtype,
    int batch, int m, int l, int nnz_pad, int k, int n, int parts,
    int staged, int device, void* stream, int* body) {
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
  const bool run_staged = staged != 0 && code == kBodyF32x4 && k > 0;
  *body = run_staged ? kBodyStaged : code;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{static_cast<const float*>(bias),
                    static_cast<const float*>(residual), act, has_scale,
                    scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (run_staged) {
    with_dtype(vals_dtype, [&](auto tv) {
      using TV = decltype(tv);
      with_dtype(out_dtype, [&](auto to) {
        using TO = decltype(to);
        err = launch_staged<TV, TO>(
            static_cast<const int32_t*>(cols),
            static_cast<const int32_t*>(slot_nz),
            static_cast<const TV*>(vals), static_cast<const float*>(b), ep,
            static_cast<TO*>(out), batch, m, l, nnz_pad, k, n, device, s);
      });
    });
    return static_cast<int>(err);
  }
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
