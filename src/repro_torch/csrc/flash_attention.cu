// Causal flash attention for Hopper (sm_90a):
//   o[b, i, h, :] = sum_{j <= i} softmax_j(q[b, i, h, :] . k[b, j, h/g, :]
//                   * dh^-0.5) v[b, j, h/g, :]
// with q (b, s, h, dh), k and v (b, s, kv, dh), g = h / kv (grouped-query
// attention), the softmax and every sum in float32 and o written in q's
// type (float32 or bfloat16).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_kernel /
// flash_attention_pallas (the TPU kernel), reached through
// src/repro/kernels/ops.py flash_attention.
//
// What bounds it on this card.  A causal call does 4 b h dh s (s + 1) / 2
// operations (Q.K^T and P.V over the triangle) on b s (2 h + 2 kv) dh
// elements.  At the served models' long prefills in bf16 that is the
// tensor cores: Llama-3.2-1B at s 8192 (32 heads of 64) is 2.75e11
// operations, 0.278 ms at 989 TFLOP/s, against 84 MB, 0.025 ms at 3.35
// TB/s.  At dh 64 the softmax's exp is a second limit of the same size:
// one exp per score, 1.07e9 of them, at 16 a clock on each of 132 SMs.  At
// dh 128 (OLMoE-1B-7B) the exps are half as many per operation.  In f32
// the operations bound it outside the tensor cores (67 TFLOP/s): TF32
// would not hold the f32 tolerance.
//
// What the design does about it.  The TPU kernel walks a rectangular grid
// (b h, q block, kv block) in order, carries m, l and the accumulator in
// VMEM scratch from one kv step to the next, and masks the blocks above
// the diagonal to zero updates.  Here one thread block owns a tile of
// query rows of one (batch, head) and loops over the key tiles itself,
// from the first to the last one that reaches the diagonal, so no tile
// above the diagonal is visited and only the tiles that cross it are
// masked elementwise (skipping is exact: those tiles add exp(NEG_INF - m)
// = 0).  The query tiles with the most key tiles are launched first (the
// grid's slow axis runs the tiles in reverse), so the short tiles fill the
// card's tail: the paper's load balancing in miniature.  The KV head h / g
// and the (b, s, h, dh) strides are read in place: no broadcast, fold or
// padding copy.  Three bodies, dh a template parameter (every multiple of
// 16 up to 128):
//
// * bf16 at dh 64 and 128, the served models' widths (wgmma): Hopper's
//   own path to the tensor cores.  A producer warpgroup whose one thread
//   loads Q and a two-stage ring of 128-key K and V tiles by TMA (tensor
//   maps over {dh, heads, s, b}, so a box that runs past s is zero-filled
//   and never reads the next batch), and consumer warpgroups of 64 query
//   rows (3 at dh 64, 2 at dh 128) that run S = Q.K^T (both operands in
//   shared memory) and O += P.V (P from registers, V in place as an
//   MN-major B) with wgmma.  Against the exp limit: the consumers take
//   turns at the tensor cores through named barriers, so one's softmax
//   runs under the others' products, and each runs a tile's softmax under
//   its own P.V of the tile before.  See the body's own comment.
// * bf16 at the other head dims (mma.sync): each of the 4 warps of a
//   64-row block owns 16 query rows.  Q's fragments stay in registers for
//   the whole key loop; K and V tiles of 64 keys are staged in shared
//   memory with 16-byte loads and read with ldmatrix (V transposed by
//   ldmatrix.trans); S = Q.K^T and O += P.V by mma.sync m16n8k16.
// * f32 (SIMT): FMA.  Q, K, V and P tiles in shared memory (dynamic, above
//   48 KB at dh 64 and up); each thread owns 4 query rows x 8 keys of S
//   and 4 rows x dh / 8 columns of O, with the row max and sum reduced
//   over the 8 lanes that share a row.
//
// Both bf16 bodies keep the running max m and sum l in f32, one per row,
// work in the exp2 domain (the scale times log2 e applied after the dot
// product), and round P to bf16 for P.V straight from the S accumulators,
// as the reference rounds p to v's type (the accumulator layout of S and
// the A-fragment layout of P.V coincide).  Keys past s are zeros and
// masked by causality; rows past s are computed and never written.
// NEG_INF is finite (-1e30), as in the reference, so no (-inf) - (-inf)
// makes a NaN.  Later work: a persistent schedule, and the f32 body.
#include "hopper.cuh"
#include "spmm_common.cuh"

namespace repro {

constexpr int kFaBM = 64;        // query rows of a block
constexpr int kFaBN = 64;        // keys of a tile
constexpr int kFaThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ bf16 body --

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16 x 16, row) . B (16 x 8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// (batch, head) and query tile of this block, and the element offsets of
// position 0 of its q/o head and of its k/v head.
struct FaBlock {
  int qt;
  int64_t q_off, kv_off;
};

__device__ __forceinline__ FaBlock fa_block(int s, int h, int kvh, int dh) {
  FaBlock fb;
  fb.qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int b = blockIdx.x / h;
  const int hq = blockIdx.x % h;
  const int hk = hq / (h / kvh);
  fb.q_off = (static_cast<int64_t>(b) * s * h + hq) * dh;
  fb.kv_off = (static_cast<int64_t>(b) * s * kvh + hk) * dh;
  return fb;
}

template <int kDh>
__global__ void __launch_bounds__(kFaThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int s, int h, int kvh,
                  float scale_log2) {
  // Rows padded by 16 bytes: the 8 rows an ldmatrix reads fall in
  // distinct banks.
  constexpr int kLd = kDh + 8;
  constexpr int kChunks = kDh / 8;  // 16-byte chunks of a row
  __shared__ __align__(16) __nv_bfloat16 ks[kFaBN][kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kFaBN][kLd];

  const FaBlock fb = fa_block(s, h, kvh, kDh);
  const int64_t q_stride = static_cast<int64_t>(h) * kDh;
  const int64_t kv_stride = static_cast<int64_t>(kvh) * kDh;
  const __nv_bfloat16* qb = q + fb.q_off;
  const __nv_bfloat16* kb = k + fb.kv_off;
  const __nv_bfloat16* vb = v + fb.kv_off;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int grp = lane >> 2;  // the fragment's row (and row + 8)
  const int quad = lane & 3;  // the fragment's column pair
  const int row_a = fb.qt * kFaBM + warp * 16 + grp;
  const int row_b = row_a + 8;

  // Q's A fragments, one per 16-deep slice of dh, for the whole key loop.
  uint32_t qf[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int d = kk * 16 + 2 * quad;
    const uint32_t* pa =
        reinterpret_cast<const uint32_t*>(qb + row_a * q_stride + d);
    const uint32_t* pb =
        reinterpret_cast<const uint32_t*>(qb + row_b * q_stride + d);
    qf[kk][0] = row_a < s ? pa[0] : 0u;
    qf[kk][1] = row_b < s ? pb[0] : 0u;
    qf[kk][2] = row_a < s ? pa[4] : 0u;  // 8 bf16 further along dh
    qf[kk][3] = row_b < s ? pb[4] : 0u;
  }

  float acc[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  // Per row (row_a, row_b): running max (exp2 domain) and this thread's
  // share of the running sum (its quad's four shares add up at the end).
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  // ldmatrix row addresses: lane = 8 i + j reads row j of matrix i.
  const int mi = lane >> 3;
  const int mj = lane & 7;

  for (int kt = 0; kt <= fb.qt; ++kt) {
    const int key0 = kt * kFaBN;
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int it = 0; it < kFaBN * kChunks / kFaThreads; ++it) {
      const int idx = tid + it * kFaThreads;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (key0 + r < s) {
        const int64_t off = (key0 + r) * kv_stride + c;
        kv4 = *reinterpret_cast<const uint4*>(kb + off);
        vv4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv4;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv4;
    }
    __syncthreads();

    // S = Q.K^T: 8 n-tiles of 8 keys.
    float sc[kFaBN / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kFaBN / 16; ++np) {
        // matrices: (keys +0, d +0), (keys +0, d +8), (keys +8, d +0),
        // (keys +8, d +8) -> b0, b1 of n-tiles 2 np and 2 np + 1.
        uint32_t b[4];
        ldmatrix_x4(b, &ks[np * 16 + mj + ((mi >> 1) << 3)]
                          [kk * 16 + ((mi & 1) << 3)]);
        mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // Scale, mask the diagonal tile, and the online softmax.
    const bool diag = kt == fb.qt;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kFaBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * quad + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = sc[j][e] * scale_log2;
        if (diag && key > row) x = kNegInf;
        sc[j][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a);
    const float alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kFaBN / 8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn_a);
      sc[j][1] = exp2f(sc[j][1] - mn_a);
      sc[j][2] = exp2f(sc[j][2] - mn_b);
      sc[j][3] = exp2f(sc[j][3] - mn_b);
      sum_a += sc[j][0] + sc[j][1];
      sum_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      acc[j][0] *= alpha_a;
      acc[j][1] *= alpha_a;
      acc[j][2] *= alpha_b;
      acc[j][3] *= alpha_b;
    }

    // O += P.V: P's A fragment for 16 keys is the S accumulators of n-tiles
    // 2 kk and 2 kk + 1, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kFaBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDh / 16; ++dp) {
        // matrices (transposed): (keys +0, d +0), (keys +8, d +0),
        // (keys +0, d +8), (keys +8, d +8) -> b0, b1 of d n-tiles 2 dp
        // and 2 dp + 1.
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs[kk * 16 + mj + ((mi & 1) << 3)]
                                [dp * 16 + ((mi >> 1) << 3)]);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + fb.q_off;
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    const int d = j * 8 + 2 * quad;
    if (row_a < s) {
      *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + d) =
          pack_bf16(acc[j][0] / den_a, acc[j][1] / den_a);
    }
    if (row_b < s) {
      *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + d) =
          pack_bf16(acc[j][2] / den_b, acc[j][3] / den_b);
    }
  }
}

// ----------------------------------------------------------- wgmma body --
//
// bf16 at dh 64 and 128.  A block owns 64 x kConsumers query rows of one
// (batch, head): warpgroup 0 is the producer, warpgroups 1 .. kConsumers
// the consumers of 64 rows each.  One producer thread loads Q once and
// then K and V tiles of 128 keys by TMA into a ring of kStages stages,
// each with a "full" mbarrier (the expected bytes) and an "empty" one (one
// arrival from each consumer warp).  A consumer computes S = Q.K^T with
// both operands in shared memory, the online softmax in registers, and
// O += P.V with P from registers (the S accumulators rounded to bf16: the
// accumulator and A-fragment layouts coincide) and V read in place as an
// MN-major B.  Within a consumer, tile kt's Q.K^T starts together with
// tile kt - 1's P.V, and kt's softmax runs while that P.V does; between the
// consumers, named barriers 1 .. kConsumers pass the tensor cores round,
// so that one warpgroup's exps run while the others' products do.

constexpr int kWgBN = 128;            // keys of a tile
constexpr int kWgProducerRegs = 24;
constexpr int kBoxCols = 64;          // bf16 columns of a 128-byte row
constexpr int kRowBytes = 128;

// Consumer warpgroups: 3 at dh 64, so that two warpgroups' products can
// cover one's exps (the exps take about as long as the products there);
// 2 at dh 128, where a consumer holds S (64 x 128), O (64 x 128) and P in
// ~186 registers, more than a third consumer's share would leave.
// setmaxnreg moves registers from the producer to the consumers (128 x 24
// + 128 x kConsumers x kConsumerRegs <= 65536).  Two stages: more moved
// nothing on the card.
template <int kDh>
struct WgCfg {
  static constexpr int kConsumers = kDh == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kConsumers;  // query rows of a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kBoxes = kDh / kBoxCols;  // 64-column boxes a row
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = kBoxes * kBM * kRowBytes;
  static constexpr uint32_t kKvBytes = kBoxes * kWgBN * kRowBytes;
  // Q, the K and V rings, and slack to align the base to 1024 bytes.
  static constexpr int kSmem = kQBytes + 2 * kStages * kKvBytes + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q.K^T for this consumer's 64 rows and the 128 keys of a tile.
template <int kDh>
__device__ __forceinline__ void wg_start_qk(float (&sacc)[kWgBN / 2],
                                            uint32_t q_addr,
                                            uint32_t k_addr) {
  hopper::wgmma_fence();
  hopper::fence_regs(sacc);
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // k16 steps inside a box
    hopper::wgmma_ss(
        sacc,
        hopper::desc_sw128(
            q_addr + (kk / 4) * WgCfg<kDh>::kBM * kRowBytes + off, 16, 1024),
        hopper::desc_sw128(k_addr + (kk / 4) * kWgBN * kRowBytes + off, 16,
                           1024),
        kk > 0);
  }
  hopper::wgmma_commit();
  hopper::fence_regs(sacc);
}

// O += P.V over the 128 keys of a tile.
template <int kDh>
__device__ __forceinline__ void wg_start_pv(float (&oacc)[kDh / 2],
                                            const uint32_t (&pf)[kWgBN / 16]
                                                                [4],
                                            uint32_t v_addr) {
  hopper::wgmma_fence();
  hopper::fence_regs(oacc);
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    hopper::wgmma_rs_tb(
        oacc, pf[kk],
        hopper::desc_sw128(v_addr + kk * 16 * kRowBytes, kWgBN * kRowBytes,
                           1024),
        1);
  }
  hopper::wgmma_commit();
  hopper::fence_regs(oacc);
}

// O *= alpha, row by row (the accumulator layout of S, over dh columns).
template <int kDh>
__device__ __forceinline__ void wg_rescale(float (&oacc)[kDh / 2],
                                           float alpha_a, float alpha_b) {
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    oacc[4 * j] *= alpha_a;
    oacc[4 * j + 1] *= alpha_a;
    oacc[4 * j + 2] *= alpha_b;
    oacc[4 * j + 3] *= alpha_b;
  }
}

// The online softmax of one tile's scores, in place: masks the keys above
// the diagonal where `mask` is set, updates the running max m (exp2
// domain) and this thread's share of the sum l of rows row_a and
// row_a + 8, overwrites sacc with p = exp2(s scale_log2 - m) and returns
// the factors that rescale O in alpha.
__device__ __forceinline__ void wg_softmax(float (&sacc)[kWgBN / 2],
                                           bool mask, int key0, int row_a,
                                           int quad, float scale_log2,
                                           float& m_a, float& m_b,
                                           float& l_a, float& l_b,
                                           float& alpha_a, float& alpha_b) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * quad + (e & 1);
        if (key > row_a + (e < 2 ? 0 : 8)) sacc[4 * j + e] = kNegInf;
      }
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
  }
  // The scale is positive, so the max of the scaled scores is the scaled
  // max; a masked score (-1e30 before scaling) gives p = 0.
  const float mn_a = fmaxf(m_a, mx_a * scale_log2);
  const float mn_b = fmaxf(m_b, mx_b * scale_log2);
  alpha_a = ex2(m_a - mn_a);
  alpha_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    sacc[4 * j] = ex2(fmaf(sacc[4 * j], scale_log2, -mn_a));
    sacc[4 * j + 1] = ex2(fmaf(sacc[4 * j + 1], scale_log2, -mn_a));
    sacc[4 * j + 2] = ex2(fmaf(sacc[4 * j + 2], scale_log2, -mn_b));
    sacc[4 * j + 3] = ex2(fmaf(sacc[4 * j + 3], scale_log2, -mn_b));
    sum_a += sacc[4 * j] + sacc[4 * j + 1];
    sum_b += sacc[4 * j + 2] + sacc[4 * j + 3];
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// P rounded to bf16, as P.V's A fragments: for the 16 keys of step kk,
// n-tiles 2 kk and 2 kk + 1 of S (the accumulator layout of S and the
// A-fragment layout of P.V coincide).
__device__ __forceinline__ void wg_to_p(const float (&sacc)[kWgBN / 2],
                                        uint32_t (&pf)[kWgBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// Producer: key tile kt of K or V into its stage of the ring, once the
// consumers have released the stage's previous tile.
template <int kDh>
__device__ __forceinline__ void wg_load_kv(const CUtensorMap* map,
                                           uint8_t* ring, uint64_t* full,
                                           uint64_t* empty, int kt, int hk,
                                           int bi) {
  using C = WgCfg<kDh>;
  const int st = kt % C::kStages;
  hopper::mbar_wait(&empty[st], ((kt / C::kStages) & 1) ^ 1);
  hopper::mbar_expect_tx(&full[st], C::kKvBytes);
#pragma unroll
  for (int bx = 0; bx < C::kBoxes; ++bx) {
    hopper::tma_load_4d(ring + st * C::kKvBytes + bx * kWgBN * kRowBytes,
                        map, &full[st], bx * kBoxCols, hk, kt * kWgBN, bi);
  }
}

template <int kDh>
__global__ void __launch_bounds__(WgCfg<kDh>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int s, int h, int kvh,
                   float scale_log2) {
  using C = WgCfg<kDh>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles.
  const uint32_t raw = hopper::smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* ks = qs + C::kQBytes;
  uint8_t* vs = ks + kStages * C::kKvBytes;

  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest tiles first
  const int bi = blockIdx.x / h;
  const int hq = blockIdx.x % h;
  const int hk = hq / (h / kvh);
  constexpr int kConsumers = C::kConsumers;
  const int q0 = qt * C::kBM;
  // Key tiles from the first to the last that holds a key <= the block's
  // last row (and < s): every consumer walks them all.
  const int n_tiles =
      min((q0 + C::kBM + kWgBN - 1) / kWgBN, (s + kWgBN - 1) / kWgBN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&k_full[st], 1);
      hopper::mbar_init(&v_full[st], 1);
      hopper::mbar_init(&k_empty[st], 4 * kConsumers);
      hopper::mbar_init(&v_empty[st], 4 * kConsumers);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread starts every load.
    hopper::reg_dealloc<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensor_map(&tq);
      hopper::prefetch_tensor_map(&tk);
      hopper::prefetch_tensor_map(&tv);
      hopper::mbar_expect_tx(&q_full, C::kQBytes);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        hopper::tma_load_4d(qs + bx * C::kBM * kRowBytes, &tq, &q_full,
                            bx * kBoxCols, hq, q0, bi);
      }
      // K runs one tile ahead of V: a consumer needs tile kt + 1's K
      // (Q.K^T) before tile kt's V (P.V).
      wg_load_kv<kDh>(&tk, ks, k_full, k_empty, 0, hk, bi);
      for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) {
          wg_load_kv<kDh>(&tk, ks, k_full, k_empty, kt + 1, hk, bi);
        }
        wg_load_kv<kDh>(&tv, vs, v_full, v_empty, kt, hk, bi);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns rows q0 + 64 c .. q0 + 64 c + 63.
    hopper::reg_alloc<C::kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / kWarp;
    const int lane = tid % kWarp;
    const int quad = lane & 3;
    const int row_a = q0 + 64 * c + 16 * warp + (lane >> 2);
    const int row_b = row_a + 8;
    // Named barrier 1 + c is this warpgroup's turn at the tensor cores;
    // it hands the next turn to the next consumer, round robin.
    const int bar_mine = 1 + c;
    const int bar_next = 1 + (c + 1) % kConsumers;
    // A key tile needs the elementwise mask once it holds a key above
    // this warpgroup's first row.
    const int row0 = q0 + 64 * c;
    const uint32_t q_addr = hopper::smem_u32(qs) + 64 * c * kRowBytes;
    const uint32_t k_addr = hopper::smem_u32(ks);
    const uint32_t v_addr = hopper::smem_u32(vs);

    float sacc[kWgBN / 2];
    float oacc[kDh / 2];
    uint32_t pf[kWgBN / 16][4];
#pragma unroll
    for (int i = 0; i < kDh / 2; ++i) oacc[i] = 0.0f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
    float alpha_a, alpha_b;

    if (c == 0) hopper::bar_arrive(1, 256);  // the first turn is mine
    hopper::mbar_wait(&q_full, 0);

    // Tile 0: S only.
    hopper::mbar_wait(&k_full[0], 0);
    hopper::bar_sync(bar_mine, 256);
    wg_start_qk<kDh>(sacc, q_addr, k_addr);
    hopper::bar_arrive(bar_next, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    wg_softmax(sacc, kWgBN - 1 > row0, 0, row_a, quad, scale_log2, m_a,
               m_b, l_a, l_b, alpha_a, alpha_b);
    wg_to_p(sacc, pf);

    for (int kt = 1; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      const int pst = (kt - 1) % kStages;
      hopper::mbar_wait(&k_full[st], (kt / kStages) & 1);
      hopper::bar_sync(bar_mine, 256);
      wg_start_qk<kDh>(sacc, q_addr, k_addr + st * C::kKvBytes);
      wg_rescale<kDh>(oacc, alpha_a, alpha_b);
      hopper::mbar_wait(&v_full[pst], ((kt - 1) / kStages) & 1);
      wg_start_pv<kDh>(oacc, pf, v_addr + pst * C::kKvBytes);
      hopper::bar_arrive(bar_next, 256);
      hopper::wgmma_wait<1>();  // S of tile kt is in; P.V still runs
      hopper::fence_regs(sacc);
      if (lane == 0) hopper::mbar_arrive(&k_empty[st]);
      const int key0 = kt * kWgBN;
      wg_softmax(sacc, key0 + kWgBN - 1 > row0, key0, row_a, quad,
                 scale_log2, m_a, m_b, l_a, l_b, alpha_a, alpha_b);
      hopper::wgmma_wait<0>();  // P.V is done with pf and V's stage
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(&v_empty[pst]);
      wg_to_p(sacc, pf);
    }

    // The last tile's P.V.  The last consumer skips its last hand-over, so
    // that every bar.sync is matched and no arrival is left pending.
    const int lst = (n_tiles - 1) % kStages;
    wg_rescale<kDh>(oacc, alpha_a, alpha_b);
    hopper::mbar_wait(&v_full[lst], ((n_tiles - 1) / kStages) & 1);
    hopper::bar_sync(bar_mine, 256);
    wg_start_pv<kDh>(oacc, pf, v_addr + lst * C::kKvBytes);
    if (c != kConsumers - 1) hopper::bar_arrive(bar_next, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(kFull, l_a, off);
      l_b += __shfl_xor_sync(kFull, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f);
    const float den_b = fmaxf(l_b, 1e-30f);
    const int64_t q_stride = static_cast<int64_t>(h) * kDh;
    __nv_bfloat16* ob =
        o + (static_cast<int64_t>(bi) * s * h + hq) * kDh;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      const int d = j * 8 + 2 * quad;
      if (row_a < s) {
        *reinterpret_cast<uint32_t*>(ob + row_a * q_stride + d) =
            pack_bf16(oacc[4 * j] / den_a, oacc[4 * j + 1] / den_a);
      }
      if (row_b < s) {
        *reinterpret_cast<uint32_t*>(ob + row_b * q_stride + d) =
            pack_bf16(oacc[4 * j + 2] / den_b, oacc[4 * j + 3] / den_b);
      }
    }
  }
}

// ------------------------------------------------------------- f32 body --

constexpr int kFaRows = 4;   // query rows a thread owns (S and O)
constexpr int kFaGroup = 8;  // lanes sharing those rows
constexpr int kLdP = kFaBN + 1;

template <int kDh>
constexpr size_t flash_f32_smem() {
  // q and k tiles padded by one float a row (conflict-free column reads),
  // the v tile, and the p tile.
  return sizeof(float) *
         (static_cast<size_t>(kFaBM + kFaBN) * (kDh + 1) + kFaBN * kDh +
          kFaBM * kLdP);
}

template <int kDh>
__global__ void __launch_bounds__(kFaThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s,
                 int h, int kvh, float scale) {
  constexpr int kLd = kDh + 1;
  constexpr int kCols = kDh / kFaGroup;  // O columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;               // [kFaBM][kLd]
  float* ks = qs + kFaBM * kLd;   // [kFaBN][kLd]
  float* vs = ks + kFaBN * kLd;   // [kFaBN][kDh]
  float* ps = vs + kFaBN * kDh;   // [kFaBM][kLdP]

  const FaBlock fb = fa_block(s, h, kvh, kDh);
  const int64_t q_stride = static_cast<int64_t>(h) * kDh;
  const int64_t kv_stride = static_cast<int64_t>(kvh) * kDh;
  const float* qb = q + fb.q_off;
  const float* kb = k + fb.kv_off;
  const float* vb = v + fb.kv_off;
  const int tid = threadIdx.x;
  const int cg = tid % kFaGroup;          // keys cg + 8 j, columns cg + 8 j
  const int r0 = (tid / kFaGroup) * kFaRows;  // rows r0 .. r0 + 3 (local)
  const int q0 = fb.qt * kFaBM;

  for (int idx = tid; idx < kFaBM * kDh; idx += kFaThreads) {
    const int r = idx / kDh;
    const int c = idx % kDh;
    qs[r * kLd + c] = q0 + r < s ? qb[(q0 + r) * q_stride + c] : 0.0f;
  }

  float acc[kFaRows][kCols];
  float m[kFaRows], l[kFaRows];
#pragma unroll
  for (int i = 0; i < kFaRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt <= fb.qt; ++kt) {
    const int key0 = kt * kFaBN;
    __syncthreads();  // q is staged; the previous tile is done with
    for (int idx = tid; idx < kFaBN * kDh; idx += kFaThreads) {
      const int r = idx / kDh;
      const int c = idx % kDh;
      const bool in = key0 + r < s;
      const int64_t off = (key0 + r) * kv_stride + c;
      ks[r * kLd + c] = in ? kb[off] : 0.0f;
      vs[r * kDh + c] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    float sc[kFaRows][kFaBN / kFaGroup];
#pragma unroll
    for (int i = 0; i < kFaRows; ++i) {
#pragma unroll
      for (int j = 0; j < kFaBN / kFaGroup; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < kDh; ++d) {
      float a[kFaRows], b[kFaBN / kFaGroup];
#pragma unroll
      for (int i = 0; i < kFaRows; ++i) a[i] = qs[(r0 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kFaBN / kFaGroup; ++j) {
        b[j] = ks[(cg + kFaGroup * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kFaRows; ++i) {
#pragma unroll
        for (int j = 0; j < kFaBN / kFaGroup; ++j) {
          sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
        }
      }
    }

    const bool diag = kt == fb.qt;
#pragma unroll
    for (int i = 0; i < kFaRows; ++i) {
      const int row = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kFaBN / kFaGroup; ++j) {
        float x = sc[i][j] * scale;
        if (diag && key0 + cg + kFaGroup * j > row) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kFaGroup; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kFaBN / kFaGroup; ++j) {
        const float p = expf(sc[i][j] - mn);
        sum += p;
        ps[(r0 + i) * kLdP + cg + kFaGroup * j] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // p's rows are written and read by the same 8 lanes

#pragma unroll 4
    for (int key = 0; key < kFaBN; ++key) {
      float p[kFaRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kFaRows; ++i) p[i] = ps[(r0 + i) * kLdP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        vv[c] = vs[key * kDh + cg + kFaGroup * c];
      }
#pragma unroll
      for (int i = 0; i < kFaRows; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
        }
      }
    }
  }

  float* ob = o + fb.q_off;
#pragma unroll
  for (int i = 0; i < kFaRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < kFaGroup; off <<= 1) {
      li += __shfl_xor_sync(kFull, li, off);
    }
    const float den = fmaxf(li, 1e-30f);
    const int row = q0 + r0 + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      ob[row * q_stride + cg + kFaGroup * c] = acc[i][c] / den;
    }
  }
}

constexpr int kMaxDevices = 64;

// The body a call ran (must match kernels/flash_attention.py BODIES).
enum Body : int { kSimt = 0, kMmaSync = 1, kWgmma = 2 };

struct FaLaunch {
  int dtype;
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, s, h, kvh;
  float scale;
  int device;
  cudaStream_t stream;
};

// Raises the kernel's dynamic shared memory limit to `bytes`, once per
// device (above 48 KB only after opting in).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices],
                   int device) {
  if (done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = true;
  return err;
}

dim3 fa_grid(const FaLaunch& a, int rows) {
  return dim3(static_cast<unsigned>(a.b * a.h),
              static_cast<unsigned>((a.s + rows - 1) / rows));
}

// The map of a bf16 (b, s, heads, dh) tensor as the 4-D tensor {dh, heads,
// s, b} (innermost first), boxes of {64, 1, rows, 1} with the 128-byte
// swizzle: one head's rows of a 64-column slice.  s and b are separate
// dimensions, so a box that runs past s is zero-filled and never reads the
// next batch.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int b, int s,
                       int heads, int dh, int rows) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kDh>
cudaError_t launch_wgmma(const FaLaunch& a) {
  CUtensorMap tq, tk, tv;
  using C = WgCfg<kDh>;
  cudaError_t err = tensor_map(&tq, a.q, a.b, a.s, a.h, kDh, C::kBM);
  if (err == cudaSuccess) {
    err = tensor_map(&tk, a.k, a.b, a.s, a.kvh, kDh, kWgBN);
  }
  if (err == cudaSuccess) {
    err = tensor_map(&tv, a.v, a.b, a.s, a.kvh, kDh, kWgBN);
  }
  if (err != cudaSuccess) return err;
  constexpr size_t smem = C::kSmem;
  static bool opted_in[kMaxDevices] = {};
  err = opt_in(flash_wgmma_kernel<kDh>, smem, opted_in, a.device);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<kDh><<<fa_grid(a, C::kBM), C::kThreads, smem,
                            a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.s, a.h, a.kvh,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <int kDh>
cudaError_t launch_flash(const FaLaunch& a, int* body) {
  if (a.dtype == kBF16) {
    if constexpr (kDh == 64 || kDh == 128) {
      *body = kWgmma;
      return launch_wgmma<kDh>(a);
    } else {
      *body = kMmaSync;
      flash_bf16_kernel<kDh><<<fa_grid(a, kFaBM), kFaThreads, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v),
          static_cast<__nv_bfloat16*>(a.o), a.s, a.h, a.kvh,
          a.scale * kLog2e);
      return cudaGetLastError();
    }
  }
  *body = kSimt;
  constexpr size_t smem = flash_f32_smem<kDh>();
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err =
      opt_in(flash_f32_kernel<kDh>, smem, opted_in, a.device);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<kDh><<<fa_grid(a, kFaBM), kFaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.s, a.h,
      a.kvh, a.scale);
  return cudaGetLastError();
}

// The instance for head_dim dh: every multiple of 16 from kDh up to 128.
template <int kDh>
cudaError_t dispatch_head_dim(int dh, const FaLaunch& a, int* body) {
  if (dh == kDh) return launch_flash<kDh>(a, body);
  if constexpr (kDh < 128) {
    return dispatch_head_dim<kDh + 16>(dh, a, body);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// C entry: o (b, s, h, dh) = causal attention of q (b, s, h, dh) over k, v
// (b, s, kv, dh), all row-major, 16-byte aligned and of one dtype; h a
// multiple of kv; dh a multiple of 16 up to 128; scale the score scale
// (dh^-0.5).  Launches on `stream` without synchronising, writes the body
// it launched (0 SIMT f32, 1 mma.sync bf16, 2 wgmma bf16) to *body and
// returns cudaGetLastError() (or the error that kept it from launching:
// a tensor map that does not encode, a refused shared-memory opt-in).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int b, int s, int h, int kvh, int dh,
                                     float scale, int device, void* stream,
                                     int* body) {
  using namespace repro;
  *body = -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!known_dtype(dtype) || b <= 0 || s <= 0 || h <= 0 || kvh <= 0 ||
      h % kvh != 0 || dh % 16 != 0 || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (addr_bits % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t grid_x = static_cast<int64_t>(b) * h;
  const int64_t grid_y = (static_cast<int64_t>(s) + kFaBM - 1) / kFaBM;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FaLaunch a{dtype, q, k, v, o, b, s, h, kvh, scale, device,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_head_dim<16>(dh, a, body));
}
