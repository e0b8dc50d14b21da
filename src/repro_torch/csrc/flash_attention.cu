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
// the diagonal to zero updates.  Here one thread block owns 64 query rows
// of one (batch, head) and loops over the key tiles itself, from the first
// to the diagonal tile, so no tile above the diagonal is visited and only
// the diagonal tile is masked elementwise (skipping is exact: those tiles
// add exp(NEG_INF - m) = 0).  The query tiles with the most key tiles are
// launched first (the grid's slow axis runs the tiles in reverse), so the
// short tiles fill the card's tail: the paper's load balancing in
// miniature.  The KV head h / g and the (b, s, h, dh) strides are read in
// place: no broadcast, fold or padding copy.  Two bodies, dh a template
// parameter (every multiple of 16 up to 128):
//
// * bf16 (the model path): each of the 4 warps owns 16 query rows.  Q's
//   fragments stay in registers for the whole key loop; K and V tiles of
//   64 keys are staged in shared memory with 16-byte loads and read with
//   ldmatrix (V transposed by ldmatrix.trans).  S = Q.K^T and O += P.V run
//   on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators in
//   registers).  The running max m and sum l are f32, one per row; the
//   softmax works in the exp2 domain (the scale times log2 e folded into
//   one multiply after the dot product).  P is rounded to bf16 for P.V, as
//   the reference rounds p to v's type, and goes from the S accumulators
//   to the A fragments of P.V in registers (the two layouts coincide).
// * f32: SIMT FMA.  Q, K, V and P tiles in shared memory (dynamic, above
//   48 KB at dh 64 and up); each thread owns 4 query rows x 8 keys of S
//   and 4 rows x dh / 8 columns of O, with the row max and sum reduced
//   over the 8 lanes that share a row.
//
// Keys past s are loaded as zeros and masked by causality; rows past s
// are computed and never written.  NEG_INF is finite (-1e30), as in the
// reference, so no (-inf) - (-inf) makes a NaN.  Later work: cp.async/TMA
// double buffering of K and V, wgmma, and a persistent schedule.
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

struct FaLaunch {
  int dtype;
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, h, kvh;
  float scale;
  dim3 grid;
  int device;
  cudaStream_t stream;
};

template <int kDh>
cudaError_t launch_flash(const FaLaunch& a) {
  if (a.dtype == kBF16) {
    flash_bf16_kernel<kDh><<<a.grid, kFaThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<__nv_bfloat16*>(a.o), a.s, a.h, a.kvh,
        a.scale * kLog2e);
    return cudaGetLastError();
  }
  constexpr size_t smem = flash_f32_smem<kDh>();
  // Above 48 KB only after opting in, once per device.
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[a.device] = true;
  }
  flash_f32_kernel<kDh><<<a.grid, kFaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.s, a.h,
      a.kvh, a.scale);
  return cudaGetLastError();
}

// The instance for head_dim dh: every multiple of 16 from kDh up to 128.
template <int kDh>
cudaError_t dispatch_head_dim(int dh, const FaLaunch& a) {
  if (dh == kDh) return launch_flash<kDh>(a);
  if constexpr (kDh < 128) {
    return dispatch_head_dim<kDh + 16>(dh, a);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// C entry: o (b, s, h, dh) = causal attention of q (b, s, h, dh) over k, v
// (b, s, kv, dh), all row-major, 16-byte aligned and of one dtype; h a
// multiple of kv; dh a multiple of 16 up to 128; scale the score scale
// (dh^-0.5).  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype,
                                     int b, int s, int h, int kvh, int dh,
                                     float scale, int device, void* stream) {
  using namespace repro;
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
  const FaLaunch a{dtype, q, k, v, o, s, h, kvh, scale,
                   dim3(static_cast<unsigned>(grid_x),
                        static_cast<unsigned>(grid_y)),
                   device, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_head_dim<16>(dh, a));
}
