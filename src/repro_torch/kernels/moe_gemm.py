"""Grouped (expert) GEMM with merge-based load balancing.

The paper's nonzero-split principle applied to MoE: the token→expert
routing matrix is sparse, hot experts are its long rows and cold experts
its short ones.  Sorting token-replicas by expert puts the problem in CSR
order; padding each expert's group to the token tile ``TT`` plays the role
of the paper's chunk breaks; every block then holds an equal number of
tokens and one expert, whatever the routing skew.

* :func:`plan_groups` (torch ops on the sizes' device): the pattern-only
  step, block → expert, element-for-element the reference's.
* :func:`moe_group_gemm_cuda`: the hand-written CUDA kernel in
  ``csrc/moe_gemm.cu``, the expert read from ``block_expert`` in device
  memory, three bodies chosen by (dtype, tt, d_in, d_out) and alignment
  (:func:`body_for`):

  - ``wgmma``, bf16 with tt a multiple of 64, d_in a positive multiple of
    8, d_out a multiple of 8 and 16-byte aligned operands (the MoE path):
    persistent blocks walk (64-row, 128-column) tiles; a producer warp
    keeps a ring of x and W tiles in flight by TMA and one consumer
    warpgroup multiplies them with ``wgmma``;
  - ``wmma``, the other bf16 calls (the reference's tt-8 sweep, ragged tt
    or d): a block per (64-row slice of a token block, 128 columns),
    32-deep k tiles through WMMA fragments;
  - ``simt``, float32: the same tiles with FMA outside the tensor cores.

  Each masks ragged ``d_in``/``d_out`` edges itself, so nothing is padded
  to the TPU's 512/128 tiles.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.moe_group_gemm_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _cuda

TT = 64    # tokens per block (the merge chunk)

# The kernel's bodies, by the code its C entry reports
# (csrc/moe_gemm.cu, enum MoeBody).
BODIES = ("simt", "wmma", "wgmma")
WGMMA_ROWS = 64      # a wgmma tile's rows: tt must be a multiple
ALIGN = 8            # d_in, d_out multiples of 8 bf16: TMA's 16-byte strides

# Launches of the grouped GEMM kernel, one per moe_group_gemm_cuda call
# that ran it, and the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def body_for(dtype: torch.dtype, tt: int, d_in: int, d_out: int, *,
             aligned: bool = True) -> str:
    """The body the kernel runs for operands of ``dtype`` at block size
    ``tt`` and widths ``d_in``, ``d_out`` (``aligned``: x, w and out start
    on 16-byte boundaries): ``wgmma`` for bfloat16 when tt is a multiple of
    64, d_in a positive multiple of 8 and d_out a multiple of 8, ``wmma``
    for the other bfloat16 calls, ``simt`` for float32."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if (tt % WGMMA_ROWS == 0 and d_in > 0 and d_in % ALIGN == 0
            and d_out % ALIGN == 0 and aligned):
        return "wgmma"
    return "wmma"


def plan_groups(group_sizes: torch.Tensor, tokens_pad: int,
                tt: int = TT) -> torch.Tensor:
    """Map each block of ``tt`` sorted tokens to its expert.

    ``group_sizes`` (E,) are *padded* group sizes, each a multiple of
    ``tt`` and summing to ``tokens_pad``.  Returns ``block_expert``
    (tokens_pad // tt,) int32 on the sizes' device: empty groups own no
    block, and a block past the last group maps to E.
    """
    n_blocks = tokens_pad // tt
    ends = torch.cumsum(group_sizes, 0)
    starts = torch.arange(n_blocks, dtype=ends.dtype,
                          device=group_sizes.device) * tt
    return torch.searchsorted(ends, starts, right=True).to(torch.int32)


def moe_group_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                        block_expert: torch.Tensor, *,
                        tt: int = TT) -> torch.Tensor:
    """The kernel on the card: ``y[i] = x[i] @ w[block_expert[i // tt]]``.

    ``x`` (tokens_pad, d_in) and ``w`` (E, d_in, d_out), row-major, both
    float32 or both bfloat16; ``block_expert`` (tokens_pad // tt,) int32.
    Accumulates in float32 and writes (tokens_pad, d_out) in x's dtype; a
    block whose expert is out of range is written as zeros.  Launches on
    the current stream without synchronising; raises on any operand the
    kernel does not take, and on a call that would need a gradient.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "moe_group_gemm_cuda has no backward: the reference's grouped "
            "GEMM op has no VJP either; train through the batched matmul "
            "(moe_apply(..., use_kernel=False)), or call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if not x.is_cuda:
        raise ValueError(
            f"moe_group_gemm_cuda runs on CUDA tensors; x is on {x.device} "
            "(the plain version is kernels.ref.moe_group_gemm_ref)")
    dev = x.device
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be (tokens, d_in) and w (E, d_in, d_out), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    tokens, d_in = x.shape
    n_experts, _, d_out = w.shape
    if tt <= 0 or tokens % tt:
        raise ValueError(f"tokens {tokens} is not a multiple of tt={tt}")
    floats = tuple(_cuda.DTYPE_CODES)
    _cuda.require(x, "x", device=dev, dtypes=floats)
    _cuda.require(w, "w", device=dev, dtypes=(x.dtype,),
                  shape=(n_experts, d_in, d_out))
    _cuda.require(block_expert, "block_expert", device=dev,
                  dtypes=(torch.int32,), shape=(tokens // tt,))
    out = torch.empty((tokens, d_out), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    body = ctypes.c_int(-1)
    _cuda.check(_cuda.library().repro_moe_gemm(
        x.data_ptr(), w.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
        block_expert.data_ptr(), out.data_ptr(), tokens, d_in, d_out,
        n_experts, tt, dev.index, _cuda.stream_of(x), ctypes.byref(body)),
        "moe_gemm")
    name = BODIES[body.value]
    LAUNCHES += 1
    LAUNCHES_BY_BODY[name] = LAUNCHES_BY_BODY.get(name, 0) + 1
    return out


# ------------------------------------------------------ the launch model ---

# csrc/moe_gemm.cu: the SIMT and WMMA bodies' tiles and threads (kMoeBM,
# kMoeBN, kMoeBK, kMoeThreads, :66-69; no __launch_bounds__ minimum) and
# their static arrays (f32: xs float [32][65], ws float [32][128]; bf16:
# xs bf16 [64][40], ws bf16 [32][136], os float [64][132]); the wgmma
# body's item, stages, threads and dynamic shared memory (kGmBM, kGmBN,
# kGmBK, kGmStages, kGmThreads, kGmSmem, :334-349), its mbarriers
# (uint64 full[4], empty[4]) and __launch_bounds__(kGmThreads, 1).
MOE_BM, MOE_BN, MOE_BK, MOE_THREADS = 64, 128, 32, 256
SMEM_F32 = 4 * 32 * 65 + 4 * 32 * 128
SMEM_BF16 = 2 * 64 * 40 + 2 * 32 * 136 + 4 * 64 * 132
GM_BM, GM_BN, GM_BK, GM_STAGES, GM_THREADS = 64, 128, 64, 4, 128 + 32
GM_STAGE_BYTES = GM_BM * GM_BK * 2 + 2 * GM_BK * 64 * 2
GM_SMEM = GM_STAGES * GM_STAGE_BYTES + GM_BM * (GM_BN + 8) * 2 + 1024
GM_MBARRIERS = 8 * 2 * GM_STAGES


def launch_models(block_expert, *, tokens: int, d_in: int, d_out: int,
                  n_experts: int, dtype, tt: int = TT, card,
                  aligned: bool = True) -> list:
    """The launch of one :func:`moe_group_gemm_cuda` call, as
    ``repro_moe_gemm`` sets it up: the body (:func:`body_for`); for
    ``wgmma`` the persistent grid ``min(items, sms x resident)`` of
    (64-row, 128-column) items (``moe_gemm.cu:584-588``, resident blocks
    an SM by shared memory: one at kGmSmem), otherwise a block per
    (64-row slice of a token block, 128 columns) (``:642-659``).

    Requested bytes: a live block or item reads its x rows and its
    expert's weight columns once over d_in (the wgmma body's TMA boxes
    only inside the tensor), every block or item writes its output tile
    (zeros where the expert is out of range), and each reading warp
    loads its block's expert once."""
    from . import introspect as I
    be = I.host(block_expert)
    if tokens == 0 or d_out == 0 or tokens % tt:
        return []
    dt = I.dtype_name(dtype)
    eb = I.nbytes(dt)
    body = body_for(getattr(torch, dt), tt, d_in, d_out, aligned=aligned)
    live_blk = (be >= 0) & (be < n_experts)
    col_tiles = -(-d_out // MOE_BN)
    tile_cols = np.minimum(MOE_BN, d_out - MOE_BN * np.arange(col_tiles))
    shape = dict(x=(tokens, d_in), w=(n_experts, d_in, d_out),
                 block_expert=(tokens // tt,), out=(tokens, d_out))
    if body == "wgmma":
        items = tokens // GM_BM * col_tiles
        item_blk = np.repeat(np.arange(tokens // GM_BM) * GM_BM // tt,
                             col_tiles)
        item_cols = np.tile(tile_cols, tokens // GM_BM)
        live = live_blk[item_blk]
        resident = card.resident(GM_THREADS,
                                 GM_SMEM + I.static_smem(GM_MBARRIERS))
        grid = (min(items, card.sms * resident), 1, 1)
        reads_be, threads = 5, GM_THREADS      # producer + 4 consumer warps
        symbol, dyn, static, min_blocks = (
            I.template("moe_gemm_wgmma_kernel"), GM_SMEM,
            I.static_smem(GM_MBARRIERS), 1)
        rows = GM_BM
    else:
        row_tiles = -(-tt // MOE_BM)
        n_blocks = tokens // tt
        item_blk = np.repeat(np.arange(n_blocks), row_tiles * col_tiles)
        item_rows = np.tile(np.repeat(np.minimum(
            MOE_BM, tt - MOE_BM * np.arange(row_tiles)), col_tiles),
            n_blocks)
        item_cols = np.tile(tile_cols, n_blocks * row_tiles)
        live = live_blk[item_blk]
        grid = (n_blocks * row_tiles, col_tiles, 1)
        reads_be, threads = MOE_THREADS // 32, MOE_THREADS
        if body == "simt":
            symbol = I.template("moe_gemm_f32_kernel")
            static = I.static_smem(SMEM_F32)
        else:
            symbol = I.template("moe_gemm_bf16_kernel", "true" if _wmma_vec(
                body, d_in, d_out, aligned) else "false")
            static = I.static_smem(SMEM_BF16)
        dyn, min_blocks, rows = 0, 0, item_rows
    x_rows = np.where(live, rows, 0)
    ops = (
        I.OperandAccess("x", dt, shape["x"], "in",
                        read_bytes=eb * d_in * int(x_rows.sum())),
        I.OperandAccess("w", dt, shape["w"], "in", read_bytes=eb * d_in
                        * int(np.where(live, item_cols, 0).sum())),
        I.OperandAccess("block_expert", "int32", shape["block_expert"], "in",
                        read_bytes=4 * reads_be * item_blk.size),
        I.OperandAccess("out", dt, shape["out"], "out", write_bytes=eb
                        * int((rows * item_cols).sum())),
    )
    ops = _moe_lanes(ops, body, d_in, d_out, eb)
    return [I.KernelLaunch(
        label=f"moe_gemm {body}", symbol=symbol, source="moe_gemm.cu",
        grid=grid, block=threads, dynamic_smem=dyn, static_smem=static,
        min_blocks=min_blocks, body=body, operands=ops,
        in_dtypes=(dt, dt), launched=grid[0] > 0)]


def _wmma_vec(body: str, d_in: int, d_out: int,
              aligned: bool = True) -> bool:
    """Whether the WMMA body loads 16-byte chunks (``repro_moe_gemm``'s
    ``vec``)."""
    return body == "wmma" and d_in % 8 == 0 and d_out % 8 == 0 and aligned


def _moe_lanes(ops, body, d_in, d_out, eb):
    """Warp 0's first instructions of item or block 0: its output tile's
    stores (16 bytes a lane in the wgmma and vector WMMA bodies: two rows
    of 16 lanes; one element a lane otherwise), its x tile's loads (the
    wgmma body's TMA box: 64 rows of 128 bytes), and its weight tile's."""
    from . import introspect as I
    if body == "wgmma":
        # idx = tid: row idx / 16, 8 columns at (idx % 16) * 8.
        out = I.WarpAccess("out tile store", tuple(
            I.lanes(r * d_out * eb, 16, 16, range(16)) for r in range(2)))
        box = min(GM_BK, d_in) * eb
        x = I.WarpAccess("x TMA box", tuple(
            ((r * d_in * eb, box),) for r in range(GM_BM)))
        w = I.WarpAccess("w TMA box", tuple(
            ((r * d_out * eb, min(64, d_out) * eb),)
            for r in range(min(GM_BK, d_in))))
    elif _wmma_vec(body, d_in, d_out):
        # 16-byte chunks: x rows of 4 lanes (kMoeBK / 8), w rows of 16.
        out = I.WarpAccess("out tile store", (I.lanes(0, eb, eb),))
        x = I.WarpAccess("x tile load", tuple(
            I.lanes(r * d_in * eb, 16, 16, range(4)) for r in range(8)))
        w = I.WarpAccess("w tile load", tuple(
            I.lanes(r * d_out * eb, 16, 16, range(16)) for r in range(2)))
    else:
        # One element a lane: x rows of kMoeBK, w and out rows of kMoeBN.
        out = I.WarpAccess("out tile store", (I.lanes(
            0, eb, eb, range(min(32, d_out))),))
        x = I.WarpAccess("x tile load", (I.lanes(
            0, eb, eb, range(min(32, d_in))),))
        w = I.WarpAccess("w tile load", (I.lanes(
            0, eb, eb, range(min(32, d_out))),))
    by_name = {"out": (out,), "x": (x,), "w": (w,),
               "block_expert": (I.WarpAccess("expert", (((0, 4),),)),)}
    return tuple(dataclasses.replace(o, warp=by_name[o.name]) for o in ops)
