"""Sampled dense-dense matmul (SDDMM): the values cotangent of C = A @ B.

    dvals[p] = dC[rows[p], :] · B[cols[p], :]      for each nonzero p

the gather-dot dual of the forward SpMM.  :func:`sddmm_cuda` wraps the
hand-written CUDA kernel in ``csrc/sddmm.cu``: one warp per (batch
element, ``GROUPS_PER_WORKER`` groups of 32 consecutive nonzeros), the
next group's coordinates prefetched, lanes over n with 16-byte loads (the
bodies of ``_cuda.body_for``), the dC row kept in registers while the CSR
row lasts, the lanes' partials written to a tile in shared memory and one
transposed reduction a group that sums nonzero j's column in lane j.  It
takes the plan's (nnz_pad,) coordinate streams as they are and any n: the
TPU kernel's ``TQ`` chunks of the nonzero stream and its 128-lane padding
of n are Pallas layout with no meaning here.  Its plain PyTorch version is
``repro_torch.kernels.ref.sddmm_ref``; ``ref.sddmm_schedule_ref`` replays
its schedule in tensor ops.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _cuda

# Groups of 32 consecutive nonzeros a worker (a warp) walks: 2048
# nonzeros, so a pruned Llama-3.2-1B FFN matrix (4.2 M nonzeros) gives 2048
# warps, about one wave of 2 blocks of 8 warps (the kernel's register cap)
# on each of 132 SMs.
GROUPS_PER_WORKER = 64

# Launches of the SDDMM kernel, one per sddmm_cuda call that ran it, and
# the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def sddmm_cuda(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
               dc3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: ``dc3`` (batch, m, n) and ``b3``
    (batch, k, n), row-major, f32 or bf16 → float32 (batch, nnz_pad) dots,
    per batch element, 0 in every slot where ``valid`` is False.

    ``rows``/``cols`` (nnz_pad,) int32 are in-bounds everywhere (padded
    slots carry (0, 0)); ``valid`` (nnz_pad,) bool.  The caller casts and
    reduces over the batch.  The body follows ``_cuda.body_for`` of b's
    dtype and n, scalar where dc's dtype is not b's.  Launches on the
    current stream without synchronising; raises on any operand the kernel
    does not take.
    """
    global LAUNCHES
    if not dc3.is_cuda:
        raise ValueError(
            f"sddmm_cuda runs on CUDA tensors; dc is on {dc3.device} "
            "(the plain version is kernels.ref.sddmm_ref)")
    dev = dc3.device
    floats = tuple(_cuda.DTYPE_CODES)
    if dc3.dim() != 3 or b3.dim() != 3:
        raise ValueError(f"dc and b must be (batch, m, n) and (batch, k, n), "
                         f"got {tuple(dc3.shape)} and {tuple(b3.shape)}")
    batch, m, n = dc3.shape
    k = b3.shape[1]
    if b3.shape[0] != batch or b3.shape[2] != n:
        raise ValueError(f"b {tuple(b3.shape)} does not match dc "
                         f"{tuple(dc3.shape)} in batch and n")
    nnz_pad = rows.shape[0]
    for name, t in (("rows", rows), ("cols", cols)):
        _cuda.require(t, name, device=dev, dtypes=(torch.int32,),
                      shape=(nnz_pad,))
    _cuda.require(valid, "valid", device=dev, dtypes=(torch.bool,),
                  shape=(nnz_pad,))
    _cuda.require(dc3, "dc", device=dev, dtypes=floats)
    _cuda.require(b3, "b", device=dev, dtypes=floats)
    out = torch.empty((batch, nnz_pad), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    body = ctypes.c_int(-1)
    _cuda.check(_cuda.library().repro_sddmm(
        rows.data_ptr(), cols.data_ptr(), valid.data_ptr(), dc3.data_ptr(),
        _cuda.DTYPE_CODES[dc3.dtype], b3.data_ptr(),
        _cuda.DTYPE_CODES[b3.dtype], out.data_ptr(), batch, nnz_pad, m, k, n,
        GROUPS_PER_WORKER, dev.index, _cuda.stream_of(dc3),
        ctypes.byref(body)), "sddmm")
    LAUNCHES += 1
    _cuda.count_launch(LAUNCHES_BY_BODY, body.value)
    return out


# ------------------------------------------------------ the launch model ---

# csrc/spmm_common.cuh kBlock, kWarpsPerBlock, kSliceCols (:34-36);
# csrc/sddmm.cu kSddmmBlocksPerSm (its __launch_bounds__) and the static
# arrays group_cols (int32 [8][32]) and red_all (float [8][32][33]).
K_BLOCK, K_WARPS_PER_BLOCK, K_SLICE_COLS = 256, 8, 128
BLOCKS_PER_SM = 2
SMEM_ARRAYS = (4 * K_WARPS_PER_BLOCK * 32, 4 * K_WARPS_PER_BLOCK * 32 * 33)


def launch_models(rows, cols, valid, *, m: int, k: int, n: int,
                  batch: int, dc_dtype, b_dtype) -> list:
    """The launch of one :func:`sddmm_cuda` call over the plan's
    (nnz_pad,) coordinate streams, as the wrapper and ``repro_sddmm``
    set it up (``sddmm.cu:239-252``); [] where none runs (``ops.sddmm``'s
    early-out, an empty output, blocks == 0).

    Requested bytes: every lane of every group loads (row, col, valid)
    once (the next group prefetched inside a worker); each live nonzero
    one b-row slice a slice; the dc slice of a row once a run of equal
    rows (kept across groups while the row and the slice hold); one
    float32 stored a slot."""
    from . import introspect as I
    rows, cols = I.host(rows), I.host(cols)
    valid = I.host(valid).astype(bool)
    nnz_pad = rows.shape[0]
    if nnz_pad == 0 or m == 0 or k == 0 or n == 0 or batch == 0:
        return []
    ddt, bdt = I.dtype_name(dc_dtype), I.dtype_name(b_dtype)
    db, bb = I.nbytes(ddt), I.nbytes(bdt)
    # repro_sddmm: the body (vec_ok needs dc's dtype to be b's), groups,
    # workers, warps and blocks (sddmm.cu :233-240).
    body = _cuda.body_for(getattr(torch, bdt), n) if ddt == bdt \
        else "scalar"
    g = GROUPS_PER_WORKER
    n_groups = -(-nnz_pad // 32)
    workers = -(-n_groups // g)
    blocks = -(-(batch * workers) // K_WARPS_PER_BLOCK)
    n_slices = -(-n // K_SLICE_COLS)
    p = np.flatnonzero(valid)
    grp, worker = p // 32, p // (32 * g)
    same_worker = np.r_[False, worker[1:] == worker[:-1]]
    same_row = np.r_[False, rows[p][1:] == rows[p][:-1]]
    same_grp = np.r_[False, grp[1:] == grp[:-1]]
    # dc slices loaded a slice: one a row change while the row and the
    # slice hold (n <= 128), else one a run of equal rows of a group.
    keep = same_worker if n_slices == 1 else same_grp
    dc_runs = int((~(keep & same_row)).sum())
    ops = [
        I.OperandAccess("rows", "int32", (nnz_pad,), "in",
                        read_bytes=4 * batch * nnz_pad),
        I.OperandAccess("cols", "int32", (nnz_pad,), "in",
                        read_bytes=4 * batch * nnz_pad),
        I.OperandAccess("valid", "uint8", (nnz_pad,), "in",
                        read_bytes=batch * nnz_pad),
        I.OperandAccess("dc", ddt, (batch, m, n), "in",
                        read_bytes=db * n * batch * dc_runs),
        I.OperandAccess("b", bdt, (batch, k, n), "in",
                        read_bytes=bb * n * batch * p.size),
        I.OperandAccess("out", "float32", (batch, nnz_pad), "out",
                        write_bytes=4 * batch * nnz_pad)]
    # Warp 0's first group: coalesced coordinate loads, the b rows of its
    # first nonzero(s) (two half-warps on two in bf16x8), its dc row.
    lanes32 = range(min(32, nnz_pad))
    live0 = p[p < 32]
    b_rows = tuple(int(cols[i]) * n * bb for i in
                   (live0[:1].tolist() + live0[16:17].tolist()))
    by_name = {
        "rows": (I.WarpAccess("group load", (I.lanes(0, 4, 4, lanes32),)),),
        "cols": (I.WarpAccess("group load", (I.lanes(0, 4, 4, lanes32),)),),
        "valid": (I.WarpAccess("group load", (I.lanes(0, 1, 1, lanes32),)),),
        "dc": I.row_loads("dc row", (int(rows[live0[0]]) * n * db,) * 2, n,
                          db, body) if live0.size else (),
        "b": I.row_loads("b row", b_rows, n, bb, body) if live0.size else (),
        "out": (I.WarpAccess("dots", (I.lanes(0, 4, 4, lanes32),)),)}
    ops = [dataclasses.replace(o, warp=by_name[o.name]) for o in ops]

    def indices():
        return [I.IndexStream("rows of live slots (dc rows)", rows[p], m),
                I.IndexStream("cols of live slots (b rows)", cols[p], k)]

    def writers():
        # Lane j of a group's warp stores slot 32 grp + j (< nnz_pad).
        return np.ones((batch, nnz_pad), np.int64)

    def walks():
        return [I.Walk("nonzeros along a worker", worker, p)]

    td, tb = I.CXX_TYPES[ddt], I.CXX_TYPES[bdt]
    return [I.KernelLaunch(
        label="sddmm", symbol=I.template(
            "sddmm_kernel", I.SPMM_BODY_CODES[body], td, tb),
        source="sddmm.cu", grid=(blocks, 1, 1), block=K_BLOCK,
        dynamic_smem=0, static_smem=I.static_smem(*SMEM_ARRAYS),
        min_blocks=BLOCKS_PER_SM,
        body=body, operands=tuple(ops), in_dtypes=(ddt, bdt),
        launched=blocks > 0, writers=writers, walks=walks,
        indices=indices)]
