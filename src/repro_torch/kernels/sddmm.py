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
