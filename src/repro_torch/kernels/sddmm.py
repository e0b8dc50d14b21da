"""Sampled dense-dense matmul (SDDMM): the values cotangent of C = A @ B.

    dvals[p] = dC[rows[p], :] · B[cols[p], :]      for each nonzero p

the gather-dot dual of the forward SpMM.  :func:`sddmm_cuda` wraps the
hand-written CUDA kernel in ``csrc/sddmm.cu``: one warp per (batch
element, run of 32 nonzeros), lanes over n, a warp-shuffle reduction.  It
takes the plan's (nnz_pad,) coordinate streams as they are and any n: the
TPU kernel's ``TQ`` chunks of the nonzero stream and its 128-lane padding
of n are Pallas layout with no meaning here.  Its plain PyTorch version is
``repro_torch.kernels.ref.sddmm_ref``.
"""
from __future__ import annotations

import torch

from . import _cuda

# Launches of the SDDMM kernel, one per sddmm_cuda call that ran it.
LAUNCHES = 0


def sddmm_cuda(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
               dc3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: ``dc3`` (batch, m, n) and ``b3``
    (batch, k, n), row-major, f32 or bf16 → float32 (batch, nnz_pad) dots,
    per batch element, 0 in every slot where ``valid`` is False.

    ``rows``/``cols`` (nnz_pad,) int32 are in-bounds everywhere (padded
    slots carry (0, 0)); ``valid`` (nnz_pad,) bool.  The caller casts and
    reduces over the batch.  Launches on the current stream without
    synchronising; raises on any operand the kernel does not take.
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
    _cuda.check(_cuda.library().repro_sddmm(
        rows.data_ptr(), cols.data_ptr(), valid.data_ptr(), dc3.data_ptr(),
        _cuda.DTYPE_CODES[dc3.dtype], b3.data_ptr(),
        _cuda.DTYPE_CODES[b3.dtype], out.data_ptr(), batch, nnz_pad, m, k, n,
        dev.index, _cuda.stream_of(dc3)), "sddmm")
    LAUNCHES += 1
    return out
