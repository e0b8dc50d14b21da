"""Row-splitting SpMM.  Paper §4.1.

* **Phase 0** (:func:`plan_rowsplit_structure`, torch ops on the pattern's
  device): scatter the CSR pattern into ELL-padded ``(m_pad, L)`` slot
  arrays, L = the longest row rounded up to ``TL``.  Element-for-element
  the reference planner's arrays (``repro.kernels.rowsplit_spmm``).
* **The kernel** (:func:`rowsplit_spmm_cuda`): the hand-written CUDA
  kernel in ``csrc/rowsplit_spmm.cu`` — one warp per (batch, row,
  128-column slice), (col, value) broadcast by ``__shfl_sync``, coalesced
  row-major B loads, the fused epilogue at the single C write.  It takes
  any ELL slot block (:func:`ell_slots`), which the row-grouped method
  reuses per length bucket.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.rowsplit_execute_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSR

from . import _cuda

TM = 8
DEFAULT_TL = 16

# Launches of the row-split kernel, one per rowsplit_spmm_cuda call.
LAUNCHES = 0


def ell_slots(a: CSR, rows: torch.Tensor, l: int, *, tm: int = TM) -> dict:
    """ELL slot block ``{cols, slot_nz}`` for a row subset, padded to tm.

    ``rows`` (r,) selects the rows; each is laid out over ``l`` slots.
    Invalid slots carry ``slot_nz == nnz_pad`` — the sentinel that reads a
    zero value — and the column gather is sentinel-extended so a 0-nnz
    pattern (empty ``col_ind``) stays constructible.
    """
    i32, i64 = torch.int32, torch.int64
    dev = a.device
    rows = rows.to(i64)
    row_ptr = a.row_ptr.to(i64)
    lengths = torch.diff(row_ptr)
    idx = torch.arange(l, dtype=i64, device=dev)
    take = row_ptr[rows][:, None] + idx[None, :]          # (r, l)
    valid = idx[None, :] < lengths[rows][:, None]
    safe = torch.where(valid, take, 0)
    col_ext = torch.cat([a.col_ind, a.col_ind.new_zeros(1)])
    cols = torch.where(valid, col_ext[safe], 0).to(i32)
    slot_nz = torch.where(valid, take, a.nnz_pad).to(i32)
    r = rows.shape[0]
    pad_rows = tm * (-(-r // tm)) - r
    cols = torch.nn.functional.pad(cols, (0, 0, 0, pad_rows))
    slot_nz = torch.nn.functional.pad(slot_nz, (0, 0, 0, pad_rows),
                                      value=a.nnz_pad)
    return dict(cols=cols, slot_nz=slot_nz)


def plan_rowsplit_structure(a: CSR, *, l_pad: int, tl: int = DEFAULT_TL,
                            tm: int = TM) -> dict:
    """Phase 0, pattern-only: ELL slot structure (m_pad, L), L = l_pad↑tl.

    ``l_pad`` must be an upper bound on the longest row.  Values are
    re-applied per call through ``slot_nz``.
    """
    l = max(tl, tl * (-(-l_pad // tl)))
    rows = torch.arange(a.m, dtype=torch.int64, device=a.device)
    return ell_slots(a, rows, l, tm=tm)


def rowsplit_spmm_cuda(structure: dict, vals: torch.Tensor,
                       b: torch.Tensor, m: int, *, epilogue=None,
                       bias=None, residual=None,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel on the card: ``b`` (batch, k, n) row-major → C
    (batch, m, n) over the ELL block ``structure`` (``cols``/``slot_nz``
    (m_pad, L), m_pad >= m).

    ``vals`` are the raw (nnz_pad,) values, gathered in-kernel through
    ``slot_nz``; ``epilogue`` with ``bias (m,)`` / ``residual
    (batch, m, n)`` per its flags is applied in float32 at the single
    write, cast to ``out_dtype`` (default: b's dtype).  Launches on the
    current stream without synchronising; raises on any operand the
    kernel does not take.
    """
    global LAUNCHES
    if not b.is_cuda:
        raise ValueError(
            f"rowsplit_spmm_cuda runs on CUDA tensors; b is on {b.device} "
            "(the plain version is kernels.ref.rowsplit_execute_ref)")
    dev = b.device
    floats = tuple(_cuda.DTYPE_CODES)
    m_pad, l = structure["cols"].shape
    if m_pad < m:
        raise ValueError(f"structure has {m_pad} rows, C has {m}")
    if b.dim() != 3:
        raise ValueError(f"b must be (batch, k, n), got {tuple(b.shape)}")
    batch, k, n = b.shape
    for name in ("cols", "slot_nz"):
        _cuda.require(structure[name], name, device=dev,
                      dtypes=(torch.int32,), shape=(m_pad, l))
    _cuda.require(vals, "vals", device=dev, dtypes=floats)
    _cuda.require(b, "b", device=dev, dtypes=floats)
    out_dtype = b.dtype if out_dtype is None else out_dtype
    if out_dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"the row-split kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    bias, residual, act, has_scale, scale = _cuda.epilogue_args(
        epilogue, bias, residual, device=dev, m=m, batch=batch, n=n)
    lib = _cuda.library()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=dev)
    _cuda.check(lib.repro_rowsplit_spmm(
        structure["cols"].data_ptr(), structure["slot_nz"].data_ptr(),
        vals.data_ptr(), _cuda.DTYPE_CODES[vals.dtype], b.data_ptr(),
        _cuda.DTYPE_CODES[b.dtype], _cuda.ptr(bias), _cuda.ptr(residual),
        act, has_scale, scale, out.data_ptr(), _cuda.DTYPE_CODES[out_dtype],
        batch, m, l, vals.shape[0], k, n, dev.index, _cuda.stream_of(b)),
        "rowsplit_spmm")
    LAUNCHES += 1
    return out
