"""Row-splitting SpMM.  Paper §4.1.

* **Phase 0** (:func:`plan_rowsplit_structure`, torch ops on the pattern's
  device): scatter the CSR pattern into ELL-padded ``(m_pad, L)`` slot
  arrays, L = the longest row rounded up to ``TL``.  Element-for-element
  the reference planner's arrays (``repro.kernels.rowsplit_spmm``).
* **The kernel** (:func:`rowsplit_spmm_cuda`): the hand-written CUDA
  kernel in ``csrc/rowsplit_spmm.cu`` -- one warp per (batch, row,
  128-column slice), slots 32 at a time with the next 32 prefetched,
  (col, value) broadcast by ``__shfl_sync``, 16-byte row-major B loads
  (the bodies of ``_cuda.body_for``), the fused epilogue at the single C
  write.  A row's walk stops at its first group of 32 slots with a dead
  slot (the ELL prefix property of :func:`ell_slots`), and a short, wide
  matrix splits each row's groups into :func:`row_parts` parts whose
  partials one block sums in part order.  It takes any ELL slot block
  (:func:`ell_slots`), which the row-grouped method reuses per length
  bucket.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.rowsplit_execute_ref``;
  ``ref.rowsplit_schedule_ref`` replays its schedule in tensor ops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.csr import CSR

from . import _cuda

TM = 8
DEFAULT_TL = 16

# Parts of a row: more warps for a matrix of few rows, within one wave.
# The kernel holds 4 blocks of 8 warps an SM (its register cap); a row's
# groups of 32 slots split in up to MAX_PARTS parts (the warps of a
# block), each of at least MIN_PART_GROUPS groups.  At Llama-3.2-1B's FFN
# shapes (n = 128) on 132 SMs: w1 (8192 rows of 512) runs 8192 warps,
# r = 1; w2 (2048 rows of 2048) 2048 warps, r = 2, 4096 warps (on the
# H100, r = 2 was the fastest of 1, 2, 4 and 8 at w2).
RESIDENT_WARPS_PER_SM = 32
MAX_PARTS = 8
MIN_PART_GROUPS = 4

# Slots of one block of rows that plan_rowsplit_structure fills at once.
ELL_BLOCK_SLOTS = 1 << 26

# Launches of the row-split kernel, one per rowsplit_spmm_cuda call, and
# the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def ell_slots(a: CSR, rows: torch.Tensor, l: int, *, tm: int = TM) -> dict:
    """ELL slot block ``{cols, slot_nz}`` for a row subset, padded to tm.

    ``rows`` (r,) selects the rows; each is laid out over ``l`` slots.
    Invalid slots carry ``slot_nz == nnz_pad`` — the sentinel that reads a
    zero value — and the column gather is sentinel-extended so a 0-nnz
    pattern (empty ``col_ind``) stays constructible.

    The prefix property, a contract of the structure that the kernel
    relies on: each row's live slots (``slot_nz < nnz_pad``) come first,
    in CSR order, and every slot after the first dead one is dead (pad rows
    are all dead).  So the kernel ends a row at its first group of 32
    slots that holds a dead slot.
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
    m_pad = tm * (-(-a.m // tm))
    cols = torch.zeros((m_pad, l), dtype=torch.int32, device=a.device)
    slot_nz = torch.full((m_pad, l), a.nnz_pad, dtype=torch.int32,
                         device=a.device)
    # ell_slots' int64 (rows, l) temporaries are 8x the block they fill:
    # a block of rows at a time keeps them near ELL_BLOCK_SLOTS slots, so
    # a skewed matrix whose ELL fills much of the card still plans.
    block = max(1, ELL_BLOCK_SLOTS // l)
    for r0 in range(0, a.m, block):
        rows = torch.arange(r0, min(r0 + block, a.m), dtype=torch.int64,
                            device=a.device)
        part = ell_slots(a, rows, l, tm=1)
        cols[r0:r0 + rows.numel()] = part["cols"]
        slot_nz[r0:r0 + rows.numel()] = part["slot_nz"]
    return dict(cols=cols, slot_nz=slot_nz)


def row_parts(m: int, n: int, l: int, batch: int, sm_count: int) -> int:
    """r, the parts the kernel splits each row's ``ceil(l / 32)`` groups
    of slots into: doubled from 1 while the launch's ``batch * m *
    ceil(n / 128) * 2 r`` warps would still fit one wave (``sm_count *
    RESIDENT_WARPS_PER_SM``), up to MAX_PARTS and while each part keeps
    at least MIN_PART_GROUPS groups."""
    warps = batch * m * -(-n // 128)
    groups = -(-l // 32)
    r = 1
    while (r < MAX_PARTS
           and warps * 2 * r <= sm_count * RESIDENT_WARPS_PER_SM
           and groups >= 2 * r * MIN_PART_GROUPS):
        r *= 2
    return r


def rowsplit_spmm_cuda(structure: dict, vals: torch.Tensor,
                       b: torch.Tensor, m: int, *, epilogue=None,
                       bias=None, residual=None,
                       out_dtype: torch.dtype | None = None,
                       parts: int | None = None) -> torch.Tensor:
    """The kernel on the card: ``b`` (batch, k, n) row-major → C
    (batch, m, n) over the ELL block ``structure`` (``cols``/``slot_nz``
    (m_pad, L), m_pad >= m).

    ``vals`` are the raw (nnz_pad,) values, gathered in-kernel through
    ``slot_nz``; ``epilogue`` with ``bias (m,)`` / ``residual
    (batch, m, n)`` per its flags is applied in float32 at the single
    write, cast to ``out_dtype`` (default: b's dtype).  ``parts`` (1, 2,
    4 or 8; default :func:`row_parts` on b's device) splits each row's
    slot groups among that many warps.  Launches on the current stream
    without synchronising; raises on any operand the kernel does not take.
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
    if parts is None:
        parts = row_parts(m, n, l, batch, _cuda.sm_count(dev))
    if parts not in (1, 2, 4, 8):
        raise ValueError(f"parts must be 1, 2, 4 or 8, got {parts}")
    bias, residual, act, has_scale, scale = _cuda.epilogue_args(
        epilogue, bias, residual, device=dev, m=m, batch=batch, n=n)
    lib = _cuda.library()
    out = torch.empty((batch, m, n), dtype=out_dtype, device=dev)
    body = ctypes.c_int(-1)
    _cuda.check(lib.repro_rowsplit_spmm(
        structure["cols"].data_ptr(), structure["slot_nz"].data_ptr(),
        vals.data_ptr(), _cuda.DTYPE_CODES[vals.dtype], b.data_ptr(),
        _cuda.DTYPE_CODES[b.dtype], _cuda.ptr(bias), _cuda.ptr(residual),
        act, has_scale, scale, out.data_ptr(), _cuda.DTYPE_CODES[out_dtype],
        batch, m, l, vals.shape[0], k, n, parts, dev.index,
        _cuda.stream_of(b), ctypes.byref(body)), "rowsplit_spmm")
    LAUNCHES += 1
    _cuda.count_launch(LAUNCHES_BY_BODY, body.value)
    return out
