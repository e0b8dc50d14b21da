"""Merge-based (nonzero-split) SpMM.  Paper §4.2.

* **Phase 1** (:func:`plan_merge_structure`, torch ops on the pattern's
  device): assign an equal number ``T`` of nonzeroes per chunk, breaking
  chunks at ``TM``-row output tiles.  The arrays are element-for-element
  those of the reference planner (``repro.kernels.merge_spmm``), so plans
  of the two packages compare with ``array_equal``.
* **Phase 2** (:func:`merge_spmm_cuda`): the hand-written CUDA kernel in
  ``csrc/merge_spmm.cu``.  One warp per (batch, chunk, 128-column slice)
  accumulates its chunk's rows in registers and carries them out into a
  zeroed float32 C with atomics; a second launch applies the fused
  epilogue and casts.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.merge_execute_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSR, rows_from_row_ptr

from . import _cuda

TM = 8
DEFAULT_T = 16

# Launches of the merge kernel, one per merge_spmm_cuda call that ran it.
LAUNCHES = 0
# Launches of its second kernel, the elementwise epilogue and cast, one per
# call with an epilogue or a non-float32 output.
EPILOGUE_LAUNCHES = 0


def plan_merge_structure(a: CSR, *, t: int = DEFAULT_T, tm: int = TM):
    """Phase 1, pattern-only: equal-nonzero chunks broken at TM-row tiles.

    Depends only on ``row_ptr``/``col_ind``, never on ``vals``: values are
    re-applied per call through ``slot_nz``.  Returns a dict of int32
    tensors on the pattern's device:

      cols    (C, t)  column index of each nonzero in each chunk
      lrow    (C, t)  row offset within the TM-row tile, in [0, tm)
      slot_nz (C, t)  flat nonzero id feeding each slot, or ``nnz_pad`` (a
                      sentinel that reads a zero) for unused slots
      tile    (C,)    output row-tile of the chunk (non-decreasing)
      first   (C,)    1 iff chunk is the first of its row tile
      last    (C,)    1 iff chunk is the last of its row tile
    where C = nnz_pad//t + ceil(m/tm) (the static worst case).
    """
    m, nnz_pad = a.m, a.nnz_pad
    dev = a.device
    i32, i64 = torch.int32, torch.int64
    if m == 0:
        # Degenerate 0-row pattern: no output tiles, no valid nonzeroes.
        n_chunks = max(1, -(-nnz_pad // t))
        zeros = torch.zeros((n_chunks, t), dtype=i32, device=dev)
        edge = torch.zeros(n_chunks, dtype=i32, device=dev)
        first, last = edge.clone(), edge.clone()
        first[0] = 1
        last[-1] = 1
        return dict(cols=zeros, lrow=zeros.clone(),
                    slot_nz=torch.full((n_chunks, t), nnz_pad, dtype=i32,
                                       device=dev),
                    tile=edge, first=first, last=last)
    n_tiles_m = -(-m // tm)
    n_chunks = -(-nnz_pad // t) + n_tiles_m

    nz_ids = torch.arange(nnz_pad, dtype=i64, device=dev)
    rows = rows_from_row_ptr(a.row_ptr, nnz_pad).to(i64)  # pads → m
    tile_of_nz = torch.clamp(rows // tm, max=n_tiles_m - 1)
    # nonzero count per row tile, and each nonzero's rank within its tile
    # (tile_of_nz is non-decreasing: CSR order, pads at the end).
    tile_starts = torch.searchsorted(
        tile_of_nz, torch.arange(n_tiles_m, dtype=i64, device=dev))
    tile_counts = torch.diff(
        tile_starts, append=torch.tensor([nnz_pad], dtype=i64, device=dev))
    pos_in_tile = nz_ids - tile_starts[tile_of_nz]
    # chunks per tile: ceil(count/t), at least 1 so every row tile is
    # visited; exclusive prefix sum.
    chunks_per_tile = torch.clamp(-(-tile_counts // t), min=1)
    cum = torch.cumsum(chunks_per_tile, 0)            # inclusive prefix
    chunks_before = cum - chunks_per_tile
    dest_chunk = chunks_before[tile_of_nz] + pos_in_tile // t
    dest_slot = pos_in_tile % t

    # Padded nonzeroes keep their slots (reserved via the last tile's
    # count) but contribute column 0 and the sentinel value slot.
    valid = nz_ids < a.nnz()
    inb = dest_chunk < n_chunks                        # the ref's "drop"
    dc, ds, ok = dest_chunk[inb], dest_slot[inb], valid[inb]
    cols = torch.zeros((n_chunks, t), dtype=i32, device=dev)
    cols[dc, ds] = torch.where(ok, a.col_ind[inb], 0).to(i32)
    slot_nz = torch.full((n_chunks, t), nnz_pad, dtype=i32, device=dev)
    slot_nz[dc, ds] = torch.where(ok, nz_ids[inb], nnz_pad).to(i32)
    lrow = torch.zeros((n_chunks, t), dtype=i32, device=dev)
    lrow[dc, ds] = torch.where(ok, rows[inb] % tm, 0).to(i32)

    # chunk -> row tile (non-decreasing); unused tail chunks point at the
    # last tile so the stream stays monotone.
    chunk_ids = torch.arange(n_chunks, dtype=i64, device=dev)
    tile_of_chunk = torch.searchsorted(cum, chunk_ids, right=True)
    used = chunk_ids < cum[-1]
    tile_of_chunk = torch.clamp(tile_of_chunk, max=n_tiles_m - 1)
    tile = torch.where(used, tile_of_chunk, n_tiles_m - 1).to(i32)
    change = (tile[1:] != tile[:-1]).to(i32)
    one = torch.ones(1, dtype=i32, device=dev)
    return dict(cols=cols, lrow=lrow, slot_nz=slot_nz, tile=tile,
                first=torch.cat([one, change]),
                last=torch.cat([change, one]))


def apply_vals(structure: dict, vals: torch.Tensor) -> torch.Tensor:
    """Gather per-call values into a structure's slots (chunk or ELL
    layout); ``slot_nz == nnz_pad`` slots read an appended zero."""
    vals_ext = torch.cat([vals, vals.new_zeros(1)])
    return vals_ext[structure["slot_nz"].long()]


def merge_spmm_cuda(structure: dict, vals: torch.Tensor, b: torch.Tensor,
                    m: int, *, epilogue=None, bias=None, residual=None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Phase 2 on the card: ``b`` (batch, k, n) row-major → C (batch, m, n).

    ``structure`` is :func:`plan_merge_structure`'s output on ``b``'s
    device, ``vals`` the raw (nnz_pad,) values (gathered in-kernel through
    ``slot_nz``).  ``epilogue`` with ``bias (m,)`` / ``residual
    (batch, m, n)`` per its flags is applied after all partial sums are
    in, in float32, with one cast to ``out_dtype`` (default: b's dtype).
    Launches on the current stream without synchronising; raises on any
    operand the kernel does not take.
    """
    global LAUNCHES, EPILOGUE_LAUNCHES
    if not b.is_cuda:
        raise ValueError(
            f"merge_spmm_cuda runs on CUDA tensors; b is on {b.device} "
            "(the plain version is kernels.ref.merge_execute_ref)")
    dev = b.device
    floats = tuple(_cuda.DTYPE_CODES)
    n_chunks, t = structure["cols"].shape
    if b.dim() != 3:
        raise ValueError(f"b must be (batch, k, n), got {tuple(b.shape)}")
    batch, k, n = b.shape
    if t > 32:
        raise ValueError(f"the merge kernel takes chunks of at most 32 "
                         f"nonzeroes (one warp); this plan has t={t}")
    for name in ("cols", "lrow", "slot_nz"):
        _cuda.require(structure[name], name, device=dev,
                      dtypes=(torch.int32,), shape=(n_chunks, t))
    _cuda.require(structure["tile"], "tile", device=dev,
                  dtypes=(torch.int32,), shape=(n_chunks,))
    _cuda.require(vals, "vals", device=dev, dtypes=floats)
    _cuda.require(b, "b", device=dev, dtypes=floats)
    out_dtype = b.dtype if out_dtype is None else out_dtype
    if out_dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"the merge kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    bias, residual, act, has_scale, scale = _cuda.epilogue_args(
        epilogue, bias, residual, device=dev, m=m, batch=batch, n=n)
    lib = _cuda.library()
    stream = _cuda.stream_of(b)
    scratch = torch.zeros((batch, m, n), dtype=torch.float32, device=dev)
    _cuda.check(lib.repro_merge_spmm(
        structure["cols"].data_ptr(), structure["lrow"].data_ptr(),
        structure["slot_nz"].data_ptr(), structure["tile"].data_ptr(),
        vals.data_ptr(), _cuda.DTYPE_CODES[vals.dtype], b.data_ptr(),
        _cuda.DTYPE_CODES[b.dtype], scratch.data_ptr(), batch, n_chunks, t,
        TM, vals.shape[0], m, k, n, dev.index, stream), "merge_spmm")
    LAUNCHES += 1
    if epilogue is None and out_dtype == torch.float32:
        return scratch
    out = torch.empty((batch, m, n), dtype=out_dtype, device=dev)
    _cuda.check(lib.repro_merge_epilogue(
        scratch.data_ptr(), _cuda.ptr(bias), _cuda.ptr(residual), act,
        has_scale, scale, out.data_ptr(), _cuda.DTYPE_CODES[out_dtype],
        batch, m, n, dev.index, stream), "merge_spmm epilogue")
    EPILOGUE_LAUNCHES += 1
    return out
