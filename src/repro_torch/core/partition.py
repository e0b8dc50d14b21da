"""Nonzero-split (merge-based) work partitioning — paper §4, Fig. 2(b).

Phase 1 of the paper's two-phase decomposition (``PartitionSpmm``,
Algorithm 1 line 2): assign an *equal number of nonzeroes* to each
processor/chunk, then binary-search ``row_ptr`` to find which row each
chunk starts in.  The reference's ``repro.core.partition`` on torch
tensors: the same int32 arrays, on the pattern's device.
"""
from __future__ import annotations

import torch

from .csr import CSR, rows_from_row_ptr


def num_chunks(nnz_pad: int, t: int) -> int:
    return max(1, -(-nnz_pad // t))


def partition_spmm(a: CSR, t: int):
    """Nonzero-split partition with T nonzeroes per chunk.

    Returns ``(chunk_start_rows, nnz_rows)``: ``chunk_start_rows[c]`` is
    the row containing nonzero ``c*t`` (the paper's ``limits[]``) and
    ``nnz_rows`` the per-nonzero row id (CSR→COO flattening, the paper's
    ``PrepareSpmm``; padded tail entries get row ``m``).  Both int32.
    """
    n_chunks = num_chunks(a.nnz_pad, t)
    rp = a.row_ptr.to(torch.int64)
    starts = torch.arange(n_chunks, dtype=torch.int64, device=rp.device) * t
    # right=True − 1 gives the row r with row_ptr[r] <= start < row_ptr[r+1].
    chunk_start_rows = (torch.searchsorted(rp, starts, right=True) - 1).to(
        torch.int32)
    return chunk_start_rows, rows_from_row_ptr(a.row_ptr, a.nnz_pad)


def chunk_segments(nnz_rows: torch.Tensor, t: int, m: int):
    """Per-chunk local segment structure for the carry-out scratch.

    For chunk ``c`` covering nonzeroes ``[c*t, (c+1)*t)``, returns
    ``(rows, local, seg_rows)``, each ``(n_chunks, t)`` int32:

    * ``rows``: the row id of each slot (``m`` past the last nonzero);
    * ``local``: rank of each nonzero's row *within* the chunk (0-based
      count of row changes), robust to runs of empty rows;
    * ``seg_rows``: global row id owning each local segment, or ``m`` for
      unused segments.
    """
    n_chunks = num_chunks(nnz_rows.shape[0], t)
    pad = n_chunks * t - nnz_rows.shape[0]
    rows = torch.nn.functional.pad(nnz_rows.to(torch.int32), (0, pad),
                                   value=m).reshape(n_chunks, t)
    change = torch.zeros((n_chunks, t), dtype=torch.int32,
                         device=rows.device)
    change[:, 1:] = (rows[:, 1:] != rows[:, :-1]).to(torch.int32)
    local = torch.cumsum(change, dim=1, dtype=torch.int32)
    seg_rows = torch.full((n_chunks, t), m, dtype=torch.int32,
                          device=rows.device)
    # Within a chunk each local segment holds one row, so every write to a
    # (chunk, segment) cell carries the same value.
    seg_rows.scatter_(1, local.long(), rows)
    return rows, local, seg_rows
