"""CSR sparse matrix on torch tensors.

The paper's input format: compressed sparse row.  ``row_ptr`` has ``m+1``
entries, ``col_ind``/``vals`` have ``nnz_pad`` entries (``nnz_pad`` is a
trailing pad — padded entries carry ``col_ind = 0`` and ``vals = 0`` so
every kernel can consume them harmlessly).  Shape ``(m, k)`` is plain
metadata.  All three arrays live on one device; structure arrays are
int32, as in the JAX reference (``repro.core.csr``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class CSR:
    """Sparse m×k matrix in CSR format (paper §2.2)."""

    row_ptr: torch.Tensor  # (m + 1,) int32, row_ptr[m] == nnz_true
    col_ind: torch.Tensor  # (nnz_pad,) int32, padded with 0
    vals: torch.Tensor     # (nnz_pad,) dtype, padded with 0
    shape: tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz_pad(self) -> int:
        """The (padded) nonzero capacity."""
        return self.col_ind.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def nnz(self) -> int:
        """True number of nonzeroes (reads one value from the device)."""
        return int(self.row_ptr[-1])

    def row_lengths(self) -> torch.Tensor:
        return torch.diff(self.row_ptr)

    def to_dense(self) -> torch.Tensor:
        """Densify (oracle / small matrices only)."""
        m, k = self.shape
        nnz = self.nnz()
        rows = rows_from_row_ptr(self.row_ptr, nnz).long()
        dense = torch.zeros((m, k), dtype=self.vals.dtype,
                            device=self.device)
        dense.index_put_((rows, self.col_ind[:nnz].long()),
                         self.vals[:nnz], accumulate=True)
        return dense


def rows_from_row_ptr(row_ptr: torch.Tensor, nnz_pad: int) -> torch.Tensor:
    """Expand row_ptr to a per-nonzero int32 row-id vector.

    The CSR→COO flattening the paper calls ``PrepareSpmm`` (Algorithm 1
    line 21), done with a vectorized binary search.  Padded tail entries
    receive row id ``m`` (one past the last row).
    """
    rp = row_ptr.to(torch.int64)
    ids = torch.arange(nnz_pad, dtype=torch.int64, device=rp.device)
    return (torch.searchsorted(rp, ids, right=True) - 1).to(torch.int32)


def from_dense(dense, nnz_pad: int | None = None) -> CSR:
    """Build CSR from a dense matrix (tensor or array) on its device."""
    dense = torch.as_tensor(dense)
    m, k = dense.shape
    mask = dense != 0
    counts = mask.sum(dim=1)
    row_ptr = torch.zeros(m + 1, dtype=torch.int64, device=dense.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    if nnz_pad is None:
        nnz_pad = max(nnz, 1)
    if nnz_pad < nnz:
        raise ValueError(f"nnz_pad {nnz_pad} < nnz {nnz}")
    rows, cols = torch.nonzero(mask, as_tuple=True)
    col_ind = torch.zeros(nnz_pad, dtype=torch.int32, device=dense.device)
    vals = torch.zeros(nnz_pad, dtype=dense.dtype, device=dense.device)
    col_ind[:nnz] = cols.to(torch.int32)
    vals[:nnz] = dense[rows, cols]
    return CSR(row_ptr.to(torch.int32), col_ind, vals, (m, k))


def random_csr(seed: int, m: int, k: int, *, nnz_per_row,
               dtype=torch.float32, pad_to: int | None = None,
               device="cpu") -> CSR:
    """Random CSR with controllable irregularity (tests and benchmarks).

    ``nnz_per_row`` is an int (regular rows) or a (lo, hi) tuple (uniform
    irregular rows — the paper's Type 1/2 imbalance source); ``pad_to``
    sets a padded nonzero capacity.  Drawn with
    ``numpy.random.default_rng(seed)`` in the reference's order, so the
    same seed gives the same matrix as ``repro.core.random_csr`` fed that
    numpy seed.
    """
    rng = np.random.default_rng(seed)
    if isinstance(nnz_per_row, tuple):
        lo, hi = nnz_per_row
        lengths = rng.integers(lo, hi + 1, size=m)
    else:
        lengths = np.full(m, int(nnz_per_row))
    lengths = np.minimum(lengths, k).astype(np.int64)
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    nnz_pad = max(nnz if pad_to is None else pad_to, 1)
    if nnz_pad < nnz:
        raise ValueError(f"pad_to {pad_to} < nnz {nnz}")
    col_ind = np.zeros(nnz_pad, np.int32)
    vals = np.zeros(nnz_pad, np.float64)
    for r in range(m):
        s, e = row_ptr[r], row_ptr[r + 1]
        if e > s:
            col_ind[s:e] = np.sort(rng.choice(k, size=e - s, replace=False))
    vals[:nnz] = rng.standard_normal(nnz)
    return CSR(torch.as_tensor(row_ptr, device=device),
               torch.as_tensor(col_ind, device=device),
               torch.as_tensor(vals, device=device).to(dtype), (m, k))


def prune_to_csr(w: torch.Tensor, keep_fraction: float) -> CSR:
    """Magnitude-prune a dense weight to CSR on its device (paper §1 [1]).

    Keeps the top ``keep_fraction`` of entries *per row* (``torch.topk`` of
    |w|, then the kept column indices sorted), so every row has the same
    nonzero count.  On tie-free data this keeps exactly the set of the
    reference's ``np.argsort(-abs(w))[:, :keep]``.
    """
    m, k = w.shape
    keep = max(1, min(int(round(keep_fraction * k)), k))
    idx = torch.topk(w.abs(), keep, dim=1, sorted=False).indices
    idx = torch.sort(idx, dim=1).values
    vals = torch.gather(w, 1, idx)
    row_ptr = torch.arange(m + 1, dtype=torch.int32, device=w.device) * keep
    return CSR(row_ptr, idx.reshape(-1).to(torch.int32),
               vals.reshape(-1).contiguous(), (m, k))
