"""Deterministic synthetic matrix families spanning the paper's regimes.

Each generator is a pure function of an integer ``seed`` (numpy
``default_rng``), drawn in the order of the reference's
``repro.matrices.generators``: the same seed gives the same ``row_ptr`` /
``col_ind`` bytes and the same float32 values in both packages, so a
pattern has one ``pattern_fingerprint`` and a TuneDB record made by
either package names the same matrix.  The arrays are made on the host
and placed on ``device`` (default the CPU).

Families and the regime they cover (Fig. 1 / §5 of the paper):

* :func:`uniform` / :func:`uniform_irregular` — regular rows / mild Type-2
  imbalance,
* :func:`power_law` — heavy-tailed row lengths (web/social graphs), the
  Type-1 imbalance that breaks row-per-warp kernels
  (``core.csr.power_law_csr``),
* :func:`banded` — FEM/stencil diagonals: near-constant short rows, the
  regime where row-split's ELL padding is free,
* :func:`block_sparse` — structured blocks surviving magnitude pruning of
  a weight matrix, the paper's §1 serving use case.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import CSR, _csr_from_lengths
from repro_torch.core.csr import power_law_csr as power_law

__all__ = ["banded", "block_sparse", "power_law", "uniform",
           "uniform_irregular"]


def uniform(seed: int, m: int, k: int, d: int, *, dtype=torch.float32,
            device="cpu") -> CSR:
    """Every row has exactly ``d`` nonzeroes (regular, zero imbalance)."""
    rng = np.random.default_rng(seed)
    return _csr_from_lengths(rng, np.full(m, d), m, k, dtype=dtype,
                             device=device)


def uniform_irregular(seed: int, m: int, k: int, d: int, *,
                      dtype=torch.float32, device="cpu") -> CSR:
    """Row lengths uniform in [0, 2d] (mean ``d``) — mild imbalance."""
    rng = np.random.default_rng(seed)
    return _csr_from_lengths(rng, rng.integers(0, 2 * d + 1, size=m), m, k,
                             dtype=dtype, device=device)


def _csr_from_rows(rng: np.random.Generator, cols_per_row: list, m: int,
                   k: int, dtype, device) -> CSR:
    """Rows with the given (sorted) column arrays, then standard normal
    values drawn from ``rng``."""
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum([c.size for c in cols_per_row], out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    nnz_pad = max(nnz, 1)
    col_ind = np.zeros(nnz_pad, np.int32)
    if nnz:
        col_ind[:nnz] = np.concatenate(cols_per_row)
    vals = np.zeros(nnz_pad, np.float64)
    vals[:nnz] = rng.standard_normal(nnz)
    return CSR(torch.as_tensor(row_ptr, device=device),
               torch.as_tensor(col_ind, device=device),
               torch.as_tensor(vals, device=device).to(dtype), (m, k))


def banded(seed: int, m: int, k: int, band: int, *, fill: float = 1.0,
           dtype=torch.float32, device="cpu") -> CSR:
    """Stencil-style band of half-width ``band`` around the scaled diagonal.

    ``fill < 1`` keeps each in-band entry with that probability (a
    partially assembled FEM operator); ``fill = 1`` is the dense band.
    Rows are near-constant length — the paper's low-variance regime.
    """
    rng = np.random.default_rng(seed)
    cols_per_row = []
    for r in range(m):
        center = int(round(r * (k - 1) / max(m - 1, 1)))
        lo, hi = max(center - band, 0), min(center + band + 1, k)
        cols = np.arange(lo, hi, dtype=np.int32)
        if fill < 1.0:
            cols = cols[rng.random(cols.size) < fill]
        cols_per_row.append(cols)
    return _csr_from_rows(rng, cols_per_row, m, k, dtype, device)


def block_sparse(seed: int, m: int, k: int, *, block: int = 8,
                 keep: float = 0.25, dtype=torch.float32,
                 device="cpu") -> CSR:
    """Block-structured pruning mask: keep whole ``block×block`` tiles.

    Models a magnitude-pruned weight with structured sparsity: a uniform
    ``keep`` fraction of tiles survives; rows inside a surviving tile are
    dense across it.  ``m`` and ``k`` need not divide ``block`` — edge
    tiles are clipped.
    """
    rng = np.random.default_rng(seed)
    mb = (m + block - 1) // block
    kb = (k + block - 1) // block
    mask = rng.random((mb, kb)) < keep
    cols_per_row = []
    for r in range(m):
        tiles = np.nonzero(mask[r // block])[0]
        cols = np.concatenate(
            [np.arange(t * block, min((t + 1) * block, k), dtype=np.int32)
             for t in tiles]) if tiles.size else np.empty(0, np.int32)
        cols_per_row.append(cols)
    return _csr_from_rows(rng, cols_per_row, m, k, dtype, device)
