"""MatrixMarket coordinate I/O producing :class:`repro_torch.core.CSR`.

Supports the subset that covers SuiteSparse sparsity corpora: banner
``%%MatrixMarket matrix coordinate {real|integer|pattern}
{general|symmetric|skew-symmetric}``.  Symmetric storage keeps only the
lower (or upper) triangle; the reader expands off-diagonal entries to both
``(i, j)`` and ``(j, i)`` (negated for skew-symmetric), so the returned CSR
always holds the *full* pattern.  Duplicate coordinates are summed, the
assembly convention finite-element exporters rely on.

The writer emits only the true (unpadded) nonzeroes, 1-based, with
``%.17g`` values — a write→read round-trip is exact on the pattern and
bit-exact on float64 values.  Both follow the reference's
``repro.matrices.mmio`` line for line, so a file gives the same CSR in
both packages.
"""
from __future__ import annotations

import io
import os
from collections.abc import Iterable
from typing import IO

import numpy as np
import torch

from repro_torch.core.csr import CSR

_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric")


def _coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                m: int, k: int, dtype, device) -> CSR:
    """Assemble (possibly duplicated, unsorted) COO triplets into CSR."""
    if rows.size:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # Sum duplicates: collapse runs of identical (row, col).
        keep = np.ones(rows.size, bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        if not keep.all():
            seg = np.cumsum(keep) - 1
            summed = np.zeros(int(seg[-1]) + 1, np.float64)
            np.add.at(summed, seg, vals)
            rows, cols, vals = rows[keep], cols[keep], summed
    nnz = rows.size
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    nnz_pad = max(nnz, 1)
    col_ind = np.zeros(nnz_pad, np.int32)
    out_vals = np.zeros(nnz_pad, np.float64)
    col_ind[:nnz] = cols
    out_vals[:nnz] = vals
    return CSR(torch.as_tensor(row_ptr, device=device),
               torch.as_tensor(col_ind, device=device),
               torch.as_tensor(out_vals, device=device).to(dtype), (m, k))


def read_mtx(source: str | os.PathLike | IO[str], *, dtype=torch.float32,
             device="cpu") -> CSR:
    """Read a MatrixMarket coordinate file into a CSR on ``device``.

    ``source`` is a path or an open text stream.  Pattern matrices get
    value 1.0 on every stored entry.
    """
    if hasattr(source, "read"):
        return _read_stream(source, dtype, device)
    with open(source) as f:
        return _read_stream(f, dtype, device)


def _read_stream(f: IO[str], dtype, device) -> CSR:
    banner = f.readline().split()
    if len(banner) < 5 or banner[0] != "%%MatrixMarket" \
            or banner[1].lower() != "matrix":
        raise ValueError(f"not a MatrixMarket matrix file: {banner!r}")
    layout, field, symmetry = (s.lower() for s in banner[2:5])
    if layout != "coordinate":
        raise ValueError(f"only coordinate layout is supported, got "
                         f"{layout!r} (array = dense; densify upstream)")
    if field not in _FIELDS:
        raise ValueError(f"unsupported field {field!r} (supported: "
                         f"{_FIELDS}; complex matrices have no SpMM here)")
    if symmetry not in _SYMMETRIES:
        raise ValueError(f"unsupported symmetry {symmetry!r} "
                         f"(supported: {_SYMMETRIES})")

    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    if not line:
        raise ValueError("missing size line")
    m, k, nnz_decl = (int(tok) for tok in line.split()[:3])

    rows = np.empty(nnz_decl, np.int64)
    cols = np.empty(nnz_decl, np.int64)
    vals = np.ones(nnz_decl, np.float64)
    n = 0
    for line in f:
        toks = line.split()
        if not toks or toks[0].startswith("%"):
            continue
        if n >= nnz_decl:
            raise ValueError(f"more entries than declared ({nnz_decl})")
        rows[n] = int(toks[0]) - 1
        cols[n] = int(toks[1]) - 1
        if field != "pattern":
            vals[n] = float(toks[2])
        n += 1
    if n != nnz_decl:
        raise ValueError(f"declared {nnz_decl} entries, found {n}")
    if n and (rows.min() < 0 or rows.max() >= m
              or cols.min() < 0 or cols.max() >= k):
        raise ValueError(f"entry index out of declared bounds ({m} x {k})")

    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[:n][off]])
        vals = np.concatenate([vals, sign * vals[off]])
    return _coo_to_csr(rows, cols, vals, m, k, dtype, device)


def write_mtx(dest: str | os.PathLike | IO[str], a: CSR, *,
              field: str = "real", comments: Iterable[str] = ()) -> None:
    """Write a CSR as MatrixMarket ``coordinate <field> general``.

    Only the true nonzeroes are emitted (the pad is an in-memory artifact,
    not part of the matrix).  ``field="pattern"`` drops values.
    """
    if field not in _FIELDS:
        raise ValueError(f"unsupported write field {field!r}")
    rp = a.row_ptr.cpu().numpy()
    nnz = int(rp[-1])
    rows = np.repeat(np.arange(a.m, dtype=np.int64), np.diff(rp))
    cols = a.col_ind[:nnz].cpu().numpy()
    vals = a.vals[:nnz].detach().cpu().to(torch.float64).numpy()

    buf = io.StringIO()
    buf.write(f"%%MatrixMarket matrix coordinate {field} general\n")
    for c in comments:
        buf.write(f"% {c}\n")
    buf.write(f"{a.m} {a.k} {nnz}\n")
    if field == "pattern":
        for r, c in zip(rows, cols):
            buf.write(f"{r + 1} {c + 1}\n")
    elif field == "integer":
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{r + 1} {c + 1} {int(round(v))}\n")
    else:
        for r, c, v in zip(rows, cols, vals):
            buf.write(f"{r + 1} {c + 1} {v:.17g}\n")
    text = buf.getvalue()
    if hasattr(dest, "write"):
        dest.write(text)
    else:
        with open(dest, "w") as f:
            f.write(text)
