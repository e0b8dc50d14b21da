"""Per-matrix row-length statistics — the axes the paper plots.

``d`` (mean row length) is the §5.4 heuristic input; the coefficient of
variation and Gini coefficient quantify the Fig. 1 imbalance axis (Type 1:
few long rows; Type 2: many short rows).  They are also the features the
autotuner bins into pattern-class signatures (``repro_torch.tune``), so
they are computed on the host from the concrete pattern, in float64, as
the reference's ``repro.matrices.stats`` computes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csr import CSR


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    m: int
    k: int
    nnz: int
    d: float          # mean row length, the §5.4 heuristic quantity
    cv: float         # std / mean of row lengths (0 = perfectly regular)
    gini: float       # row-length Gini imbalance in [0, 1) (Fig. 1 axis)
    max_len: int      # sets the row-split ELL pad (l_pad)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def compute_stats(a: CSR) -> MatrixStats:
    """Host-side row-length statistics of a CSR (on any device)."""
    lengths = np.diff(a.row_ptr.cpu().numpy()).astype(np.float64)
    nnz = float(lengths.sum())
    d = nnz / max(a.m, 1)
    if nnz > 0:
        cv = float(lengths.std() / d) if d > 0 else 0.0
        sorted_l = np.sort(lengths)
        n = sorted_l.size
        # Gini = sum_i (2i - n - 1) x_(i) / (n * sum(x)), i = 1..n sorted
        ranks = 2.0 * np.arange(1, n + 1, dtype=np.float64) - n - 1.0
        gini = float((ranks * sorted_l).sum() / (n * nnz)) if n else 0.0
        gini = max(gini, 0.0)
    else:
        cv, gini = 0.0, 0.0
    return MatrixStats(m=a.m, k=a.k, nnz=int(nnz), d=d, cv=cv,
                       gini=gini, max_len=int(lengths.max()) if
                       lengths.size else 0)
