"""The paper's O(1) kernel-selection heuristic (§5.4).

``d = nnz / m`` (mean row length); ``d < threshold → merge-based`` else
row-split.  The paper calibrates threshold = 9.35 on a K40c; the crossover
is hardware-dependent, so the threshold is a parameter.
"""
from __future__ import annotations

import dataclasses

from .csr import CSR

PAPER_THRESHOLD = 9.35


@dataclasses.dataclass(frozen=True)
class Heuristic:
    threshold: float = PAPER_THRESHOLD

    def mean_row_length(self, a: CSR) -> float:
        # Host-side: the method choice is a plan-time decision.
        return a.nnz() / max(a.m, 1)

    def choose(self, a: CSR) -> str:
        """Return 'merge' or 'rowsplit' per the paper's rule."""
        return "merge" if self.mean_row_length(a) < self.threshold \
            else "rowsplit"
