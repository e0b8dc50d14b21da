"""The paper's O(1) kernel-selection heuristic (§5.4).

``d = nnz / m`` (mean row length); ``d < threshold → merge-based`` else
row-split.  The paper calibrates threshold = 9.35 on a K40c; the crossover
is hardware-dependent, so the threshold is a parameter, and
:func:`calibrate` fits it from measured timings (``repro_torch.tune``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

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


def calibrate(ds: np.ndarray, rowsplit_us: np.ndarray,
              merge_us: np.ndarray) -> tuple[float, float]:
    """Fit the threshold from measured timings.

    Sweeps candidate thresholds over the observed ``d`` values and returns
    ``(best_threshold, accuracy)`` where accuracy is agreement with the
    oracle (pick-the-faster), the paper's 99.3% metric.
    """
    ds = np.asarray(ds, dtype=np.float64)
    oracle_merge = np.asarray(merge_us) < np.asarray(rowsplit_us)
    cands = np.unique(np.concatenate([ds, ds + 1e-9, [0.0, np.inf]]))
    best_thr, best_acc = 0.0, -1.0
    for thr in cands:
        pred_merge = ds < thr
        acc = float(np.mean(pred_merge == oracle_merge))
        if acc > best_acc:
            best_thr, best_acc = float(thr), acc
    return best_thr, best_acc
