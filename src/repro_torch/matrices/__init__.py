"""Matrix corpus of the port: synthetic and on-disk sparsity patterns.

The paper's headline numbers (31.7% geomean speedup, 99.3%-accurate kernel
selection) are claims about real-world matrices — graphs, FEM stencils,
pruned weights.  This package supplies those inputs, as copies of the
reference's ``repro.matrices`` in PyTorch/numpy idiom (the same seeds give
the same patterns):

* ``mmio`` — MatrixMarket ``.mtx`` reader/writer,
* ``generators`` — deterministic synthetic families: power-law (graph),
  banded (stencil), block-sparse (pruned weight), uniform (regular /
  irregular),
* ``stats`` — row-length statistics: mean ``d`` (the §5.4 heuristic
  axis), coefficient of variation, Gini imbalance, max row length,
* ``suites`` — the named suites ``mini``, ``paper`` and ``pruned`` that
  the autotuner (``repro_torch.tune``) iterates, plus
  ``specs_from_mtx_dir`` for on-disk corpora.
"""
from .generators import (banded, block_sparse, power_law, uniform,
                         uniform_irregular)
from .mmio import read_mtx, write_mtx
from .stats import MatrixStats, compute_stats
from .suites import (MatrixSpec, get_suite, register_spec, register_suite,
                     specs_from_mtx_dir, suite_names)

__all__ = [
    "banded", "block_sparse", "power_law", "uniform", "uniform_irregular",
    "read_mtx", "write_mtx",
    "MatrixStats", "compute_stats",
    "MatrixSpec", "get_suite", "register_spec", "register_suite",
    "specs_from_mtx_dir", "suite_names",
]
