"""Named corpus suites: the matrices the autotuner sweeps.

A :class:`MatrixSpec` is a lazily built, seed-deterministic matrix with a
stable name — the unit the TuneDB records and ``python -m
repro_torch.tune`` iterates.  The specs and suites are the reference's
(``repro.matrices.suites``), under the same names and seeds, so both
packages tune the same patterns:

* ``mini`` — 3 matrices (one per major regime), the CI smoke corpus,
* ``paper`` — 18 matrices spanning the paper's Fig. 6 spectrum: power-law
  graphs, banded stencils, block-sparse pruned weights, and the uniform
  regular/irregular sweep, across the merge/row-split crossover,
* ``pruned`` — block-pruning masks at serving-like shapes.

``specs_from_mtx_dir`` turns a directory of ``.mtx`` files into specs, so
on-disk corpora go through the same tuning pipeline.
"""
from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable

from repro_torch.core.csr import CSR

from . import generators as G
from .mmio import read_mtx


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    build: Callable[[], CSR]     # deterministic: same spec → same pattern
    family: str = "synthetic"

    def __call__(self) -> CSR:
        return self.build()


_SPECS: dict[str, MatrixSpec] = {}
_SUITES: dict[str, tuple[str, ...]] = {}


def register_spec(spec: MatrixSpec) -> MatrixSpec:
    if spec.name in _SPECS:
        raise ValueError(f"duplicate matrix spec name: {spec.name!r}")
    _SPECS[spec.name] = spec
    return spec


def register_suite(name: str, spec_names: tuple[str, ...]) -> None:
    missing = [s for s in spec_names if s not in _SPECS]
    if missing:
        raise ValueError(f"suite {name!r} references unknown specs "
                         f"{missing}")
    _SUITES[name] = tuple(spec_names)


def suite_names() -> list[str]:
    return sorted(_SUITES)


def get_suite(name: str) -> list[MatrixSpec]:
    if name not in _SUITES:
        raise KeyError(f"unknown suite {name!r}; available: "
                       f"{suite_names()}")
    return [_SPECS[s] for s in _SUITES[name]]


def specs_from_mtx_dir(path: str | os.PathLike) -> list[MatrixSpec]:
    """One spec per ``.mtx`` file in ``path`` (sorted, non-recursive)."""
    specs = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".mtx"):
            continue
        full = os.path.join(path, fname)
        specs.append(MatrixSpec(name=os.path.splitext(fname)[0],
                                build=lambda p=full: read_mtx(p),
                                family="mtx"))
    return specs


# ----------------------------------------------------- built-in corpus ---
#
# The reference sized these shapes for CPU timing budgets; on the H100
# most are launch-bound (chip_smoke.py adds card-sized specs for the
# crossover).  d sweeps from ~2 (deep merge territory) past the paper's
# 9.35 into row-split territory (d >= 16).

def _spec(name: str, family: str, fn: Callable[[], CSR]) -> None:
    register_spec(MatrixSpec(name=name, build=fn, family=family))


_spec("mini_powlaw", "graph", lambda: G.power_law(11, 512, 512, 4.0))
_spec("mini_banded", "stencil", lambda: G.banded(12, 768, 768, 3))
_spec("mini_uniform", "uniform", lambda: G.uniform(13, 256, 1024, 24))

_spec("graph_powlaw_sparse", "graph",
      lambda: G.power_law(21, 2048, 2048, 3.0))
_spec("graph_powlaw_mid", "graph",
      lambda: G.power_law(22, 2048, 2048, 8.0))
_spec("graph_powlaw_dense", "graph",
      lambda: G.power_law(23, 1024, 2048, 24.0))
_spec("graph_powlaw_heavy_tail", "graph",
      lambda: G.power_law(24, 2048, 2048, 6.0, alpha=1.2))

_spec("stencil_tri", "stencil", lambda: G.banded(31, 4096, 4096, 1))
_spec("stencil_band9", "stencil", lambda: G.banded(32, 2048, 2048, 4))
_spec("stencil_band33", "stencil", lambda: G.banded(33, 1024, 1024, 16))
_spec("stencil_band_loose", "stencil",
      lambda: G.banded(34, 2048, 2048, 12, fill=0.5))

_spec("pruned_block8_10pct", "pruned",
      lambda: G.block_sparse(41, 1024, 1024, block=8, keep=0.10))
_spec("pruned_block16_25pct", "pruned",
      lambda: G.block_sparse(42, 1024, 1024, block=16, keep=0.25))
_spec("pruned_block4_50pct", "pruned",
      lambda: G.block_sparse(43, 512, 2048, block=4, keep=0.50))

_spec("uniform_d2", "uniform", lambda: G.uniform(51, 2048, 4096, 2))
_spec("uniform_d8", "uniform", lambda: G.uniform(52, 2048, 4096, 8))
_spec("uniform_d32", "uniform", lambda: G.uniform(53, 1024, 4096, 32))
_spec("uniform_irr_d4", "uniform",
      lambda: G.uniform_irregular(54, 2048, 4096, 4))
_spec("uniform_irr_d16", "uniform",
      lambda: G.uniform_irregular(55, 1024, 4096, 16))
_spec("tall_skinny_d6", "uniform",
      lambda: G.uniform_irregular(56, 8192, 1024, 6))
_spec("short_wide_d48", "uniform",
      lambda: G.uniform(57, 256, 8192, 48))

register_suite("mini", ("mini_powlaw", "mini_banded", "mini_uniform"))
register_suite("paper", (
    "graph_powlaw_sparse", "graph_powlaw_mid", "graph_powlaw_dense",
    "graph_powlaw_heavy_tail",
    "stencil_tri", "stencil_band9", "stencil_band33", "stencil_band_loose",
    "pruned_block8_10pct", "pruned_block16_25pct", "pruned_block4_50pct",
    "uniform_d2", "uniform_d8", "uniform_d32",
    "uniform_irr_d4", "uniform_irr_d16",
    "tall_skinny_d6", "short_wide_d48",
))
register_suite("pruned", (
    "pruned_block8_10pct", "pruned_block16_25pct", "pruned_block4_50pct",
))
