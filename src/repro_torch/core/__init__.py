"""Core data types and the SpMM API of the PyTorch port."""
from .config import (DEFAULT_TUNEDB, ExecutionConfig, PlanPolicy,
                     ResolvedPlan, ShardSpec)
from .csr import CSR, from_dense, power_law_csr, prune_to_csr, random_csr
from .epilogue import Epilogue, apply_epilogue
from .heuristic import PAPER_THRESHOLD, Heuristic, calibrate
from .matrix import SparseMatrix
from .partition import chunk_segments, partition_spmm
from .plan import PlanMeta, SpmmPlan, build_plan, pattern_fingerprint
from .spmm import execute_plan, spmm

__all__ = [
    "DEFAULT_TUNEDB", "ExecutionConfig", "PlanPolicy", "ResolvedPlan",
    "ShardSpec",
    "CSR", "from_dense", "power_law_csr", "prune_to_csr", "random_csr",
    "Epilogue", "apply_epilogue",
    "Heuristic", "PAPER_THRESHOLD", "calibrate",
    "SparseMatrix",
    "chunk_segments", "partition_spmm",
    "PlanMeta", "SpmmPlan", "build_plan", "pattern_fingerprint",
    "execute_plan", "spmm",
]
