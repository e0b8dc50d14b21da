"""Core data types and the SpMM API of the PyTorch port."""
from .config import ExecutionConfig, PlanPolicy, ResolvedPlan
from .csr import CSR, from_dense, prune_to_csr, random_csr
from .epilogue import Epilogue, apply_epilogue
from .heuristic import PAPER_THRESHOLD, Heuristic
from .matrix import SparseMatrix
from .plan import PlanMeta, SpmmPlan, build_plan, pattern_fingerprint
from .spmm import execute_plan, spmm

__all__ = [
    "ExecutionConfig", "PlanPolicy", "ResolvedPlan",
    "CSR", "from_dense", "prune_to_csr", "random_csr",
    "Epilogue", "apply_epilogue",
    "Heuristic", "PAPER_THRESHOLD",
    "SparseMatrix",
    "PlanMeta", "SpmmPlan", "build_plan", "pattern_fingerprint",
    "execute_plan", "spmm",
]
