"""SpMM kernels: the pattern planners, the CUDA kernel wrappers, their
plain PyTorch versions, the plan-execute ops and the method registry.

Importing ``registry`` and ``rowgroup_spmm`` here registers the built-in
and the row-grouped methods, so ``from repro_torch.kernels import
registry`` always sees the full method table."""
from . import registry, rowgroup_spmm  # noqa: F401
