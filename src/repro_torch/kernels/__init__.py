"""SpMM kernels: the pattern planners, the CUDA kernel wrappers, their
plain PyTorch versions, the plan-execute ops and the method registry."""
