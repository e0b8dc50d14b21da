"""PyTorch/CUDA port of the SpMM engine (the JAX package ``repro`` is the
reference).

Plain tensor code is PyTorch; the paper's two SpMM kernels (merge-based
and row-split) are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use.  Entry points run on ``cuda`` unless the caller
asks for the CPU, where every kernel runs as its plain PyTorch version.
"""
