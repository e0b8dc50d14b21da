"""Grouped (expert) GEMM with merge-based load balancing.

The paper's nonzero-split principle applied to MoE: the token→expert
routing matrix is sparse, hot experts are its long rows and cold experts
its short ones.  Sorting token-replicas by expert puts the problem in CSR
order; padding each expert's group to the token tile ``TT`` plays the role
of the paper's chunk breaks; every block then holds an equal number of
tokens and one expert, whatever the routing skew.

* :func:`plan_groups` (torch ops on the sizes' device): the pattern-only
  step, block → expert, element-for-element the reference's.
* :func:`moe_group_gemm_cuda`: the hand-written CUDA kernel in
  ``csrc/moe_gemm.cu``, the expert read from ``block_expert`` in device
  memory, three bodies chosen by (dtype, tt, d_in, d_out) and alignment
  (:func:`body_for`):

  - ``wgmma``, bf16 with tt a multiple of 64, d_in a positive multiple of
    8, d_out a multiple of 8 and 16-byte aligned operands (the MoE path):
    persistent blocks walk (64-row, 128-column) tiles; a producer warp
    keeps a ring of x and W tiles in flight by TMA and one consumer
    warpgroup multiplies them with ``wgmma``;
  - ``wmma``, the other bf16 calls (the reference's tt-8 sweep, ragged tt
    or d): a block per (64-row slice of a token block, 128 columns),
    32-deep k tiles through WMMA fragments;
  - ``simt``, float32: the same tiles with FMA outside the tensor cores.

  Each masks ragged ``d_in``/``d_out`` edges itself, so nothing is padded
  to the TPU's 512/128 tiles.  Its plain PyTorch version is
  ``repro_torch.kernels.ref.moe_group_gemm_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

TT = 64    # tokens per block (the merge chunk)

# The kernel's bodies, by the code its C entry reports
# (csrc/moe_gemm.cu, enum MoeBody).
BODIES = ("simt", "wmma", "wgmma")
WGMMA_ROWS = 64      # a wgmma tile's rows: tt must be a multiple
ALIGN = 8            # d_in, d_out multiples of 8 bf16: TMA's 16-byte strides

# Launches of the grouped GEMM kernel, one per moe_group_gemm_cuda call
# that ran it, and the same launches by the body that ran.
LAUNCHES = 0
LAUNCHES_BY_BODY: dict[str, int] = {}


def body_for(dtype: torch.dtype, tt: int, d_in: int, d_out: int, *,
             aligned: bool = True) -> str:
    """The body the kernel runs for operands of ``dtype`` at block size
    ``tt`` and widths ``d_in``, ``d_out`` (``aligned``: x, w and out start
    on 16-byte boundaries): ``wgmma`` for bfloat16 when tt is a multiple of
    64, d_in a positive multiple of 8 and d_out a multiple of 8, ``wmma``
    for the other bfloat16 calls, ``simt`` for float32."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if (tt % WGMMA_ROWS == 0 and d_in > 0 and d_in % ALIGN == 0
            and d_out % ALIGN == 0 and aligned):
        return "wgmma"
    return "wmma"


def plan_groups(group_sizes: torch.Tensor, tokens_pad: int,
                tt: int = TT) -> torch.Tensor:
    """Map each block of ``tt`` sorted tokens to its expert.

    ``group_sizes`` (E,) are *padded* group sizes, each a multiple of
    ``tt`` and summing to ``tokens_pad``.  Returns ``block_expert``
    (tokens_pad // tt,) int32 on the sizes' device: empty groups own no
    block, and a block past the last group maps to E.
    """
    n_blocks = tokens_pad // tt
    ends = torch.cumsum(group_sizes, 0)
    starts = torch.arange(n_blocks, dtype=ends.dtype,
                          device=group_sizes.device) * tt
    return torch.searchsorted(ends, starts, right=True).to(torch.int32)


def moe_group_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                        block_expert: torch.Tensor, *,
                        tt: int = TT) -> torch.Tensor:
    """The kernel on the card: ``y[i] = x[i] @ w[block_expert[i // tt]]``.

    ``x`` (tokens_pad, d_in) and ``w`` (E, d_in, d_out), row-major, both
    float32 or both bfloat16; ``block_expert`` (tokens_pad // tt,) int32.
    Accumulates in float32 and writes (tokens_pad, d_out) in x's dtype; a
    block whose expert is out of range is written as zeros.  Launches on
    the current stream without synchronising; raises on any operand the
    kernel does not take, and on a call that would need a gradient.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "moe_group_gemm_cuda has no backward: the reference's grouped "
            "GEMM op has no VJP either; train through the batched matmul "
            "(moe_apply(..., use_kernel=False)), or call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if not x.is_cuda:
        raise ValueError(
            f"moe_group_gemm_cuda runs on CUDA tensors; x is on {x.device} "
            "(the plain version is kernels.ref.moe_group_gemm_ref)")
    dev = x.device
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be (tokens, d_in) and w (E, d_in, d_out), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    tokens, d_in = x.shape
    n_experts, _, d_out = w.shape
    if tt <= 0 or tokens % tt:
        raise ValueError(f"tokens {tokens} is not a multiple of tt={tt}")
    floats = tuple(_cuda.DTYPE_CODES)
    _cuda.require(x, "x", device=dev, dtypes=floats)
    _cuda.require(w, "w", device=dev, dtypes=(x.dtype,),
                  shape=(n_experts, d_in, d_out))
    _cuda.require(block_expert, "block_expert", device=dev,
                  dtypes=(torch.int32,), shape=(tokens // tt,))
    out = torch.empty((tokens, d_out), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    body = ctypes.c_int(-1)
    _cuda.check(_cuda.library().repro_moe_gemm(
        x.data_ptr(), w.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
        block_expert.data_ptr(), out.data_ptr(), tokens, d_in, d_out,
        n_experts, tt, dev.index, _cuda.stream_of(x), ctypes.byref(body)),
        "moe_gemm")
    name = BODIES[body.value]
    LAUNCHES += 1
    LAUNCHES_BY_BODY[name] = LAUNCHES_BY_BODY.get(name, 0) + 1
    return out
