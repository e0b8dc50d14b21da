"""Plan-execute ops: shapes and dtypes around the kernels, and dispatch.

``merge_execute``/``rowsplit_execute`` execute a prebuilt structure; they
take a dense operand with any
leading batch dims — ``b (..., k, n)`` folds into the kernels' batch axis,
one launch for the whole stack — resolve the accumulator/output dtypes,
keep the degenerate early-outs (m == 0, k == 0, an empty batch) that still
apply the epilogue to C = 0, and dispatch by ``impl``: ``"cuda"`` launches
the hand-written kernel (CUDA tensors only, no fallback), ``"torch"`` runs
its plain version from ``ref.py``.  The kernels mask the ragged n edge
themselves and write (batch, m, n) directly, so nothing is padded here.
``merge_spmm``/``rowsplit_spmm`` are the plan-per-call forms (the
registry's ``inline`` hooks): each builds its structure from the CSR and
executes it, caching nothing.  ``sddmm`` is the backward's values
cotangent, dispatched the same way.
``moe_group_gemm`` is the MoE block's grouped expert GEMM, and
``flash_attention`` causal GQA attention in the reference entry point's
(b, s, h, dh) layout; both dispatch on the tensor's device when ``impl`` is
None.
The reference's ``custom_vmap`` op wrappers have no counterpart: the port
batches through the leading dims of B, one launch for the stack.
"""
from __future__ import annotations

import torch

from repro_torch.core.epilogue import apply_epilogue

from . import flash_attention as _flash
from . import merge_spmm as _merge
from . import moe_gemm as _moe
from . import ref as _ref
from . import rowsplit_spmm as _rowsplit
from . import sddmm as _sddmm


def _resolve_dtypes(vals, b, acc_dtype, out_dtype):
    """(acc, out) dtypes: f32 accumulation and operand promotion defaults."""
    adt = torch.float32 if acc_dtype is None else acc_dtype
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    return adt, odt


def _degenerate(lead, m, n, adt, odt, ep, bias, residual, device):
    """No nonzero contributes, but ``act(0 + bias) * scale + residual`` is
    generally nonzero and must still be produced."""
    c = torch.zeros(lead + (m, n), dtype=adt, device=device)
    if ep is not None:
        bias_col = bias.to(adt)[:, None] if ep.bias else None
        c = apply_epilogue(c, ep, bias_col,
                           residual if ep.residual else None)
    return c.to(odt)


def _kernel_operands(b, ep, residual, lead, m, n, adt):
    """(b3, residual3) for a kernel launch: the batch folded into one
    leading axis, residual broadcast over the batch like b."""
    if adt != torch.float32:
        raise ValueError(f"the CUDA kernels accumulate in float32, not "
                         f"{adt}; use ExecutionConfig(impl='torch')")
    b3 = b.reshape((-1,) + b.shape[-2:])
    res3 = None
    if ep is not None and ep.residual:
        res3 = torch.broadcast_to(residual, lead + (m, n)).reshape(-1, m, n)
        res3 = res3.contiguous()
    return b3, res3


def _execute(kernel, plain, structure, vals, b, m, impl, epilogue, bias,
             residual, acc_dtype, out_dtype):
    lead, n = tuple(b.shape[:-2]), b.shape[-1]
    adt, odt = _resolve_dtypes(vals, b, acc_dtype, out_dtype)
    ep = epilogue
    if m == 0 or b.shape[-2] == 0 or b.numel() == 0:
        return _degenerate(lead, m, n, adt, odt, ep, bias, residual,
                           b.device)
    if impl == "torch":
        res = None if ep is None or not ep.residual else \
            torch.broadcast_to(residual, lead + (m, n))
        return plain(structure, vals, b, m, epilogue=ep, bias=bias,
                     residual=res, acc_dtype=adt, out_dtype=odt)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}; expected 'cuda' or "
                         "'torch'")
    b3, res3 = _kernel_operands(b, ep, residual, lead, m, n, adt)
    out = kernel(structure, vals, b3, m, epilogue=ep, bias=bias,
                 residual=res3, out_dtype=odt)
    return out.reshape(lead + (m, n))


def merge_execute(structure: dict, vals: torch.Tensor, b: torch.Tensor, *,
                  m: int, impl: str, epilogue=None, bias=None,
                  residual=None, acc_dtype=None, out_dtype=None):
    """Execute a prebuilt merge structure: C = A @ B with per-call values.

    ``structure`` is the pattern-only plan from
    ``merge_spmm.plan_merge_structure``; ``vals`` the (nnz_pad,) values of
    the call; ``b (..., k, n) → (..., m, n)``.  ``epilogue`` fuses
    ``act(C + bias) * scale + residual`` (``bias (m,)``, ``residual
    (..., m, n)`` broadcast over the batch).  ``acc_dtype`` (default f32)
    is the accumulation precision, ``out_dtype`` (default: operand
    promotion) the single C write.
    """
    def plain(structure, vals, b, m, **kw):
        return _ref.merge_execute_ref(structure, vals, b, m, _merge.TM,
                                      **kw)

    return _execute(_merge.merge_spmm_cuda, plain, structure, vals, b, m,
                    impl, epilogue, bias, residual, acc_dtype, out_dtype)


def rowsplit_execute(structure: dict, vals: torch.Tensor, b: torch.Tensor,
                     *, m: int, impl: str, epilogue=None, bias=None,
                     residual=None, acc_dtype=None, out_dtype=None):
    """Execute a prebuilt ELL structure: row-split SpMM with per-call
    values.  Arguments as in :func:`merge_execute`."""
    return _execute(_rowsplit.rowsplit_spmm_cuda, _ref.rowsplit_execute_ref,
                    structure, vals, b, m, impl, epilogue, bias, residual,
                    acc_dtype, out_dtype)


def merge_spmm(a, b: torch.Tensor, *, t: int | None = None, impl: str):
    """Merge-based SpMM planned per call: C = A @ B with equal-nonzero
    chunks of ``t`` (default ``DEFAULT_T``); ``b (..., k, n)``."""
    t = _merge.DEFAULT_T if t is None else t
    structure = _merge.plan_merge_structure(a, t=t)
    return merge_execute(structure, a.vals, b, m=a.m, impl=impl)


def rowsplit_spmm(a, b: torch.Tensor, *, l_pad: int, tl: int, impl: str):
    """Row-split SpMM planned per call: C = A @ B over an ELL layout of
    ``l_pad`` slots rounded up to ``tl``, both as the method's
    ``resolve_params`` resolved and checked them (``l_pad`` at least the
    longest row)."""
    structure = _rowsplit.plan_rowsplit_structure(a, l_pad=l_pad, tl=tl)
    return rowsplit_execute(structure, a.vals, b, m=a.m, impl=impl)


def sddmm(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
          dc: torch.Tensor, b: torch.Tensor, *, impl: str) -> torch.Tensor:
    """Sampled dense-dense matmul over a pattern: dvals[p] = dC[r_p]·B[c_p].

    ``rows``/``cols`` are the plan's per-nonzero coordinates (in-bounds
    everywhere; padded slots masked off by ``valid``).  This is the
    values-cotangent kernel of the differentiable SpMM.  ``dc``/``b`` may
    carry matching leading batch dims, kept per element: (..., m, n) ×
    (..., k, n) → (..., nnz_pad) in ``dc``'s dtype; shared-values callers
    reduce the leading dims.  Both implementations return 0 in every
    padded slot (the kernel skips them), so nothing is masked here.
    """
    lead = tuple(dc.shape[:-2])
    nnz_pad = rows.shape[0]
    if nnz_pad == 0 or dc.numel() == 0 or b.numel() == 0:
        # 0-nnz / 0-row / 0-col patterns or an empty batch: every slot is
        # padding or sums nothing — the cotangent is identically zero.
        return torch.zeros(lead + (nnz_pad,), dtype=dc.dtype,
                           device=dc.device)
    if impl == "torch":
        return _ref.sddmm_ref(rows, cols, valid, dc, b)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}; expected 'cuda' or "
                         "'torch'")
    dc3 = dc.reshape((-1,) + dc.shape[-2:])
    b3 = b.reshape((-1,) + b.shape[-2:])
    out = _sddmm.sddmm_cuda(rows, cols, valid, dc3, b3)
    return out.reshape(lead + (nnz_pad,)).to(dc.dtype)


def moe_group_gemm(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, tt: int = _moe.TT,
                   impl: str | None = None) -> torch.Tensor:
    """Grouped GEMM over expert-sorted tokens (merge-based balancing).

    x (tokens_pad, d_in) sorted by expert; w (E, d_in, d_out);
    group_sizes (E,) padded sizes, multiples of ``tt``, summing to
    tokens_pad.  ``impl=None`` launches the kernel on a CUDA tensor and
    runs its plain version on a CPU one; ``"torch"`` asks for the plain
    version on any device; ``"cuda"`` launches the kernel (raising on a
    CPU tensor).  The kernel masks ragged d_in/d_out itself, so nothing is
    padded here.
    """
    tokens = x.shape[0]
    if tokens % tt:
        raise ValueError(f"tokens {tokens} is not a multiple of tt={tt}")
    if impl is None:
        impl = "cuda" if x.is_cuda else "torch"
    block_expert = _moe.plan_groups(group_sizes, tokens, tt)
    if impl == "torch":
        return _ref.moe_group_gemm_ref(x, w, block_expert, tt)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}; expected 'cuda' or "
                         "'torch'")
    return _moe.moe_group_gemm_cuda(x, w, block_expert, tt=tt)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = _flash.DEFAULT_BQ, bk: int = _flash.DEFAULT_BK,
                    impl: str | None = None) -> torch.Tensor:
    """Causal flash attention.

    q (b, s, h, dh); k/v (b, s, kv, dh) with h % kv == 0 (grouped-query
    attention: query head h reads KV head h // (h / kv)) → (b, s, h, dh)
    in q's dtype, float32 softmax and sums.  ``bq``/``bk`` are the
    reference's block sizes; there they only set the padding length, so
    they are validated and do not change the result.  ``impl=None``
    launches the kernel on a CUDA tensor and runs its plain version on a
    CPU one; ``"torch"`` asks for the plain version on any device;
    ``"cuda"`` launches the kernel (raising on a CPU tensor).  The kernel
    reads the layout and masks a ragged s in place, so nothing is
    broadcast, transposed or padded here.
    """
    for name, blk in (("bq", bq), ("bk", bk)):
        if not isinstance(blk, int) or blk <= 0:
            raise ValueError(f"{name} must be a positive int, got {blk!r}")
    _flash.check_shapes(q, k, v)
    if impl is None:
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "torch":
        return _ref.flash_attention_ref(q, k, v)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}; expected 'cuda' or "
                         "'torch'")
    return _flash.flash_attention_cuda(q, k, v)
