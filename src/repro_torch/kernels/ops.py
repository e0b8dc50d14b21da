"""Plan-execute ops: shapes and dtypes around the kernels, and dispatch.

``merge_execute``/``rowsplit_execute`` take a dense operand with any
leading batch dims — ``b (..., k, n)`` folds into the kernels' batch axis,
one launch for the whole stack — resolve the accumulator/output dtypes,
keep the degenerate early-outs (m == 0, k == 0, an empty batch) that still
apply the epilogue to C = 0, and dispatch by ``impl``: ``"cuda"`` launches
the hand-written kernel (CUDA tensors only, no fallback), ``"torch"`` runs
its plain version from ``ref.py``.  The kernels mask the ragged n edge
themselves and write (batch, m, n) directly, so nothing is padded here.
``sddmm`` is the backward's values cotangent, dispatched the same way.
The reference's ``custom_vmap`` op wrappers have no counterpart: the port
batches through the leading dims of B, one launch for the stack.
"""
from __future__ import annotations

import torch

from repro_torch.core.epilogue import apply_epilogue

from . import merge_spmm as _merge
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
