"""Plain PyTorch versions of the kernels: the same function, in tensor ops.

The CPU path runs these (a wrapper takes them only for tensors on the
CPU, or when ``ExecutionConfig(impl="torch")`` asks for them), the CPU
tests hold them against the JAX reference, and ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSR
from repro_torch.core.epilogue import apply_epilogue

from .merge_spmm import apply_vals


def spmm_dense_ref(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Densify-and-matmul oracle (small matrices only)."""
    return a.to_dense() @ b


def _map_leading(one, b, residual):
    """Apply a 2-D-operand function over folded leading batch dims, one
    batch element at a time (per-element working set, as the reference's
    ``lax.map``)."""
    lead = b.shape[:-2]
    b3 = b.reshape((-1,) + b.shape[-2:])
    res3 = None if residual is None else \
        residual.reshape((-1,) + residual.shape[-2:])
    out = torch.stack([one(b3[i], None if res3 is None else res3[i])
                       for i in range(b3.shape[0])])
    return out.reshape(lead + out.shape[1:])


def _finish(out, ep, bias_col, res2, out_dtype):
    return apply_epilogue(out, ep, bias_col, res2).to(out_dtype)


def merge_execute_ref(structure: dict, vals: torch.Tensor, b: torch.Tensor,
                      m: int, tm: int, *, epilogue=None, bias=None,
                      residual=None, acc_dtype=torch.float32,
                      out_dtype=None) -> torch.Tensor:
    """Plain version of the merge kernel on a prebuilt chunk structure.

    Gather the raw ``vals`` into chunk slots (``slot_nz``), gather B rows
    per slot, multiply, scatter-add into C by (tile, lrow) — all in
    ``acc_dtype`` — then apply the fused ``epilogue`` and cast once to
    ``out_dtype``.  ``b`` may carry leading batch dims: (..., k, n) →
    (..., m, n); a flagged ``residual`` batches with it.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    chunk_vals = apply_vals(structure, vals).to(acc_dtype)
    cols = structure["cols"].long()
    rows = (structure["tile"].long()[:, None] * tm
            + structure["lrow"].long()).reshape(-1)
    m_pad = tm * (-(-m // tm))
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        prods = chunk_vals[..., None] * b2.to(acc_dtype)[cols]
        out = torch.zeros((m_pad, b2.shape[-1]), dtype=acc_dtype,
                          device=b2.device)
        out.index_add_(0, rows, prods.reshape(-1, b2.shape[-1]))
        return _finish(out[:m], ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def rowsplit_execute_ref(structure: dict, vals: torch.Tensor,
                         b: torch.Tensor, m: int, *, epilogue=None,
                         bias=None, residual=None, acc_dtype=torch.float32,
                         out_dtype=None) -> torch.Tensor:
    """Plain version of the row-split kernel on a prebuilt ELL structure.

    Raw ``vals`` gathered through ``slot_nz`` like the kernel; batched like
    it too: ``b (..., k, n) → (..., m, n)``; fused ``epilogue`` and
    ``acc_dtype``/``out_dtype`` as in :func:`merge_execute_ref`.
    """
    odt = torch.promote_types(vals.dtype, b.dtype) if out_dtype is None \
        else out_dtype
    ep = epilogue
    ell_vals = apply_vals(structure, vals).to(acc_dtype)
    cols = structure["cols"].long()
    bias_col = bias.to(acc_dtype)[:, None] \
        if ep is not None and ep.bias else None

    def one(b2, res2):
        out = torch.einsum("ml,mln->mn", ell_vals,
                           b2.to(acc_dtype)[cols])[:m]
        return _finish(out, ep, bias_col, res2, odt)

    res = residual if ep is not None and ep.residual else None
    if b.dim() == 2:
        return one(b, res)
    return _map_leading(one, b, res)


def sddmm_ref(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
              dc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the SDDMM kernel: the gather-dot oracle.

    ``dvals[..., p] = dC[..., rows[p], :] · B[..., cols[p], :]`` summed in
    float32 like the kernel (or in the operands' wider type), masked by
    ``valid`` and cast to ``dc``'s dtype — the cotangent of the CSR values
    under C = A @ B.  Leading batch dims are kept per element
    (shared-values callers reduce them).
    """
    rows, cols = rows.long(), cols.long()
    acc = torch.promote_types(torch.promote_types(dc.dtype, b.dtype),
                              torch.float32)

    def one(dc2, b2):
        dots = (dc2.to(acc)[rows] * b2.to(acc)[cols]).sum(-1)
        return torch.where(valid, dots, 0).to(dc.dtype)

    if dc.dim() == 2:
        return one(dc, b)
    return _map_leading(one, dc, b)
