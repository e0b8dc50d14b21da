"""Operations and compulsory bytes: the yardstick's arithmetic that every
architecture shares.

Frozen here so that a change to the program cannot move it.  The two SpMM
functions are copies of the port's ``obs/roofline.py`` ones; the rest
counts a pruned SwiGLU FFN's matrices and the bound of a forward's SpMM
launches from their shapes and the nonzeros that pruning keeps, with no
padding.  A model's own operations are its architecture's
(``archs/<arch>/counts.py``).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def spmm_min_bytes(m: int, k: int, n: int, nnz: int, *, val_bytes: int = 4,
                   idx_bytes: int = 4, out_bytes: int = 4) -> int:
    """Compulsory traffic of one CSR SpMM: vals + col indices once, the
    dense B panel once, the output C once."""
    return (nnz * (val_bytes + idx_bytes) + k * n * val_bytes
            + m * n * out_bytes)


def spmm_flops(nnz: int, n: int) -> float:
    """Useful flops of one SpMM: a multiply-add per (nonzero, column)."""
    return 2.0 * nnz * n


def kept_per_row(d_in: int, keep: float) -> int:
    """Nonzeros a row of a weight keeps under per-row magnitude pruning
    at ``keep``: the nearest whole number, at least 1."""
    return max(1, min(int(round(keep * d_in)), d_in))


def ffn_matrices(cfg: dict) -> list[tuple[str, int, int, int]]:
    """The pruned FFN matrices of one layer as ``(name, m, k, nnz)``: the
    SpMM computes C (m, n) = A (m, k) @ B (k, n), A the transposed weight,
    so m is the weight's output width and k its input width."""
    d, ff, keep = cfg["hidden_size"], cfg["intermediate_size"], cfg["keep"]
    return [("w1", ff, d, ff * kept_per_row(d, keep)),
            ("w3", ff, d, ff * kept_per_row(d, keep)),
            ("w2", d, ff, d * kept_per_row(ff, keep))]


def spmm_bound_s(m: int, k: int, n: int, nnz: int) -> float:
    """The least time one f32 SpMM over ``n`` columns can take on the
    card: the larger of its operations at the f32 peak and its compulsory
    bytes (values, column indices, row pointers, B, C) at HBM's rate."""
    byts = spmm_min_bytes(m, k, n, nnz) + (m + 1) * 4
    return max(spmm_flops(nnz, n) / PEAK_F32_FLOPS, byts / PEAK_HBM_BYTES)


def forward_spmm_bound_s(launches: list, tokens: int) -> float:
    """Σ :func:`spmm_bound_s` over the ``(m, k, nnz)`` row-split launches
    of a forward of ``tokens`` columns (a bucket's batch × length as
    launched)."""
    return sum(spmm_bound_s(m, k, tokens, nnz) for m, k, nnz in launches)
