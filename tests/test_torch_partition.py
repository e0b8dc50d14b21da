"""The paper's phase 1 (``PartitionSpmm``, Alg. 1 line 2) in the port
against the reference's ``repro.core.partition``: ``partition_spmm``'s
``chunk_start_rows`` and ``nnz_rows`` and ``chunk_segments``' ``rows``,
``local`` and ``seg_rows`` array-equal (values and dtypes) on random,
power-law, empty-row-run and 0-nnz patterns, for ``t`` from 1 to
``nnz_pad`` (every ``t`` up to 5, then a spread up to ``nnz_pad`` itself;
the reference's functions jitted, one compile a ``t``).  Inputs come from
numpy seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import chunk_segments as jchunk_segments  # noqa: E402
from repro.core import partition_spmm as jpartition_spmm  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core.partition import num_chunks as jnum_chunks  # noqa: E402
from repro.matrices import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chunk_segments, partition_spmm  # noqa: E402
from repro_torch.core.partition import num_chunks  # noqa: E402


def _empty_row_run():
    """Three rows of 5, a run of 20 empty rows, then rows of 1-4: the
    case the paper singles out for merge (chunks spanning empty rows)."""
    lengths = np.r_[[5, 5, 5], np.zeros(20, np.int64), [1, 2, 3, 4]]
    rng = np.random.default_rng(4)
    k = 12
    row_ptr = np.zeros(lengths.size + 1, np.int32)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_ind = np.zeros(nnz + 5, np.int32)
    for r, n in enumerate(lengths):
        col_ind[row_ptr[r]:row_ptr[r + 1]] = np.sort(
            rng.choice(k, size=n, replace=False))
    vals = np.zeros(nnz + 5, np.float32)
    vals[:nnz] = rng.standard_normal(nnz)
    return jcsr.CSR(jax.numpy.asarray(row_ptr), jax.numpy.asarray(col_ind),
                    jax.numpy.asarray(vals), (lengths.size, k))


def _pattern(kind):
    key = jax.random.PRNGKey(11)
    if kind == "random":
        a = jcsr.random_csr(key, 23, 16, nnz_per_row=(0, 5))
        return jcsr.random_csr(key, 23, 16, nnz_per_row=(0, 5),
                               pad_to=a.nnz_pad + 3)
    if kind == "power_law":
        return jgen.power_law(5, 40, 32, 1.5)
    if kind == "empty_row_run":
        return _empty_row_run()
    return jcsr.random_csr(key, 16, 8, nnz_per_row=0)       # 0-nnz


KINDS = ("random", "power_law", "empty_row_run", "zero_nnz")

_jpartition = jax.jit(jpartition_spmm, static_argnums=1)
_jsegments = jax.jit(jchunk_segments, static_argnums=(1, 2))


def _ts(nnz_pad):
    """1..5, then a spread up to nnz_pad (chunks of one nonzero to one
    chunk holding every slot)."""
    return sorted({t for t in (*range(1, 6), 8, 16, nnz_pad // 2,
                               nnz_pad - 1, nnz_pad) if 1 <= t <= nnz_pad})


def _both(kind):
    ja = _pattern(kind)
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind), np.asarray(ja.vals),
                                ja.shape, device="cpu")
    return ja, ta


def _eq(jx, tx, what):
    j, t = np.asarray(jx), tx.numpy()
    assert j.dtype == t.dtype, (what, j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j, err_msg=what)


@pytest.mark.parametrize("kind", KINDS)
def test_partition_spmm_array_equal_over_t(kind):
    ja, ta = _both(kind)
    assert ja.nnz_pad == ta.nnz_pad
    for t in _ts(ja.nnz_pad):
        assert num_chunks(ta.nnz_pad, t) == jnum_chunks(ja.nnz_pad, t)
        jstarts, jrows = _jpartition(ja, t)
        tstarts, trows = partition_spmm(ta, t)
        _eq(jstarts, tstarts, f"{kind} t={t} chunk_start_rows")
        _eq(jrows, trows, f"{kind} t={t} nnz_rows")


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_segments_array_equal_over_t(kind):
    ja, ta = _both(kind)
    for t in _ts(ja.nnz_pad):
        _, jrows = _jpartition(ja, t)
        _, trows = partition_spmm(ta, t)
        got = chunk_segments(trows, t, ta.m)
        want = _jsegments(jrows, t, ja.m)
        for name, j, g in zip(("rows", "local", "seg_rows"), want, got):
            _eq(j, g, f"{kind} t={t} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_partition_invariants(kind):
    """The reference's properties (tests/test_partition.py) on the port's
    arrays: each chunk starts in the row holding its first nonzero; each
    nonzero's (chunk, local segment) maps back to its row; local ids
    change only at row changes."""
    _, ta = _both(kind)
    rp = ta.row_ptr.numpy()
    nnz = int(rp[-1])
    for t in (1, 2, 3, 7):
        starts, nnz_rows = partition_spmm(ta, t)
        for c, r in enumerate(starts.tolist()):
            if c * t < nnz:
                assert rp[r] <= c * t < rp[r + 1]
        np.testing.assert_array_equal(
            nnz_rows.numpy()[:nnz], np.repeat(np.arange(ta.m), np.diff(rp)))
        rows, local, seg_rows = (x.numpy() for x in
                                 chunk_segments(nnz_rows, t, ta.m))
        for i in range(nnz):
            c, s = divmod(i, t)
            assert seg_rows[c, local[c, s]] == rows[c, s]
        assert np.all((np.diff(local, axis=1) == 0)
                      | (np.diff(rows, axis=1) != 0))


def test_core_exports_match_the_reference():
    import repro.core as jcore
    import repro_torch.core as tcore
    for name in ("ShardSpec", "partition_spmm", "chunk_segments"):
        assert name in jcore.__all__ and name in tcore.__all__
        assert callable(getattr(tcore, name))
