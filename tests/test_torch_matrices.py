"""The port's matrix corpus against the reference's: every suite spec gives
the same pattern bytes, values, fingerprint and statistics in both
packages; the generators on their edges; MatrixMarket reading and writing
on the reference tests' texts; the suite registry and ``.mtx`` directories.
"""
import dataclasses
import io

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import matrices as jmat  # noqa: E402
from repro.core.plan import pattern_fingerprint as jfingerprint  # noqa: E402
from repro_torch import matrices as tmat  # noqa: E402
from repro_torch.core import csr as tcsr  # noqa: E402
from repro_torch.core.plan import pattern_fingerprint  # noqa: E402

SPEC_NAMES = sorted({sp.name for suite in ("mini", "paper", "pruned")
                     for sp in jmat.get_suite(suite)})


def _same(ja, ta, what=""):
    """Array-equal row_ptr/col_ind, equal f32 values, one fingerprint."""
    assert ja.shape == ta.shape, what
    np.testing.assert_array_equal(ta.row_ptr.numpy(), np.asarray(ja.row_ptr),
                                  err_msg=f"{what} row_ptr")
    np.testing.assert_array_equal(ta.col_ind.numpy(), np.asarray(ja.col_ind),
                                  err_msg=f"{what} col_ind")
    assert ta.row_ptr.dtype == ta.col_ind.dtype == torch.int32
    assert ta.vals.dtype == torch.float32
    np.testing.assert_array_equal(ta.vals.numpy(), np.asarray(ja.vals),
                                  err_msg=f"{what} vals")
    assert pattern_fingerprint(ta) == jfingerprint(ja), what


def _same_stats(ja, ta):
    js, ts = jmat.compute_stats(ja), tmat.compute_stats(ta)
    for field, want in js.as_dict().items():
        got = ts.as_dict()[field]
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), field


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_suite_spec_matches_reference(name):
    jspec = next(sp for suite in ("mini", "paper") for sp in
                 jmat.get_suite(suite) if sp.name == name)
    tspec = next(sp for suite in ("mini", "paper") for sp in
                 tmat.get_suite(suite) if sp.name == name)
    assert tspec.family == jspec.family
    ja, ta = jspec(), tspec()
    assert ta.device.type == "cpu"
    _same(ja, ta, name)
    _same_stats(ja, ta)


def test_suites_match_reference():
    assert tmat.suite_names() == jmat.suite_names()
    for suite in jmat.suite_names():
        assert [sp.name for sp in tmat.get_suite(suite)] == \
            [sp.name for sp in jmat.get_suite(suite)]
    with pytest.raises(KeyError, match="unknown suite"):
        tmat.get_suite("nope")
    first = tmat.get_suite("mini")[0]
    with pytest.raises(ValueError, match="duplicate"):
        tmat.register_spec(tmat.MatrixSpec(name=first.name,
                                           build=first.build))
    with pytest.raises(ValueError, match="unknown specs"):
        tmat.register_suite("broken", ("no_such_spec",))


# Generator arguments past the suites': a partial band, a heavier tail, a
# block that does not divide the shape, an empty matrix, no rows.
GENERATOR_CASES = {
    "power_law_alpha1.2": ("power_law", (3, 64, 48, 4.0), dict(alpha=1.2)),
    "uniform_irregular": ("uniform_irregular", (4, 32, 32, 5), {}),
    "banded_fill0.7": ("banded", (5, 40, 40, 2), dict(fill=0.7)),
    "banded_wide": ("banded", (6, 16, 64, 3), {}),
    "block_sparse_ragged": ("block_sparse", (9, 33, 30),
                            dict(block=4, keep=0.5)),
    "uniform_empty": ("uniform", (1, 16, 16, 0), {}),
    "uniform_no_rows": ("uniform", (2, 0, 8, 3), {}),
    "block_sparse_keep0": ("block_sparse", (7, 16, 16),
                           dict(block=8, keep=0.0)),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generator_matches_reference(case):
    fn, args, kw = GENERATOR_CASES[case]
    ja = getattr(jmat, fn)(*args, **kw)
    ta = getattr(tmat, fn)(*args, **kw)
    _same(ja, ta, case)
    _same_stats(ja, ta)


def test_generator_dtype_and_device():
    a = tmat.uniform(3, 8, 16, 4, dtype=torch.bfloat16, device="cpu")
    assert a.vals.dtype == torch.bfloat16 and a.device.type == "cpu"
    want = tmat.uniform(3, 8, 16, 4)
    np.testing.assert_array_equal(a.vals.float().numpy(),
                                  want.vals.to(torch.bfloat16).float()
                                  .numpy())


def test_power_law_is_core_power_law_csr():
    """One recipe: the corpus's power_law is core.csr.power_law_csr."""
    assert tmat.power_law is tcsr.power_law_csr


# ------------------------------------------------------------- mmio ---

# The texts of the reference's tests/test_matrices.py, plus the pattern
# and integer fields and an empty matrix.
MTX_TEXTS = {
    "symmetric": """%%MatrixMarket matrix coordinate real symmetric
% lower triangle of a 3x3
3 3 4
1 1 2.0
2 1 -1.0
3 2 0.5
3 3 4.0
""",
    "skew_symmetric": """%%MatrixMarket matrix coordinate real skew-symmetric
2 2 1
2 1 3.0
""",
    "duplicates": """%%MatrixMarket matrix coordinate real general
2 2 3
1 1 1.5
1 1 2.5
2 2 1.0
""",
    "pattern": """%%MatrixMarket matrix coordinate pattern general

3 4 3
3 4
1 2
1 1
""",
    "integer_symmetric": """%%MatrixMarket matrix coordinate integer symmetric
3 3 3
2 1 7
3 1 -2
3 3 5
""",
    "empty": """%%MatrixMarket matrix coordinate real general
4 5 0
""",
}


@pytest.mark.parametrize("name", sorted(MTX_TEXTS))
def test_read_mtx_matches_reference(name):
    ja = jmat.read_mtx(io.StringIO(MTX_TEXTS[name]))
    ta = tmat.read_mtx(io.StringIO(MTX_TEXTS[name]))
    _same(ja, ta, name)
    np.testing.assert_array_equal(ta.to_dense().numpy(),
                                  np.asarray(ja.to_dense()))


def test_read_mtx_expands_and_sums():
    a = tmat.read_mtx(io.StringIO(MTX_TEXTS["symmetric"]))
    np.testing.assert_allclose(a.to_dense().numpy(),
                               [[2.0, -1.0, 0.0], [-1.0, 0.0, 0.5],
                                [0.0, 0.5, 4.0]], atol=1e-6)
    a = tmat.read_mtx(io.StringIO(MTX_TEXTS["skew_symmetric"]))
    np.testing.assert_allclose(a.to_dense().numpy(),
                               [[0.0, -3.0], [3.0, 0.0]], atol=1e-6)
    a = tmat.read_mtx(io.StringIO(MTX_TEXTS["duplicates"]))
    np.testing.assert_allclose(a.to_dense().numpy(),
                               [[4.0, 0.0], [0.0, 1.0]], atol=1e-6)


@pytest.mark.parametrize("text,match", [
    ("garbage\n1 1 1\n", "not a MatrixMarket"),
    ("%%MatrixMarket matrix array real general\n", "coordinate"),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n",
     "unsupported field"),
    ("%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n",
     "unsupported symmetry"),
    ("%%MatrixMarket matrix coordinate real general\n", "missing size"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n",
     "declared"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1\n2 2 1\n",
     "more entries"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1\n",
     "bounds"),
])
def test_read_mtx_rejects_as_reference(text, match):
    for mod in (jmat, tmat):
        with pytest.raises(ValueError, match=match):
            mod.read_mtx(io.StringIO(text))


@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_write_mtx_matches_reference_and_round_trips(field):
    ja = jmat.power_law(3, 64, 48, 4.0)
    ta = tmat.power_law(3, 64, 48, 4.0)
    if field == "integer":              # integer values on the same pattern
        ints = np.arange(1, ja.nnz_pad + 1, dtype=np.float32)
        ja = dataclasses.replace(ja, vals=jnp.asarray(ints))
        ta = tcsr.CSR(ta.row_ptr, ta.col_ind, torch.from_numpy(ints),
                      ta.shape)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jmat.write_mtx(jbuf, ja, field=field, comments=["round trip"])
    tmat.write_mtx(tbuf, ta, field=field, comments=["round trip"])
    assert tbuf.getvalue() == jbuf.getvalue()
    tbuf.seek(0)
    back = tmat.read_mtx(tbuf)
    nnz = ta.nnz()
    np.testing.assert_array_equal(back.row_ptr.numpy(), ta.row_ptr.numpy())
    np.testing.assert_array_equal(back.col_ind[:nnz].numpy(),
                                  ta.col_ind[:nnz].numpy())
    want = np.ones(nnz) if field == "pattern" else ta.vals[:nnz].numpy()
    np.testing.assert_array_equal(back.vals[:nnz].numpy(), want)


def test_mtx_file_round_trip_and_dir(tmp_path):
    a = tmat.block_sparse(9, 32, 32, block=4, keep=0.5)
    tmat.write_mtx(tmp_path / "bs.mtx", a)
    tmat.write_mtx(tmp_path / "u.mtx", tmat.uniform(1, 8, 8, 2))
    (tmp_path / "notes.txt").write_text("ignored")
    back = tmat.read_mtx(tmp_path / "bs.mtx")
    np.testing.assert_array_equal(back.row_ptr.numpy(), a.row_ptr.numpy())
    np.testing.assert_allclose(back.vals[:a.nnz()].numpy(),
                               a.vals[:a.nnz()].numpy(), rtol=0, atol=0)
    specs = tmat.specs_from_mtx_dir(tmp_path)
    jspecs = jmat.specs_from_mtx_dir(tmp_path)
    assert [sp.name for sp in specs] == [sp.name for sp in jspecs] == \
        ["bs", "u"]
    assert all(sp.family == "mtx" for sp in specs)
    for sp, jsp in zip(specs, jspecs):
        _same(jsp(), sp(), sp.name)


def test_read_mtx_onto_a_device_and_dtype():
    a = tmat.read_mtx(io.StringIO(MTX_TEXTS["duplicates"]),
                      dtype=torch.float64, device="cpu")
    assert a.vals.dtype == torch.float64 and a.device.type == "cpu"


# ------------------------------------------------------------ stats ---

def test_stats_edges():
    s = tmat.compute_stats(tmat.uniform(1, 32, 64, 8))
    assert s.d == 8.0 and s.cv == 0.0 and s.gini == 0.0 and s.max_len == 8
    s = tmat.compute_stats(tmat.uniform(1, 16, 16, 0))
    assert s.nnz == 0 and s.d == 0.0 and s.cv == 0.0 and s.gini == 0.0
    flat = tmat.compute_stats(tmat.banded(2, 256, 256, 3))
    heavy = tmat.compute_stats(tmat.power_law(2, 256, 256, 4.0, alpha=1.2))
    assert 0.0 <= flat.gini < heavy.gini < 1.0 and heavy.cv > flat.cv
