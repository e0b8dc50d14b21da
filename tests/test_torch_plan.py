"""The port's pattern planners against the JAX reference's, array for
array: CSR construction, pruning, the merge and row-split structures, the
transpose (CSC) view and whole plans.  Inputs come from numpy seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.kernels import merge_spmm as jmerge  # noqa: E402
from repro.kernels import rowsplit_spmm as jrowsplit  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import PlanPolicy, build_plan  # noqa: E402
from repro_torch.core import csr as tcsr  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels import merge_spmm as tmerge  # noqa: E402
from repro_torch.kernels import rowsplit_spmm as trowsplit  # noqa: E402

# tests/test_kernels.py MATRIX_KINDS, plus the degenerate patterns.
KINDS = {
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
    "zero_nnz": (16, 8, 0),
    "zero_rows": (0, 8, 0),
}


def _pair(kind, seed=0, pad=0):
    """The same random CSR in both packages (JAX draws, port converts);
    ``pad`` > 0 adds that many padded nonzero slots past the true nnz."""
    m, k, npr = KINDS[kind]
    key = jax.random.PRNGKey(seed)
    ja = jcsr.random_csr(key, m, k, nnz_per_row=npr)
    if pad:
        ja = jcsr.random_csr(key, m, k, nnz_per_row=npr,
                             pad_to=int(ja.row_ptr[-1]) + pad)
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind),
                                np.asarray(ja.vals), ja.shape, device="cpu")
    return ja, ta


def _eq(jx, tx, what):
    j = np.asarray(jx)
    t = tx.numpy()
    assert j.shape == t.shape, (what, j.shape, t.shape)
    assert j.dtype == t.dtype or (j.dtype == np.bool_ and t.dtype == bool), \
        (what, j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j, err_msg=what)


# Host flags of the port's structures beside the reference's arrays:
# row-split's ``ascending`` (every row's columns ascend), which the staged
# body of the row-split kernel reads.
PORT_FLAGS = {"ascending"}


def _eq_dict(jd, td, what):
    arrays = sorted(key for key in td if key not in PORT_FLAGS)
    assert sorted(jd) == arrays, (what, sorted(jd), sorted(td))
    for key in jd:
        _eq(jd[key], td[key], f"{what}.{key}")
    for key in PORT_FLAGS & set(td):
        assert isinstance(td[key], bool), (what, key, td[key])


@pytest.mark.parametrize("pad", [0, 9])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_random_csr_same_numpy_seed(kind, pad):
    m, k, npr = KINDS[kind]
    key = jax.random.PRNGKey(3)
    nnz = jcsr.random_csr(key, m, k, nnz_per_row=npr).nnz_pad
    pad_to = nnz + pad if pad else None
    ja = jcsr.random_csr(key, m, k, nnz_per_row=npr, pad_to=pad_to)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    ta = tcsr.random_csr(seed, m, k, nnz_per_row=npr, pad_to=pad_to)
    _eq(ja.row_ptr, ta.row_ptr, "row_ptr")
    _eq(ja.col_ind, ta.col_ind, "col_ind")
    np.testing.assert_allclose(ta.vals.numpy(), np.asarray(ja.vals),
                               rtol=1e-7)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rows_and_fingerprint(kind):
    ja, ta = _pair(kind)
    _eq(jcsr.rows_from_row_ptr(ja.row_ptr, ja.nnz_pad),
        tcsr.rows_from_row_ptr(ta.row_ptr, ta.nnz_pad), "rows")
    assert tplan.pattern_fingerprint(ta) == jplan.pattern_fingerprint(ja)


@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_merge_structure_matches(kind, t):
    ja, ta = _pair(kind)
    _eq_dict(jmerge.plan_merge_structure(ja, t=t),
             tmerge.plan_merge_structure(ta, t=t), f"merge[{kind}]")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rowsplit_structure_matches(kind):
    ja, ta = _pair(kind)
    lengths = np.diff(np.asarray(ja.row_ptr))
    l_pad = max(int(lengths.max()) if lengths.size else 0, 1)
    _eq_dict(jrowsplit.plan_rowsplit_structure(ja, l_pad=l_pad),
             trowsplit.plan_rowsplit_structure(ta, l_pad=l_pad),
             f"rowsplit[{kind}]")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rowsplit_structure_in_row_blocks_matches(kind, monkeypatch):
    """The planner fills the ELL a block of rows at a time (so a skewed
    matrix's int64 temporaries fit the card); blocks of a few rows give
    the reference's structure all the same."""
    monkeypatch.setattr(trowsplit, "ELL_BLOCK_SLOTS", 96)
    ja, ta = _pair(kind)
    lengths = np.diff(np.asarray(ja.row_ptr))
    l_pad = max(int(lengths.max()) if lengths.size else 0, 1)
    _eq_dict(jrowsplit.plan_rowsplit_structure(ja, l_pad=l_pad),
             trowsplit.plan_rowsplit_structure(ta, l_pad=l_pad),
             f"rowsplit blocks[{kind}]")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_transpose_pattern_matches(kind):
    ja, ta = _pair(kind)
    jt, jperm = jplan.transpose_pattern(ja)
    tt, tperm = tplan.transpose_pattern(ta)
    assert jt.shape == tt.shape
    _eq(jt.row_ptr, tt.row_ptr, "t_row_ptr")
    _eq(jt.col_ind, tt.col_ind, "t_col_ind")
    _eq(jperm, tperm, "perm")


@pytest.mark.parametrize("pad", [0, 21])
@pytest.mark.parametrize("method", ["auto", "merge", "rowsplit"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_build_plan_matches(kind, method, pad):
    ja, ta = _pair(kind, pad=pad)
    jp = jplan.build_plan(ja, policy=JPlanPolicy(method=method,
                                                 tunedb=None))
    tp = build_plan(ta, PlanPolicy(method=method))
    assert tp.meta == jplan_meta_as_port(jp.meta)
    _eq_dict(jp.fwd, tp.fwd, f"fwd[{kind}]")
    _eq_dict(jp.bwd, tp.bwd, f"bwd[{kind}]")


def jplan_meta_as_port(meta):
    return tplan.PlanMeta(method=meta.method, shape=tuple(meta.shape),
                          nnz_pad=meta.nnz_pad, t=meta.t, tl=meta.tl,
                          l_pad=meta.l_pad, has_transpose=meta.has_transpose,
                          extra=meta.extra)


@pytest.mark.parametrize("keep", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(24, 64), (64, 16), (1, 40)])
def test_prune_to_csr_matches(shape, keep):
    w = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    ja = jcsr.prune_to_csr(w, keep)
    ta = tcsr.prune_to_csr(torch.from_numpy(w), keep)
    assert ja.shape == ta.shape
    _eq(ja.row_ptr, ta.row_ptr, "row_ptr")
    _eq(ja.col_ind, ta.col_ind, "col_ind")
    _eq(ja.vals, ta.vals, "vals")


def test_from_dense_matches():
    rng = np.random.default_rng(11)
    d = rng.standard_normal((20, 30)).astype(np.float32)
    d[rng.random(d.shape) < 0.7] = 0
    d[3] = 0
    for nnz_pad in (None, int((d != 0).sum()) + 5):
        ja = jcsr.from_dense(d, nnz_pad)
        ta = tcsr.from_dense(d, nnz_pad)
        _eq(ja.row_ptr, ta.row_ptr, "row_ptr")
        _eq(ja.col_ind, ta.col_ind, "col_ind")
        _eq(ja.vals, ta.vals, "vals")
        np.testing.assert_array_equal(ta.to_dense().numpy(), d)


def test_rowsplit_rejects_undersized_l_pad():
    _, ta = _pair("irregular")
    with pytest.raises(ValueError, match="longest row"):
        build_plan(ta, PlanPolicy(method="rowsplit", l_pad=1))


def test_plan_cache_builds_once_per_pattern():
    from repro_torch.core import Heuristic
    from repro_torch.engine import PlanCache
    ja, ta = _pair("regular_long")           # d = 33: the rule picks rowsplit
    cache = PlanCache(maxsize=2)
    p1 = cache.get(ta)
    p2 = cache.get(ta, PlanPolicy(method="rowsplit"))   # auto == resolved
    same = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                  np.asarray(ja.col_ind),
                                  np.asarray(ja.vals) * 2, ja.shape,
                                  device="cpu")       # same mask, new values
    assert cache.get(same) is p1 is p2
    assert (cache.stats().misses, cache.stats().hits) == (1, 2)
    _, tb = _pair("short_rows")              # d < 9.35: merge
    assert Heuristic().choose(tb) == "merge" == cache.get(tb).meta.method
    cache.get(ta, PlanPolicy(method="merge"))          # evicts the LRU entry
    st = cache.stats()
    assert (st.misses, st.size, st.evictions) == (3, 2, 1)
