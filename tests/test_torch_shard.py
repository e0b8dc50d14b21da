"""nnz-balanced sharded SpMM in the port against the reference's
``repro.distributed.spmm``, on its per-shard loop path (the reference's
forced-device runs are not leaned on; see ROADMAP queue 3).

* ``shard_csr_by_nnz``: bounds, each shard's ``row_ptr``/``col_ind``/
  shape, ``vals_slots`` and ``b_rows`` array-equal for both dims and
  ``n`` in {1, 2, 3, 8}, with more shards than rows and zero-nnz shards;
  the properties of ``tests/test_shard_property.py`` on seeded draws;
* ``build_sharded_plan``: per-shard methods, ``uniform`` and every local
  ``PlanMeta``'s statics equal to the reference's;
* ``execute_sharded``'s loop path against the reference's at f32 2e-5
  and bf16 2e-2 with three epilogues and a batched B, gradients at rtol
  1e-4 / atol 1e-5;
* the engine cache, the front ends, ``ensure_spmm_plans``, planlint's
  P070-P074 on the reference's mutations (the P070 one included, which the
  reference misses), the trace events and metrics, and a
  ``convert``-carried layer.  ``moe_groups`` against the reference is in
  ``tests/test_torch_moe.py``."""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Epilogue as JEpilogue  # noqa: E402
from repro.core import ExecutionConfig as JExec  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import ShardSpec as JShardSpec  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.distributed import spmm as jsp  # noqa: E402
from repro_torch import convert, engine, obs  # noqa: E402
from repro_torch.analysis import planlint  # noqa: E402
from repro_torch.analysis import set_verify_plans  # noqa: E402
from repro_torch.core import (CSR, Epilogue, ExecutionConfig,  # noqa: E402
                              PlanPolicy, ShardSpec, SparseMatrix,
                              pattern_fingerprint, spmm)
from repro_torch.distributed import spmm as tsp  # noqa: E402
from repro_torch.distributed.spmm import ShardedSpmmPlan  # noqa: E402
from repro_torch.models import sparse as S  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
EPILOGUES = {
    "none": (None, None),
    "bias+gelu": (JEpilogue(bias=True, activation="gelu"),
                  Epilogue(bias=True, activation="gelu")),
    "relu+scale+residual": (
        JEpilogue(activation="relu", scale=0.5, residual=True),
        Epilogue(activation="relu", scale=0.5, residual=True)),
}


def _port(ja):
    return convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                  np.asarray(ja.col_ind),
                                  np.asarray(ja.vals), ja.shape,
                                  device="cpu")


def _dense_pair(dense):
    ja = jcsr.from_dense(jnp.asarray(dense))
    return ja, _port(ja)


def _pattern(kind):
    """(reference CSR, port CSR) of a named pattern."""
    key = jax.random.PRNGKey(0)
    if kind == "irregular":            # 41 x 24, rows of 0-9, padded
        a = jcsr.random_csr(key, 41, 24, nnz_per_row=(0, 9))
        ja = jcsr.random_csr(key, 41, 24, nnz_per_row=(0, 9),
                             pad_to=a.nnz_pad + 5)
        return ja, _port(ja)
    if kind == "few_rows":             # 3 rows: more shards than rows
        ja = jcsr.random_csr(jax.random.PRNGKey(7), 3, 10,
                             nnz_per_row=(1, 4))
        return ja, _port(ja)
    if kind == "one_dense_row":        # zero-nnz shards
        dense = np.zeros((16, 12), np.float32)
        dense[3] = np.arange(1, 13)
        return _dense_pair(dense)
    if kind == "skewed":               # dense head, sparse tail
        rng = np.random.default_rng(3)
        dense = np.zeros((96, 64), np.float32)
        dense[:6] = rng.standard_normal((6, 64))
        for r in range(6, 96):
            dense[r, rng.choice(64, 2, replace=False)] = rng.standard_normal(2)
        return _dense_pair(dense)
    raise KeyError(kind)


def _eq(jx, tx, what):
    j, t = np.asarray(jx), tx.numpy()
    assert j.dtype == t.dtype, (what, j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j, err_msg=what)


# ------------------------------------------------------ shard_csr_by_nnz ---


@pytest.mark.parametrize("n", (1, 2, 3, 8))
@pytest.mark.parametrize("dim", ("rows", "cols"))
@pytest.mark.parametrize("kind", ("irregular", "few_rows", "one_dense_row"))
def test_shard_csr_by_nnz_array_equal(kind, dim, n):
    ja, ta = _pattern(kind)
    js = jsp.shard_csr_by_nnz(ja, n, dim=dim)
    ts = tsp.shard_csr_by_nnz(ta, n, dim=dim)
    assert ts.bounds == js.bounds and ts.dim == js.dim
    assert ts.shape == js.shape and ts.nnz_pad == js.nnz_pad
    assert ts.sizes() == js.sizes()
    assert ts.nnz_per_shard() == js.nnz_per_shard()
    for i, (jc, tc) in enumerate(zip(js.csrs, ts.csrs)):
        assert tc.shape == jc.shape, i
        _eq(jc.row_ptr, tc.row_ptr, f"shard {i} row_ptr")
        _eq(jc.col_ind, tc.col_ind, f"shard {i} col_ind")
        ju, tu = js.unpadded(i), ts.unpadded(i)
        assert tu.shape == ju.shape
        _eq(ju.row_ptr, tu.row_ptr, f"shard {i} unpadded row_ptr")
    for i, (jv, tv) in enumerate(zip(js.vals_slots, ts.vals_slots)):
        _eq(jv, tv, f"vals_slots[{i}]")
    if dim == "rows":
        assert ts.b_rows is None and js.b_rows is None
    else:
        for i, (jb, tb) in enumerate(zip(js.b_rows, ts.b_rows)):
            _eq(jb, tb, f"b_rows[{i}]")
    if kind == "one_dense_row" and dim == "rows" and n > 1:
        assert sorted(ts.nnz_per_shard())[:-1] == [0] * (n - 1)


def test_shard_csr_by_nnz_degenerates():
    empty = CSR(torch.zeros(1, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32), torch.zeros(1), (0, 5))
    assert tsp.shard_csr_by_nnz(empty, 4).sizes() == (0, 0, 0, 0)
    dense = np.zeros((9, 32), np.float32)
    dense[4] = 1.0
    dense[0, 0] = dense[8, 31] = 1.0
    s = tsp.shard_csr_by_nnz(_dense_pair(dense)[1], 6)
    assert sum(s.sizes()) == 9 and sum(s.nnz_per_shard()) == 34
    with pytest.raises(ValueError, match="n_shards"):
        tsp.shard_csr_by_nnz(empty, 0)
    with pytest.raises(ValueError, match="dim"):
        tsp.shard_csr_by_nnz(empty, 2, dim="diag")


def _draws(count, seed=0):
    """The strategy of tests/test_shard_property.py on numpy draws: m in
    0..40, k in 1..24, rows of 0..hi, 1..10 shards."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        m, k = int(rng.integers(0, 41)), int(rng.integers(1, 25))
        hi = int(rng.integers(0, min(k, 10) + 1))
        n = int(rng.integers(1, 11))
        a = tcsr_random(int(rng.integers(0, 2**31 - 1)), max(m, 1), k, hi)
        if m == 0:
            a = CSR(torch.zeros(1, dtype=torch.int32), a.col_ind, a.vals,
                    (0, k))
        yield a, n


def tcsr_random(seed, m, k, hi):
    from repro_torch.core.csr import random_csr
    return random_csr(seed, m, k, nnz_per_row=(0, hi))


@pytest.mark.parametrize("prop", ("tile", "balance", "cover", "reassemble",
                                  "cols"))
def test_shard_properties(prop):
    """The hypothesis properties of tests/test_shard_property.py, on 30
    seeded draws each: shards tile the rows once; each shard's nnz is
    within one max row of nnz/n; every global nonzero is in exactly one
    value gather; the unpadded locals reassemble the matrix; column
    shards tile the columns and keep every nonzero."""
    for a, n in _draws(30, seed=("tile", "balance", "cover", "reassemble",
                                 "cols").index(prop)):
        rp = a.row_ptr.numpy()
        nnz = int(rp[-1])
        if prop == "cols":
            s = tsp.shard_csr_by_nnz(a, n, dim="cols")
            assert s.bounds[0] == 0 and s.bounds[-1] == a.k
            assert sum(s.nnz_per_shard()) == nnz
            continue
        s = tsp.shard_csr_by_nnz(a, n)
        if prop == "tile":
            assert len(s.bounds) == n + 1
            assert s.bounds[0] == 0 and s.bounds[-1] == a.m
            assert all(s.bounds[i] <= s.bounds[i + 1] for i in range(n))
            assert sum(s.sizes()) == a.m
        elif prop == "balance":
            lengths = np.diff(rp)
            max_len = int(lengths.max()) if lengths.size else 0
            for nnz_i in s.nnz_per_shard():
                assert abs(nnz_i - nnz / n) <= max_len + 1
        elif prop == "cover":
            valid = np.concatenate([sl.numpy()[sl.numpy() < a.nnz_pad]
                                    for sl in s.vals_slots])
            assert np.array_equal(np.sort(valid), np.arange(nnz))
        else:
            vals_ext = torch.cat([a.vals, a.vals.new_zeros(1)])
            blocks = []
            for i, (c, slot) in enumerate(zip(s.csrs, s.vals_slots)):
                local = CSR(c.row_ptr, c.col_ind, vals_ext[slot.long()],
                            c.shape)
                blocks.append(local.to_dense()[:s.sizes()[i]])
            got = torch.cat(blocks) if blocks else torch.zeros(a.shape)
            torch.testing.assert_close(got, a.to_dense(), rtol=1e-6,
                                       atol=1e-6)


# ------------------------------------------------------------------ plans ---


@pytest.fixture()
def ref_metas(monkeypatch):
    """The reference's ``build_sharded_plan`` with each shard's plan cut
    to its ``PlanMeta``, built as ``repro.core.plan.build_plan`` builds it
    (its lines 219-221) from the same pinned policy, without the structure
    arrays (``tests/test_torch_plan.py`` holds those array-equal): the
    sharded build's decisions at a fraction of the JAX build's time."""
    from repro.core.plan import PlanMeta as JPlanMeta

    def meta_only(c, policy):
        r = policy.resolve(c)
        return types.SimpleNamespace(meta=JPlanMeta(
            method=r.method, shape=c.shape, nnz_pad=c.nnz_pad, t=r.t,
            tl=r.tl, l_pad=r.l_pad, has_transpose=policy.with_transpose,
            extra=r.extra))

    monkeypatch.setattr(jsp, "build_plan", meta_only)


# Every method, both dims, 2 to 8 shards; the skewed matrix picks a
# method a shard.
PLAN_CASES = [
    ("irregular", "auto", "rows", 3), ("irregular", "merge", "cols", 3),
    ("irregular", "rowgroup", "rows", 4), ("irregular", "rowgroup", "cols",
                                           2),
    ("irregular", "rowsplit", "rows", 2), ("irregular", "rowsplit", "cols",
                                           4),
    ("skewed", "auto", "rows", 4), ("skewed", "auto", "cols", 3),
    ("one_dense_row", "auto", "rows", 8), ("few_rows", "merge", "rows", 8)]


@pytest.mark.parametrize("kind,method,dim,n", PLAN_CASES)
def test_build_sharded_plan_matches_reference(ref_metas, kind, method, dim,
                                              n):
    ja, ta = _pattern(kind)
    jp = jsp.build_sharded_plan(ja, JPlanPolicy(
        method=method, tunedb=None, shards=JShardSpec(n=n, dim=dim)))
    tp = tsp.build_sharded_plan(ta, PlanPolicy(
        method=method, tunedb=None, shards=ShardSpec(n=n, dim=dim)))
    _same_statics(jp, tp)
    assert planlint.verify_sharded_plan(tp, ta) == []
    if kind == "skewed" and dim == "rows":
        # The paper's principle at the device level: the dense head's
        # shard picks row-split, the sparse tail's merge.
        assert tp.meta.method == "mixed" and not tp.meta.uniform


def _same_statics(jp, tp):
    jm, tm = jp.meta, tp.meta
    assert (tm.shape, tm.nnz_pad, tm.dim, tm.bounds, tm.axis, tm.uniform,
            tm.method, tm.l_pad, tm.has_transpose) == (
        jm.shape, jm.nnz_pad, jm.dim, jm.bounds, jm.axis, jm.uniform,
        jm.method, jm.l_pad, jm.has_transpose)
    for i, (jl, tl) in enumerate(zip(jm.local_metas, tm.local_metas)):
        assert (tl.method, tl.shape, tl.nnz_pad, tl.t, tl.tl, tl.l_pad,
                tl.has_transpose, tl.extra) == (
            jl.method, jl.shape, jl.nnz_pad, jl.t, jl.tl, jl.l_pad,
            jl.has_transpose, jl.extra), i


def test_rowgroup_heterogeneous_falls_back(ref_metas):
    """The reference's case (tests/test_distributed_spmm.py:196):
    rowgroup's per-shard group tables differ, so the plan is not uniform,
    and it still computes the unsharded answer."""
    ja = jcsr.random_csr(jax.random.PRNGKey(23), 48, 24, nnz_per_row=(0, 12))
    ta = _port(ja)
    jp = jsp.build_sharded_plan(ja, JPlanPolicy(
        method="rowgroup", tunedb=None, shards=JShardSpec(n=4)))
    tp = engine.PlanCache().get(ta, PlanPolicy(
        method="rowgroup", shards=ShardSpec(n=4)))
    assert not tp.meta.uniform and not jp.meta.uniform
    _same_statics(jp, tp)
    b = torch.randn(24, 7, generator=torch.Generator().manual_seed(1))
    want = engine.PlanCache().get(ta, PlanPolicy(method="rowgroup"))
    from repro_torch.core import execute_plan
    torch.testing.assert_close(tsp.execute_sharded(tp, ta.vals, b),
                               execute_plan(want, ta.vals, b), **TOL[
                                   "float32"])


# -------------------------------------------------------------- execution ---


_JPLANS: dict = {}


def _jplan(dim):
    """The reference's 3-shard plan of the irregular pattern (built once
    a dim)."""
    if dim not in _JPLANS:
        _JPLANS[dim] = jsp.build_sharded_plan(_pattern("irregular")[0],
                                              JPlanPolicy(
            tunedb=None, shards=JShardSpec(n=3, dim=dim)))
    return _JPLANS[dim]


def _operands(ja, dt, lead, seed=2):
    rng = np.random.default_rng(seed)
    m, k = ja.shape
    f = np.float32
    return dict(b=rng.standard_normal(lead + (k, 6)).astype(f),
                bias=rng.standard_normal(m).astype(f),
                res=rng.standard_normal(lead + (m, 6)).astype(f),
                w=rng.standard_normal(lead + (m, 6)).astype(f),
                vals=np.asarray(ja.vals).astype(f))


@pytest.mark.parametrize("lead", ((), (2,)), ids=("2d", "batched"))
@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("dt", ("float32", "bfloat16"))
@pytest.mark.parametrize("dim", ("rows", "cols"))
def test_loop_path_matches_reference_loop(dim, dt, ep, lead):
    ja, ta = _pattern("irregular")
    jep, tep = EPILOGUES[ep]
    x = _operands(ja, dt, lead)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    jp = _jplan(dim)
    tp = engine.get_plan(ta, PlanPolicy(shards=ShardSpec(n=3, dim=dim)))
    jkw, tkw = {}, {}
    if tep is not None and tep.bias:
        jkw["bias"], tkw["bias"] = jnp.asarray(x["bias"]), \
            torch.from_numpy(x["bias"])
    if tep is not None and tep.residual:
        jkw["residual"], tkw["residual"] = jnp.asarray(x["res"]), \
            torch.from_numpy(x["res"])
    want = jsp.execute_sharded(
        jp, jnp.asarray(x["vals"]).astype(jdt),
        jnp.asarray(x["b"]).astype(jdt), JExec(impl="xla", epilogue=jep),
        **jkw)
    got = tsp.execute_sharded(
        tp, torch.from_numpy(x["vals"]).to(tdt),
        torch.from_numpy(x["b"]).to(tdt), ExecutionConfig(epilogue=tep),
        **tkw)
    assert tp.meta.spmd_mesh() is None
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dt])


@pytest.mark.parametrize("ep", ("none", "bias+gelu", "relu+scale+residual"))
@pytest.mark.parametrize("dim", ("rows", "cols"))
def test_loop_path_gradients_match_reference(dim, ep):
    """d/dvals, d/dB, d/dbias, d/dresidual of sum(C * w), batched B."""
    ja, ta = _pattern("irregular")
    jep, tep = EPILOGUES[ep]
    x = _operands(ja, "float32", (2,), seed=4)
    jp = _jplan(dim)
    tp = engine.get_plan(ta, PlanPolicy(shards=ShardSpec(n=3, dim=dim)))
    names = ["vals", "b"] + (["bias"] if tep and tep.bias else []) + \
        (["res"] if tep and tep.residual else [])

    def jloss(*args):
        kw = dict(zip(names, args))
        c = jsp.execute_sharded(
            jp, kw["vals"], kw["b"], JExec(impl="xla", epilogue=jep),
            bias=kw.get("bias"), residual=kw.get("res"))
        return jnp.sum(c * x["w"])

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jnp.asarray(x[k]) for k in names])
    targs = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in names}
    c = tsp.execute_sharded(tp, targs["vals"], targs["b"],
                            ExecutionConfig(epilogue=tep),
                            bias=targs.get("bias"), residual=targs.get("res"))
    (c * torch.from_numpy(x["w"])).sum().backward()
    for k, w in zip(names, want):
        np.testing.assert_allclose(targs[k].grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=k)


def test_execute_sharded_shape_checks():
    _, ta = _pattern("irregular")
    plan = engine.get_plan(ta, PlanPolicy(method="merge", shards=2))
    b = torch.randn(ta.k, 3)
    with pytest.raises(ValueError, match="global vals"):
        tsp.execute_sharded(plan, ta.vals[:-1], b)
    with pytest.raises(ValueError, match="expects B"):
        tsp.execute_sharded(plan, ta.vals, b[:-1])
    with pytest.raises(ValueError, match="impl='cuda'"):
        tsp.execute_sharded(plan, ta.vals, b, ExecutionConfig(impl="cuda"))


# ------------------------------------------------------------------ cache ---


def test_sharded_plans_land_as_distinct_entries():
    """One sharded request = one entry a shard (keyed on the shard's own
    fingerprint) + one for the assembled plan; a repeat is one hit."""
    cache = engine.PlanCache()
    ta = _port(jcsr.random_csr(jax.random.PRNGKey(20), 40, 24,
                               nnz_per_row=(0, 8)))
    policy = PlanPolicy(method="merge", shards=ShardSpec(n=4))
    plan = cache.get(ta, policy)
    s = cache.stats()
    assert (s.hits, s.misses, s.size) == (0, 5, 5)
    fps = {pattern_fingerprint(c)
           for c in tsp.shard_csr_by_nnz(ta, 4).csrs}
    assert pattern_fingerprint(ta) not in fps
    assert cache.get(ta, policy) is plan
    assert cache.stats().hits == 1
    events = {c.labels["event"]: c.value for c in
              obs.registry.get("plan_cache_events_total").children()
              if c.labels["cache"] == cache.name}
    assert (events["hit"], events["miss"]) == (1, 5)


def test_reshard_different_count_does_not_poison_cache():
    cache = engine.PlanCache()
    ta = _port(jcsr.random_csr(jax.random.PRNGKey(21), 40, 24,
                               nnz_per_row=(0, 8)))
    get = lambda n: cache.get(ta, PlanPolicy(   # noqa: E731
        method="merge", shards=ShardSpec(n=n)))
    p4, p2 = get(4), get(2)
    assert p4 is not p2
    assert (p4.meta.n_shards, p2.meta.n_shards) == (4, 2)
    assert get(4) is p4 and get(2) is p2
    p1 = cache.get(ta, PlanPolicy(method="merge"))
    assert p1 is not p4 and p1 is not p2
    # another mesh is another key too
    from repro_torch.launch.mesh import make_local_mesh
    pm = cache.get(ta, PlanPolicy(method="merge", shards=ShardSpec(
        mesh=make_local_mesh(device_type="cpu"))))
    assert pm.meta.n_shards == 1 and pm is not p1


def test_sharded_and_local_entries_share_one_lru():
    cache = engine.PlanCache(maxsize=3)
    ta = _port(jcsr.random_csr(jax.random.PRNGKey(22), 24, 24,
                               nnz_per_row=(0, 8)))
    cache.get(ta, PlanPolicy(method="merge", shards=ShardSpec(n=2)))
    s = cache.stats()
    assert (s.misses, s.size, s.evictions) == (3, 3, 0)
    cache.get(_port(jcsr.random_csr(jax.random.PRNGKey(23), 32, 24,
                                    nnz_per_row=(0, 8))),
              PlanPolicy(method="merge"))
    assert cache.stats().evictions == 1


def test_policy_shards_conflict_guards():
    _, ta = _pattern("irregular")
    b = torch.randn(ta.k, 4, generator=torch.Generator().manual_seed(1))
    from repro_torch.core import build_plan
    plan = build_plan(ta, PlanPolicy(method="merge"))
    with pytest.raises(ValueError, match="unsharded"):
        spmm(ta, b, PlanPolicy(shards=2), plan=plan)
    sharded = engine.get_plan(ta, PlanPolicy(method="merge",
                                             shards=ShardSpec(n=2)))
    with pytest.raises(ValueError, match="shards n=4"):
        spmm(ta, b, PlanPolicy(shards=ShardSpec(n=4)), plan=sharded)
    with pytest.raises(ValueError, match="dim"):
        spmm(ta, b, PlanPolicy(shards=ShardSpec(n=2, dim="cols")),
             plan=sharded)
    with pytest.raises(ValueError, match="method"):
        spmm(ta, b, PlanPolicy(method="rowsplit"), plan=sharded)
    got = spmm(ta, b, PlanPolicy(method="merge", shards=ShardSpec(n=2)),
               plan=sharded)
    torch.testing.assert_close(got, ta.to_dense() @ b, **TOL["float32"])
    torch.testing.assert_close(
        spmm(ta, b, PlanPolicy(shards=ShardSpec(n=3, dim="cols"))),
        ta.to_dense() @ b, **TOL["float32"])
    with pytest.raises(ValueError, match="per shard"):
        PlanPolicy(shards=2).resolve(ta)
    with pytest.raises(ValueError, match="inline"):
        spmm(ta, b, PlanPolicy(method="merge", shards=2), plan="inline")


def test_shard_spec_validation_messages():
    with pytest.raises(ValueError, match="dim must be 'rows' or 'cols'"):
        ShardSpec(n=2, dim="diag")
    with pytest.raises(ValueError, match="needs n= "):
        ShardSpec()
    with pytest.raises(ValueError, match=">= 1"):
        ShardSpec(n=0)
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        ShardSpec(mesh=mesh, axis="pod")
    with pytest.raises(ValueError, match="conflicts with mesh axis"):
        ShardSpec(n=2, mesh=mesh)
    assert ShardSpec(mesh=mesh).resolved_n() == 1
    assert ShardSpec(n=2).axis == "data"
    assert ShardSpec(n=2, dim="cols").axis == "model"
    assert hash(ShardSpec(mesh=mesh)) == hash(ShardSpec(
        mesh=make_local_mesh(device_type="cpu")))
    assert PlanPolicy(shards=3).shards == ShardSpec(n=3)
    with pytest.raises(TypeError, match="ShardSpec"):
        PlanPolicy(shards="2")


# ------------------------------------------------------------- front ends ---


def test_sparse_matrix_and_linear_shard_front_ends():
    _, ta = _pattern("irregular")
    b = torch.randn(ta.k, 5, generator=torch.Generator().manual_seed(3))
    A = SparseMatrix(ta).shard(n=2)
    assert isinstance(A.spmm_plan, ShardedSpmmPlan)
    want = SparseMatrix(ta).plan() @ b
    torch.testing.assert_close(A @ b, want, **TOL["float32"])
    # plan_like replays the layout and the uniform statics
    again = SparseMatrix(ta).plan_like(A.spmm_plan.meta).spmm_plan
    assert again.meta == A.spmm_plan.meta
    assert all(x is y for x, y in zip(again.shards, A.spmm_plan.shards))
    with pytest.raises(ValueError, match="cannot be mixed"):
        SparseMatrix(ta).shard(n=2, policy=PlanPolicy(shards=2))
    layer = S.SparseLinear(ta, None).shard(n=3, dim="cols")
    assert layer.plan.meta.n_shards == 3 and layer.plan.meta.dim == "cols"
    x = torch.randn(4, ta.k, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(layer(x), S.SparseLinear(ta, None)(x),
                               **TOL["float32"])
    assert layer.with_plan().plan.meta == layer.plan.meta   # replayed


def test_ensure_spmm_plans_shards_leaves():
    ta = _port(jcsr.random_csr(jax.random.PRNGKey(25), 40, 24,
                               nnz_per_row=(0, 8)))
    w = torch.randn(16, 12, generator=torch.Generator().manual_seed(3))
    # (d_in, d_out) = (16, 12): stored (12, 16), y (5, 12) of x (5, 16)
    tree = {"mtx": SparseMatrix(ta),
            "layer": S.SparseLinear.from_dense(w, 0.25)}
    planned = steps.ensure_spmm_plans(tree, policy=PlanPolicy(shards=2))
    assert isinstance(planned["mtx"].spmm_plan, ShardedSpmmPlan)
    assert isinstance(planned["layer"].plan, ShardedSpmmPlan)
    assert planned["layer"].method in ("merge", "rowsplit", "mixed")
    again = steps.ensure_spmm_plans(planned)
    assert again["mtx"].spmm_plan.meta.n_shards == 2
    # the sparse trainer takes sharded layers (their shards carry the
    # transpose plans the backward needs)
    w2 = torch.randn(12, 16, generator=torch.Generator().manual_seed(4))
    mlp = steps.ensure_spmm_plans(
        {"w1": planned["layer"], "w2": S.SparseLinear.from_dense(w2, 0.25)},
        policy=PlanPolicy(shards=ShardSpec(n=2, dim="cols")))
    step, vals = steps.make_sparse_train_step(mlp)
    xin = torch.randn(5, 16, generator=torch.Generator().manual_seed(6))
    y = torch.randn(5, 16, generator=torch.Generator().manual_seed(7))
    new, loss = step(vals, xin, y)
    assert torch.isfinite(loss)
    assert all(not torch.equal(new[k], vals[k]) for k in vals)


def test_convert_carried_layer_shards_like_a_port_pruned_one():
    """A SparseLinear carried across by ``convert`` (the reference's
    pruned CSR) shards exactly as the one the port prunes itself."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    jw = jcsr.prune_to_csr(jnp.asarray(w.T), 0.25)   # as SparseLinear does
    carried = convert.sparse_mlp_from_numpy(
        {"w1": tuple(np.asarray(x) for x in (
            jw.row_ptr, jw.col_ind, jw.vals)) + (jw.shape,)},
        device="cpu")["w1"]
    pruned = S.SparseLinear.from_dense(torch.from_numpy(w), 0.25)
    for dim in ("rows", "cols"):
        pc = carried.shard(n=3, dim=dim).plan
        pp = pruned.shard(n=3, dim=dim).plan
        assert pc.meta.bounds == pp.meta.bounds
        assert pc.meta.local_metas == pp.meta.local_metas
        for x, y in zip(pc.vals_slots, pp.vals_slots):
            assert torch.equal(x, y)


# --------------------------------------------------------------- planlint ---


@pytest.fixture()
def lint_a():
    """The reference's fixture (tests/test_analysis.py): m = 41, rows of
    1-17, 8 padded slots."""
    key = jax.random.PRNGKey(7)
    a0 = jcsr.random_csr(key, 41, 96, nnz_per_row=(1, 17))
    nnz = int(np.asarray(a0.row_ptr)[-1])
    ja = jcsr.random_csr(key, 41, 96, nnz_per_row=(1, 17), pad_to=nnz + 8)
    return ja, _port(ja)


def _codes(diags):
    return {d.code for d in diags}


def test_sharded_bounds_shift_p070_caught(lint_a):
    """The reference's mutation that its own linter misses
    (tests/test_analysis.py::test_sharded_bounds_dont_tile_p070): bounds
    still tile [0, m] monotonically, but shard 0 would give one padded row
    too many.  The port checks each shard against its bounds' range of
    the CSR."""
    ja, ta = lint_a
    jplan = jsp.build_sharded_plan(ja, JPlanPolicy(
        with_transpose=False, shards=JShardSpec(n=2)))
    plan = tsp.build_sharded_plan(ta, PlanPolicy(shards=ShardSpec(n=2)))
    assert planlint.verify_sharded_plan(plan, ta) == []
    bounds = list(plan.meta.bounds)
    bounds[1] += 1
    bad = dataclasses.replace(plan, meta=dataclasses.replace(
        plan.meta, bounds=tuple(bounds)))
    assert _codes(planlint.verify_sharded_plan(bad, ta)) & \
        {"P070", "P071", "P072"}
    # ... where the reference's linter reports nothing
    from repro.analysis.planlint import verify_sharded_plan as jverify
    jbad = dataclasses.replace(jplan, meta=dataclasses.replace(
        jplan.meta, bounds=tuple(bounds)))
    assert not _codes(jverify(jbad, ja)) & {"P070", "P071", "P072"}


def test_sharded_gather_not_exactly_once_p072(lint_a):
    _, ta = lint_a
    plan = tsp.build_sharded_plan(ta, PlanPolicy(shards=ShardSpec(n=2)))
    vs = [v.clone() for v in plan.vals_slots]
    live = torch.nonzero(vs[0] < plan.meta.nnz_pad)
    vs[0][live[0]] = plan.meta.nnz_pad
    bad = dataclasses.replace(plan, vals_slots=tuple(vs))
    assert "P072" in _codes(planlint.verify_sharded_plan(bad, ta))


def test_sharded_bad_b_rows_p074(lint_a):
    _, ta = lint_a
    plan = tsp.build_sharded_plan(
        ta, PlanPolicy(shards=ShardSpec(n=2, dim="cols")))
    assert planlint.verify_sharded_plan(plan, ta) == []
    br = [v.clone() for v in plan.b_rows]
    live = torch.nonzero(br[0] < ta.k)
    br[0][live[0]] += 1
    bad = dataclasses.replace(plan, b_rows=tuple(br))
    assert "P074" in _codes(planlint.verify_sharded_plan(bad, ta))


def test_sharded_uniform_flag_lie_p073(lint_a):
    _, ta = lint_a
    plan = tsp.build_sharded_plan(ta, PlanPolicy(shards=ShardSpec(n=2)))
    metas = list(plan.meta.local_metas)
    metas[0] = dataclasses.replace(metas[0], t=metas[0].t * 2)
    bad = dataclasses.replace(plan, meta=dataclasses.replace(
        plan.meta, uniform=True, local_metas=tuple(metas)))
    assert _codes(planlint.verify_sharded_plan(bad)) & \
        {"P073", "P071", "P003"}


def test_verify_hook_checks_sharded_builds(lint_a, monkeypatch):
    """REPRO_VERIFY_PLANS runs check_plan on the assembled plan (and on a
    cache hit of it), through ``verify``'s dispatch."""
    _, ta = lint_a
    seen = []
    real = planlint.verify_sharded_plan
    monkeypatch.setattr(planlint, "verify_sharded_plan",
                        lambda p, a=None: seen.append(p) or real(p, a))
    prev = set_verify_plans(True)
    try:
        cache = engine.PlanCache()
        policy = PlanPolicy(shards=ShardSpec(n=2, dim="cols"))
        plan = cache.get(ta, policy)
        assert cache.get(ta, policy) is plan
    finally:
        set_verify_plans(prev)
    assert seen == [plan, plan]


# -------------------------------------------------------------------- obs ---


def test_sharded_trace_events_and_metrics(tmp_path):
    _, ta = _pattern("skewed")
    b = torch.randn(ta.k, 4, generator=torch.Generator().manual_seed(8))
    executes = obs.registry.get("sharded_execute_total")
    before = executes.labels(path="loop").value
    with obs.tracing() as tr:
        plan = tsp.build_sharded_plan(ta, PlanPolicy(
            tunedb=None, shards=ShardSpec(n=4)))
        tsp.execute_sharded(plan, ta.vals, b)
    sp, = tr.events(cat="plan", name="plan.build_sharded")
    assert sp["args"]["n_shards"] == 4 and sp["args"]["dim"] == "rows"
    assert len(sp["args"]["nnz_per_shard"]) == 4
    assert set(sp["args"]["methods"]) == {"rowsplit", "merge"}
    asm, = tr.events(cat="plan", name="plan.sharded_assembled")
    assert asm["args"]["uniform"] is False
    d, = tr.events(cat="dispatch", name="dispatch.sharded")
    assert d["args"]["path"] == "loop" and d["args"]["method"] == "mixed"
    assert len(tr.events(cat="dispatch", name="dispatch")) == 4
    gauge = obs.registry.get("shard_nnz_imbalance").labels(dim="rows")
    assert gauge.value == pytest.approx(sp["args"]["nnz_imbalance"],
                                        abs=1e-4)
    assert executes.labels(path="loop").value == before + 1
    path = tr.export(str(tmp_path / "trace.json"))
    from repro_torch.obs import validate
    assert validate.validate_trace(path, require_cats=("plan",
                                                       "dispatch")) == []
    mpath = obs.dump_metrics(str(tmp_path / "metrics.json"))
    assert validate.validate_metrics(mpath, require_names=(
        "shard_nnz_imbalance", "sharded_execute_total")) == []
