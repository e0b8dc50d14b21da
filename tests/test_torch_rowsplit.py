"""The row-split kernel's schedule, on the CPU: ``ref.rowsplit_schedule_ref``
replays what ``csrc/rowsplit_spmm.cu`` does (each row's slots in groups of
32, r contiguous parts of them, a part's walk stopping after its first
group with a dead slot, the parts' partials added in part order, one
epilogue) in tensor ops, and is held against the JAX reference's row-split
on the same numpy inputs; plus the ELL prefix property the early stop
relies on, the rule for r, the body codes and the launch counters.

Tolerances are the reference's (tests/test_kernels.py): f32 rtol/atol
2e-5, bf16 2e-2."""
import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Epilogue as JEpilogue  # noqa: E402
from repro.core import random_csr as jrandom_csr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import rowsplit_spmm as jrowsplit  # noqa: E402
from repro.matrices import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Epilogue, PlanPolicy, build_plan  # noqa: E402
from repro_torch.kernels import _cuda, ops, ref, rowsplit_spmm  # noqa: E402

# tests/test_kernels.py MATRIX_KINDS, a 0-nnz pattern, rows of exactly two
# groups of 32, and m = 45 (m_pad 48 > m) with rows of 0-70 slots, most
# ending inside a group.
KINDS = {
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
    "zero_nnz": (16, 8, 0),
    "two_groups": (24, 128, 64),
    "ragged_m": (45, 80, (0, 70)),
}
PARTS = [1, 2, 8]
EPILOGUES = {
    "none": None,
    "bias_gelu_scale_residual": dict(bias=True, activation="gelu",
                                     scale=0.5, residual=True),
    "relu": dict(activation="relu"),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LEAD, N = (2,), 24


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _case(kind, dt, ep_name):
    """One problem in both packages: the port's plan and tensors, and the
    JAX reference's row-split (impl="xla") on the same numpy inputs."""
    m, k, npr = KINDS[kind]
    ja = jrandom_csr(jax.random.PRNGKey(3), m, k, nnz_per_row=npr)
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(4)
    vals = np.array(ja.vals, np.float32)
    b = rng.standard_normal(LEAD + (k, N)).astype(np.float32)
    bias = rng.standard_normal(m).astype(np.float32)
    res = rng.standard_normal(LEAD + (m, N)).astype(np.float32)
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind), vals, ja.shape,
                                device="cpu")
    plan = build_plan(ta, PlanPolicy(method="rowsplit"))
    # The two planners are array-equal (tests/test_torch_plan.py): the
    # reference runs on the port plan's arrays.
    jfwd = {name: jnp.asarray(x.numpy()) for name, x in plan.fwd.items()
            if name in ("cols", "slot_nz")}
    spec = EPILOGUES[ep_name]
    kw = {}
    if spec is not None:
        kw["epilogue"] = JEpilogue(**spec)
        if spec.get("bias"):
            kw["bias"] = jnp.asarray(bias)
        if spec.get("residual"):
            kw["residual"] = jnp.asarray(res)
    want = jops.rowsplit_execute(jfwd, jnp.asarray(vals, jdt),
                                 jnp.asarray(b, jdt), m=m, impl="xla", **kw)
    t = dict(vals=torch.from_numpy(vals).to(tdt),
             b=torch.from_numpy(b).to(tdt), bias=torch.from_numpy(bias),
             res=torch.from_numpy(res))
    return plan, t, np.asarray(want, np.float32)


@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_schedule_matches_reference(kind, parts, dt, ep_name):
    plan, t, want = _case(kind, dt, ep_name)
    m = plan.meta.m
    spec = EPILOGUES[ep_name]
    kw = {}
    if spec is not None:
        kw["epilogue"] = Epilogue(**spec)
        if spec.get("bias"):
            kw["bias"] = t["bias"]
        if spec.get("residual"):
            kw["residual"] = t["res"]
    got = ref.rowsplit_schedule_ref(plan.fwd, t["vals"], t["b"], m, parts,
                                    **kw)
    assert got.dtype == DTYPES[dt][1]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dt))


def test_schedule_shapes_of_the_cases():
    """The cases reach the schedule's edges: rows ending inside a group,
    empty rows, rows of exactly 32 j slots, m_pad > m, and parts that
    begin past a row's end (regular_long's 2 groups in 8 parts)."""
    lengths = {}
    for kind in KINDS:
        plan, t, _ = _case(kind, "f32", "none")
        nnz_pad = t["vals"].shape[0]
        live = plan.fwd["slot_nz"] < nnz_pad
        lengths[kind] = live.sum(1)
        assert plan.fwd["cols"].shape[0] >= plan.meta.m
    assert bool((lengths["regular_long"] % 32 != 0).all())
    assert bool((lengths["empty_heavy"] == 0).any())
    assert bool((lengths["two_groups"] == 64).all())
    plan, _, _ = _case("ragged_m", "f32", "none")
    assert plan.fwd["cols"].shape[0] == 48 and plan.meta.m == 45
    assert bool((lengths["ragged_m"][:45] > 32).any())
    assert -(-_case("regular_long", "f32", "none")[0].fwd["cols"].shape[1]
             // 32) < PARTS[-1]


def test_schedule_refuses_a_broken_prefix():
    """A live slot after a dead one breaks the contract the kernel's early
    stop relies on: the replay raises rather than read it."""
    plan, t, _ = _case("two_groups", "f32", "none")
    nnz_pad = t["vals"].shape[0]
    broken = {name: x.clone() for name, x in plan.fwd.items()
              if name in ("cols", "slot_nz")}
    broken["slot_nz"][0, 5] = nnz_pad              # a hole in group 0
    with pytest.raises(AssertionError, match="prefix"):
        ref.rowsplit_schedule_ref(broken, t["vals"], t["b"], plan.meta.m, 1)


@functools.lru_cache(maxsize=None)
def _patterns():
    """(name, reference CSR, port CSR) on the same arrays."""
    ja = jrandom_csr(jax.random.PRNGKey(5), 40, 96, nnz_per_row=(0, 50),
                     pad_to=None)
    jp = jgen.power_law(11, 512, 512, 4.0, alpha=1.6)
    jz = jrandom_csr(jax.random.PRNGKey(6), 12, 8, nnz_per_row=0)
    out = []
    for name, a in (("random", ja), ("power_law", jp), ("zero_nnz", jz)):
        out.append((name, a, convert.csr_from_numpy(
            np.asarray(a.row_ptr), np.asarray(a.col_ind),
            np.asarray(a.vals, np.float32), a.shape, device="cpu")))
    return out


@pytest.mark.parametrize("subset", ["all_rows", "permuted_subset"])
@pytest.mark.parametrize("pattern", ["random", "power_law", "zero_nnz"])
def test_ell_slots_prefix_property(pattern, subset):
    """ell_slots is element-for-element the reference's, and each row's
    live slots come first: every slot after the first dead one is dead."""
    _, ja, ta = next(p for p in _patterns() if p[0] == pattern)
    lengths = np.diff(np.asarray(ja.row_ptr))
    l = max(16, 16 * -(-int(lengths.max(initial=0)) // 16))
    rows = np.arange(ja.shape[0], dtype=np.int32)
    if subset == "permuted_subset":
        rows = np.random.default_rng(7).permutation(rows)[: len(rows) // 2 + 1]
    want = jax.jit(jrowsplit.ell_slots, static_argnames="l")(
        ja, jnp.asarray(rows), l=l)
    got = rowsplit_spmm.ell_slots(ta, torch.from_numpy(rows), l)
    for name in ("cols", "slot_nz"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    live = got["slot_nz"] < ta.nnz_pad
    first_dead = torch.cummin(live.int(), 1).values
    assert bool((live.int() == first_dead).all())
    assert bool((live[: len(rows)].sum(1) ==
                 torch.from_numpy(lengths[rows])).all())


@pytest.mark.parametrize("m,n,l,batch,sms,r", [
    (8192, 128, 512, 1, 132, 1),    # Llama-3.2-1B w1/w3: enough rows
    (2048, 128, 2048, 1, 132, 2),   # w2: 2048 warps -> 4096, one wave
    (2048, 256, 2048, 1, 132, 1),   # two column slices a row
    (2048, 128, 2048, 2, 132, 1),   # a batch of two
    (1024, 128, 2048, 1, 132, 4),
    (16, 128, 4112, 1, 132, 8),     # a few long rows: at most 8
    (16, 128, 96, 1, 132, 1),       # 3 groups: too few to split
    (16, 128, 256, 1, 132, 2),      # 8 groups: two parts of 4
    (262_144, 128, 11_856, 1, 132, 1),
])
def test_row_parts_rule(m, n, l, batch, sms, r):
    assert rowsplit_spmm.row_parts(m, n, l, batch, sms) == r


def test_body_codes_match_the_kernel():
    """_cuda.BODIES names the codes that the merge, row-split and SDDMM C
    entries report (enum SpmmBody in csrc/spmm_common.cuh), and each entry
    picks its body with the shared rule."""
    src = (_cuda.CSRC / "spmm_common.cuh").read_text()
    enum = re.search(r"enum SpmmBody : int \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kBodyScalar": _cuda.BODIES.index("scalar"),
                     "kBodyF32x4": _cuda.BODIES.index("f32x4"),
                     "kBodyBf16x8": _cuda.BODIES.index("bf16x8"),
                     "kBodyStaged": _cuda.BODIES.index("staged")}
    for name in ("merge_spmm.cu", "rowsplit_spmm.cu", "sddmm.cu"):
        assert "pick_body(" in (_cuda.CSRC / name).read_text(), name


def test_plain_runs_count_no_launch():
    """On the CPU the op runs the plain version: no launch is counted, by
    body or in all."""
    plan, t, _ = _case("irregular", "f32", "none")
    before = (rowsplit_spmm.LAUNCHES, dict(rowsplit_spmm.LAUNCHES_BY_BODY))
    ops.rowsplit_execute(plan.fwd, t["vals"], t["b"], m=plan.meta.m,
                         impl="torch")
    assert (rowsplit_spmm.LAUNCHES,
            rowsplit_spmm.LAUNCHES_BY_BODY) == before
