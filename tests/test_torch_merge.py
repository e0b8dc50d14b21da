"""The merge kernel's schedule, on the CPU: ``ref.merge_schedule_ref``
replays what ``csrc/merge_spmm.cu`` does (equal ranges of G chunks, the
rows inside a range complete with their epilogue, the two end rows carried
out, a fix-up that sums them in worker order) in tensor ops, and is held
against the JAX reference's merge on the same numpy inputs; plus the
split rows, the body rule, the launch counters and the port's copy of the
reference's power-law generator.

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
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.core import build_plan as jbuild_plan  # noqa: E402
from repro.core import random_csr as jrandom_csr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.matrices import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Epilogue, PlanPolicy, build_plan  # noqa: E402
from repro_torch.core import power_law_csr  # noqa: E402
from repro_torch.kernels import _cuda, merge_spmm, ops, ref  # noqa: E402

# tests/test_kernels.py MATRIX_KINDS, plus a 0-nnz pattern.
KINDS = {
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
    "zero_nnz": (16, 8, 0),
}
# Worker counts asked for; "all" is one chunk a worker.
WORKERS = [1, 2, 3, 7, "all"]
EPILOGUE = dict(bias=True, activation="gelu", scale=0.5, residual=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LEAD, N = (2,), 24


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _case(kind, dt, with_epilogue):
    """One problem in both packages: the port's plan and tensors, and the
    JAX reference's merge (impl="xla") on the same numpy inputs."""
    m, k, npr = KINDS[kind]
    ja = jrandom_csr(jax.random.PRNGKey(7), m, k, nnz_per_row=npr)
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(8)
    vals = np.array(ja.vals, np.float32)
    b = rng.standard_normal(LEAD + (k, N)).astype(np.float32)
    bias = rng.standard_normal(m).astype(np.float32)
    res = rng.standard_normal(LEAD + (m, N)).astype(np.float32)
    jp = jbuild_plan(ja, policy=JPlanPolicy(method="merge", tunedb=None))
    kw = {}
    if with_epilogue:
        kw = dict(epilogue=JEpilogue(**EPILOGUE), bias=jnp.asarray(bias),
                  residual=jnp.asarray(res))
    want = jops.merge_execute(jp.fwd, jnp.asarray(vals, jdt),
                              jnp.asarray(b, jdt), m=m, impl="xla", **kw)
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind), vals, ja.shape,
                                device="cpu")
    plan = build_plan(ta, PlanPolicy(method="merge"))
    t = dict(vals=torch.from_numpy(vals).to(tdt),
             b=torch.from_numpy(b).to(tdt), bias=torch.from_numpy(bias),
             res=torch.from_numpy(res))
    return plan, t, np.asarray(want, np.float32)


def _g(structure, workers):
    n_chunks = structure["cols"].shape[0]
    return 1 if workers == "all" else -(-n_chunks // workers)


@pytest.mark.parametrize("with_epilogue", [False, True])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_schedule_matches_reference(kind, workers, dt, with_epilogue):
    plan, t, want = _case(kind, dt, with_epilogue)
    m = plan.meta.m
    kw = {}
    if with_epilogue:
        kw = dict(epilogue=Epilogue(**EPILOGUE), bias=t["bias"],
                  residual=t["res"])
    got = ref.merge_schedule_ref(plan.fwd, t["vals"], t["b"], m,
                                 merge_spmm.TM, _g(plan.fwd, workers), **kw)
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dt))


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("kind", ["irregular", "short_rows", "single_col"])
def test_schedule_on_the_transpose_plan(kind, workers):
    """dB = Aᵀ·g runs the kernel on the transpose plan, whose slot_nz
    index the original values out of order."""
    plan, t, _ = _case(kind, "f32", False)
    m, k = plan.meta.shape
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (m, N)).astype(np.float32))
    want = ref.merge_execute_ref(plan.bwd, t["vals"], g, k, merge_spmm.TM)
    got = ref.merge_schedule_ref(plan.bwd, t["vals"], g, k, merge_spmm.TM,
                                 _g(plan.bwd, workers))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _workers_of_rows(structure, nnz_pad, g):
    """(most workers holding nonzeros of one row, workers with no live
    slot) for ranges of g chunks."""
    n_chunks, t = structure["cols"].shape
    workers = -(-n_chunks // g)
    live = (structure["slot_nz"] < nnz_pad).reshape(-1)
    worker = torch.arange(n_chunks * t) // (t * g)
    rows = (structure["tile"].long()[:, None] * merge_spmm.TM
            + structure["lrow"].long()).reshape(-1)
    held = torch.bincount(worker[live], minlength=workers)
    spans = {}
    for r, w in zip(rows[live].tolist(), worker[live].tolist()):
        spans.setdefault(r, set()).add(w)
    return max(map(len, spans.values()), default=0), int((held == 0).sum())


@pytest.mark.parametrize("kind,g,span,idle", [
    ("regular_long", 1, 3, 1),     # 33 nonzeros a row over chunks of 16
    ("single_row", 1, 4, 1),       # one row of 64 across 4 workers
    ("zero_nnz", 1, 0, 3),         # every worker idle
])
def test_split_rows_partition_the_rows(kind, g, span, idle):
    """Consecutive workers share one split row; S_{-1} = 0, S_{W-1} =
    m - 1, non-decreasing; each worker's live slots lie in its rows; the
    workers that open past the last live slot are a suffix and hold none;
    and the case has a row across ``span`` workers and ``idle`` workers
    without a live slot (the schedule's edge cases)."""
    plan, t, _ = _case(kind, "f32", False)
    m = plan.meta.m
    nnz_pad = t["vals"].shape[0]
    split, past_end = merge_spmm.split_rows(plan.fwd, m, g, nnz_pad)
    n_chunks, tt = plan.fwd["cols"].shape
    workers = -(-n_chunks // g)
    assert split.shape == (workers + 1,) and past_end.shape == (workers,)
    assert not past_end[0] and bool((past_end[1:] >= past_end[:-1]).all())
    assert split[0] == 0 and split[-1] == m - 1
    assert bool((split[1:] >= split[:-1]).all())
    got_span, got_idle = _workers_of_rows(plan.fwd, nnz_pad, g)
    assert got_span >= span and got_idle >= idle
    live = (plan.fwd["slot_nz"] < nnz_pad).reshape(-1)
    rows = (plan.fwd["tile"].long()[:, None] * merge_spmm.TM
            + plan.fwd["lrow"].long()).reshape(-1)
    worker = torch.arange(n_chunks * tt) // (tt * g)
    assert bool((rows[live] >= split[worker[live]]).all())
    assert bool((rows[live] <= split[worker[live] + 1]).all())
    assert not bool(past_end[worker[live]].any())


def test_range_chunks_rule():
    """G: SLOTS_PER_WORKER slots a worker (64 chunks at the default t)."""
    assert merge_spmm.range_chunks(merge_spmm.DEFAULT_T) == 64
    assert merge_spmm.range_chunks(32) == 32
    assert merge_spmm.range_chunks(24) == 42
    assert merge_spmm.range_chunks(1) == merge_spmm.SLOTS_PER_WORKER
    assert merge_spmm.range_chunks(10 ** 6) == 1


@pytest.mark.parametrize("dtype,n,aligned,body", [
    (torch.float32, 128, True, "f32x4"),
    (torch.float32, 160, True, "f32x4"),
    (torch.float32, 4, True, "f32x4"),
    (torch.float32, 1, True, "scalar"),      # one column: 4-byte loads
    (torch.float32, 130, True, "scalar"),    # rows off 16 bytes
    (torch.float32, 128, False, "scalar"),   # an operand off 16 bytes
    (torch.bfloat16, 128, True, "bf16x8"),
    (torch.bfloat16, 160, True, "bf16x8"),
    (torch.bfloat16, 132, True, "scalar"),   # 8 bf16 a lane: n % 8
    (torch.bfloat16, 32, False, "scalar"),
])
def test_body_rule(dtype, n, aligned, body):
    """Which body the kernel runs, as its C entry reports it and
    chip_smoke.py asserts it on the card (the rule is shared with
    row-split and the SDDMM)."""
    assert _cuda.body_for(dtype, n, aligned=aligned) == body


def test_body_rule_refuses_other_dtypes():
    with pytest.raises(TypeError):
        _cuda.body_for(torch.float16, 128)


def test_body_codes_match_the_kernel():
    """_cuda.BODIES names the codes that the C entry reports (enum SpmmBody in
    csrc/spmm_common.cuh, which csrc/merge_spmm.cu includes)."""
    src = (_cuda.CSRC / "spmm_common.cuh").read_text()
    enum = re.search(r"enum SpmmBody : int \{([^}]*)\}", src).group(1)
    codes = {name.strip(): int(val) for name, val in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"kBodyScalar": _cuda.BODIES.index("scalar"),
                     "kBodyF32x4": _cuda.BODIES.index("f32x4"),
                     "kBodyBf16x8": _cuda.BODIES.index("bf16x8"),
                     "kBodyStaged": _cuda.BODIES.index("staged")}
    assert '#include "spmm_common.cuh"' in (
        _cuda.CSRC / "merge_spmm.cu").read_text()


def test_plain_runs_count_no_launch():
    """On the CPU the op runs the plain version: no launch is counted, by
    body or in all."""
    plan, t, _ = _case("irregular", "f32", False)
    before = (merge_spmm.LAUNCHES, dict(merge_spmm.LAUNCHES_BY_BODY))
    ops.merge_execute(plan.fwd, t["vals"], t["b"], m=plan.meta.m,
                      impl="torch")
    assert (merge_spmm.LAUNCHES, merge_spmm.LAUNCHES_BY_BODY) == before


@pytest.mark.parametrize("seed,m,k,d,alpha", [
    (11, 512, 512, 4.0, 1.6),    # mini_powlaw (src/repro/matrices/suites.py)
    (5, 300, 200, 8.0, 1.2),     # a heavier tail, rows clipped to k
])
def test_power_law_csr_matches_reference(seed, m, k, d, alpha):
    want = jgen.power_law(seed, m, k, d, alpha=alpha)
    got = power_law_csr(seed, m, k, d, alpha=alpha)
    assert got.shape == want.shape
    for name in ("row_ptr", "col_ind", "vals"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
