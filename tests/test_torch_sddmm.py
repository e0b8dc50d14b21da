"""The SDDMM kernel's schedule, on the CPU: ``ref.sddmm_schedule_ref``
replays what ``csrc/sddmm.cu`` does (workers of g groups of 32 nonzeros,
lanes over a 128-column slice in each body's layout, one partial a lane a
nonzero written to the lanes' tile, the transposed reduction that sums
nonzero j's column in lane j, slices added in order, dead slots 0) in
tensor ops, and is held against the JAX reference's SDDMM on the same
numpy inputs; plus the body rule and the launch counters.

Tolerances: f32 the reference's forward 2e-5 (tests/test_kernels.py); bf16
inputs 2e-2 (the reference rounds its dots to bf16, the replay keeps
f32)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import PlanPolicy, build_plan, random_csr  # noqa: E402
from repro_torch.kernels import _cuda, ops, ref, sddmm  # noqa: E402

# tests/test_kernels.py MATRIX_KINDS (their groups of 32 straddle rows),
# a padded tail (nnz_pad = nnz + 45: a group of pads and a ragged last
# group) and the 0-nnz pattern (one padded slot).
KINDS = {
    "regular_long": (64, 96, 33, None),
    "irregular": (48, 64, (0, 24), None),
    "short_rows": (96, 64, (0, 4), None),
    "empty_heavy": (64, 32, (0, 2), None),
    "single_row": (1, 128, 64, None),
    "single_col": (64, 1, 1, None),
    "padded_tail": (40, 48, (0, 12), "nnz+45"),
    "zero_nnz": (16, 8, 0, None),
}
# The body's layout, with the dtype it reads.
BODIES = {"f32x4": "f32", "scalar": "f32", "bf16x8": "bf16"}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# Groups a worker: one, two, and all of them in one worker.
GROUPS = [1, 2, "all"]
LEAD = (2,)


@functools.lru_cache(maxsize=None)
def _case(kind, dt, n):
    """The plan's coordinates, dC and B, and the JAX reference's SDDMM
    (impl="xla") on the same numpy inputs, in float32."""
    m, k, npr, pad = KINDS[kind]
    a = random_csr(13, m, k, nnz_per_row=npr)
    if pad is not None:
        a = random_csr(13, m, k, nnz_per_row=npr, pad_to=a.nnz() + 45)
    fwd = build_plan(a, PlanPolicy(method="merge",
                                   with_transpose=False)).fwd
    coords = tuple(fwd[x] for x in ("nz_rows", "nz_cols", "nz_valid"))
    rng = np.random.default_rng(14)
    jdt, tdt = DTYPES[dt]
    dc = rng.standard_normal(LEAD + (m, n)).astype(np.float32)
    b = rng.standard_normal(LEAD + (k, n)).astype(np.float32)
    want = jops.sddmm(*(jnp.asarray(c.numpy()) for c in coords),
                      jnp.asarray(dc, jdt), jnp.asarray(b, jdt), impl="xla")
    t = dict(dc=torch.from_numpy(dc).to(tdt), b=torch.from_numpy(b).to(tdt))
    return coords, t, np.asarray(want, np.float32), a.nnz()


@pytest.mark.parametrize("n", [24, 160])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_schedule_matches_reference(kind, body, g, n):
    dt = BODIES[body]
    coords, t, want, nnz = _case(kind, dt, n)
    nnz_pad = coords[0].shape[0]
    groups = -(-nnz_pad // 32) if g == "all" else g
    got = ref.sddmm_schedule_ref(*coords, t["dc"], t["b"], groups, body)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == LEAD + (nnz_pad,)
    assert not got[..., nnz:].any()
    tol = dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_schedule_shapes_of_the_cases():
    """The cases reach the schedule's edges: groups that straddle rows,
    a padded tail with a ragged last group, and the 0-nnz pattern."""
    coords, _, _, nnz = _case("irregular", "f32", 24)
    rows = coords[0][:nnz - nnz % 32].reshape(-1, 32)
    assert bool((rows[:, 0] != rows[:, -1]).any())
    coords, _, _, nnz = _case("padded_tail", "f32", 24)
    assert coords[0].shape[0] == nnz + 45 and (nnz + 45) % 32 != 0
    assert -(-(nnz + 45) // 32) > -(-nnz // 32)    # a group of pads alone
    coords, _, _, nnz = _case("zero_nnz", "f32", 24)
    assert nnz == 0 and coords[0].shape[0] == 1


def test_transposed_reduction_sums_each_column_in_lane_order():
    """The reduction alone, on integers (exact in float32): nonzero j's sum
    is column j of the lanes' tile, for 32 lanes and for 16."""
    for k in (32, 16):
        tile = torch.arange(k * k, dtype=torch.float32).reshape(k, k)
        torch.testing.assert_close(ref._transposed_sums(tile), tile.sum(0))


@pytest.mark.parametrize("dtype,n,aligned,body", [
    (torch.float32, 128, True, "f32x4"),     # the training path
    (torch.bfloat16, 128, True, "bf16x8"),
    (torch.float32, 1, True, "scalar"),
    (torch.bfloat16, 132, True, "scalar"),
    (torch.float32, 128, False, "scalar"),   # dc's dtype is not b's
])
def test_body_rule(dtype, n, aligned, body):
    """The SDDMM shares the SpMMs' body rule (its C entry reports the body
    it ran, which chip_smoke.py holds to this rule on the card)."""
    assert _cuda.body_for(dtype, n, aligned=aligned) == body


def test_plain_runs_count_no_launch():
    """On the CPU the op runs the plain version: no launch is counted, by
    body or in all."""
    coords, t, _, _ = _case("irregular", "f32", 24)
    before = (sddmm.LAUNCHES, dict(sddmm.LAUNCHES_BY_BODY))
    ops.sddmm(*coords, t["dc"], t["b"], impl="torch")
    assert (sddmm.LAUNCHES, sddmm.LAUNCHES_BY_BODY) == before
