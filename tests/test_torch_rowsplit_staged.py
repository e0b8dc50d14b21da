"""The row-split kernel's staged body (``csrc/rowsplit_spmm.cu``): B read
from windows that TMA stages in shared memory once per block of rows.

On the CPU: ``ref.rowsplit_staged_ref`` replays the body's windows and
per-row cursors in tensor ops and must equal ``ref.rowsplit_schedule_ref``
at one part exactly (the same products summed in the same order) on random
ELL structures and their edges; it refuses a row whose columns descend;
the plan records whether every row's columns ascend; ``use_staged`` is a
pure function of the body, that flag and the launch's tiles; and the
launch model of a staged launch passes the kernel audit.

On the card (the ``cuda`` cases, which skip without one; PyTorch alone, no
JAX, so they run on the machine with the card):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rowsplit_staged.py

the staged body must equal the warp-per-row body at one part bit for bit,
and its plain version at the f32 tolerances of the reference's kernel
tests (rtol/atol 2e-5), at the benchmark's four launch shapes (Qwen2's
rows cut) and on the edges: k not a multiple of the window, m not a
multiple of the block's rows, n = 132, empty rows, rows with no nonzero in
some windows, ragged rows, the epilogues, bf16 values and output.  A
structure with a descending row never runs it.
"""
import dataclasses
import functools
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.analysis import access, kernel_audit  # noqa: E402
from repro_torch.analysis.kernel_audit import Variant  # noqa: E402
from repro_torch.core import (Epilogue, PlanPolicy, build_plan,  # noqa: E402
                              prune_to_csr)
from repro_torch.core.csr import from_dense  # noqa: E402
from repro_torch.kernels import introspect as I  # noqa: E402
from repro_torch.kernels import _cuda, ref, rowgroup_spmm  # noqa: E402
from repro_torch.kernels import rowsplit_spmm  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
EPILOGUES = {
    "none": None,
    "bias_gelu_scale_residual": dict(bias=True, activation="gelu",
                                     scale=0.5, residual=True),
    "relu": dict(activation="relu"),
}
W = rowsplit_spmm.STAGED_WINDOW


def _pattern(kind, m, k, seed):
    """A (m, k) CSR pattern with ascending columns and the rows a kind
    asks for, as numpy (row_ptr, col_ind, vals)."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(m):
        if kind == "ragged":            # 0 .. k/2 nonzeros, any columns
            n_r = int(rng.integers(0, k // 2 + 1))
            cols = rng.choice(k, n_r, replace=False)
        elif kind == "window_gaps":     # columns in every other window
            pool = np.flatnonzero((np.arange(k) // W) % 2 == r % 2)
            cols = rng.choice(pool, min(len(pool), 40), replace=False)
        elif kind == "empty_rows":      # a quarter dense, every 3rd empty
            cols = np.flatnonzero(rng.random(k) < 0.25) if r % 3 else []
        elif kind == "exact_groups":    # 32 j nonzeros a row
            cols = rng.choice(k, 32 * (1 + r % 3), replace=False)
        else:                           # "quarter": 25 % dense
            cols = np.flatnonzero(rng.random(k) < 0.25)
        rows.append(np.sort(np.asarray(cols, np.int64)))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in rows])])
    col_ind = np.concatenate(rows + [np.zeros(0, np.int64)])
    vals = rng.standard_normal(len(col_ind)).astype(np.float32)
    return row_ptr, col_ind, vals


# kind: (m, k, n, batch).  k past a multiple of the window, m past a
# multiple of the block's rows, n = 132 (a slice of 4 columns).
CASES = {
    "quarter": (70, 300, 132, 2),
    "ragged": (45, 200, 24, 1),
    "window_gaps": (33, 4 * W + 5, 16, 2),
    "empty_rows": (64, 2 * W, 8, 1),
    "exact_groups": (24, 160, 12, 2),
}


@functools.lru_cache(maxsize=None)
def _problem(kind, device="cpu"):
    m, k, n, batch = CASES[kind]
    row_ptr, col_ind, vals = _pattern(kind, m, k, seed=len(kind))
    a = convert.csr_from_numpy(row_ptr, col_ind, vals, (m, k),
                               device=device)
    plan = build_plan(a, PlanPolicy(method="rowsplit",
                                    with_transpose=False))
    rng = np.random.default_rng(7)
    t = dict(b=rng.standard_normal((batch, k, n)).astype(np.float32),
             bias=rng.standard_normal(m).astype(np.float32),
             res=rng.standard_normal((batch, m, n)).astype(np.float32))
    t = {name: torch.from_numpy(x).to(device) for name, x in t.items()}
    return a, plan, t


def _kw(ep_name, t):
    spec = EPILOGUES[ep_name]
    if spec is None:
        return {}
    kw = dict(epilogue=Epilogue(**spec))
    if spec.get("bias"):
        kw["bias"] = t["bias"]
    if spec.get("residual"):
        kw["residual"] = t["res"]
    return kw


# ------------------------------------------------------------- the CPU --

@pytest.mark.parametrize("window", [16, W])
@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@pytest.mark.parametrize("kind", sorted(CASES))
def test_staged_replay_equals_schedule(kind, ep_name, window):
    """The windows take every live slot once, in slot order, from its own
    window: the sums are rowsplit_schedule_ref's at one part exactly."""
    a, plan, t = _problem(kind)
    kw = _kw(ep_name, t)
    got = ref.rowsplit_staged_ref(plan.fwd, a.vals, t["b"], a.m,
                                  window=window, **kw)
    want = ref.rowsplit_schedule_ref(plan.fwd, a.vals, t["b"], a.m, 1,
                                     **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_cases_reach_the_edges():
    """k past a multiple of the window, m past a multiple of the block's
    rows, n past a multiple of 128, empty rows, rows with no nonzero in
    some windows, rows of exactly 32 j slots, and ragged rows."""
    lengths = {kind: np.diff(_problem(kind)[0].row_ptr.numpy())
               for kind in CASES}
    assert any(CASES[kind][1] % W for kind in CASES)
    assert any(CASES[kind][0] % rowsplit_spmm.STAGED_ROWS for kind in CASES)
    assert any(CASES[kind][2] % 128 for kind in CASES)
    assert (lengths["empty_rows"] == 0).any()
    assert (lengths["ragged"] % 32 != 0).any() and \
        len(set(lengths["ragged"].tolist())) > 10
    assert (lengths["exact_groups"] % 32 == 0).all()
    a = _problem("window_gaps")[0]
    win = a.col_ind[:a.nnz()].long() // W
    assert set(win[: int(a.row_ptr[1])].tolist()) == {0, 2, 4}


def test_staged_replay_refuses_a_descending_row():
    """A row whose columns descend across windows would be read outside
    its window: the replay raises, as the rule keeps the kernel off it."""
    row_ptr, col_ind = np.array([0, 2, 3]), np.array([3 * W, 5, 1])
    a = convert.csr_from_numpy(row_ptr, col_ind,
                               np.ones(3, np.float32), (2, 4 * W),
                               device="cpu")
    plan = build_plan(a, PlanPolicy(method="rowsplit",
                                    with_transpose=False))
    assert plan.fwd["ascending"] is False
    with pytest.raises(AssertionError, match="descend"):
        ref.rowsplit_staged_ref(plan.fwd, a.vals, torch.ones(4 * W, 4), 2)


def test_plans_record_ascending_columns():
    """Pruned and dense-built patterns ascend; a row given out of order
    does not; the flag is a host bool in every ELL block (row-split's and
    each of rowgroup's length buckets)."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(96, 80, generator=g)
    for a in (prune_to_csr(w, 0.25), from_dense(w * (w > 1))):
        plan = build_plan(a, PlanPolicy(method="rowsplit",
                                        with_transpose=False))
        assert plan.fwd["ascending"] is True
        groups = rowgroup_spmm.plan_rowgroup_structure(a)["groups"]
        assert all(gs["ascending"] is True for gs in groups)
    bad = convert.csr_from_numpy(np.array([0, 1, 3]), np.array([0, 7, 2]),
                                 np.ones(3, np.float32), (2, 8),
                                 device="cpu")
    assert rowsplit_spmm.plan_rowsplit_structure(
        bad, l_pad=2)["ascending"] is False
    assert rowsplit_spmm.ell_slots(bad, torch.tensor([0]), 16)[
        "ascending"] is True
    assert rowsplit_spmm.ell_slots(bad, torch.tensor([1]), 16)[
        "ascending"] is False


# (m, n, batch) of the benchmark's launches and the online cell's.
GRANITE_W1, GRANITE_W2 = 8192, 2048
QWEN_W1, QWEN_W2 = 29568, 8192


@pytest.mark.parametrize("body,ascending,m,n,batch,sms,want", [
    ("f32x4", True, GRANITE_W1, 256, 8, 132, True),    # backlog w1, w3
    ("f32x4", True, GRANITE_W2, 256, 8, 132, True),    # backlog w2
    ("f32x4", True, QWEN_W1, 256, 4, 132, True),
    ("f32x4", True, QWEN_W2, 256, 4, 132, True),
    ("f32x4", True, GRANITE_W1, 256, 1, 132, True),    # 171 tiles
    ("f32x4", True, GRANITE_W2, 256, 1, 132, False),   # 43 tiles
    ("f32x4", True, GRANITE_W2, 512, 2, 132, True),    # 172 tiles
    ("f32x4", True, GRANITE_W1, 128, 8, 132, False),   # half a tile wide
    ("f32x4", True, GRANITE_W1, 160, 8, 132, False),
    ("f32x4", False, GRANITE_W1, 256, 8, 132, False),  # a descending row
    ("bf16x8", True, GRANITE_W1, 256, 8, 132, False),  # bf16 B
    ("scalar", True, GRANITE_W1, 1, 8, 132, False),    # decode
    ("f32x4", True, 48, 256, 4, 4, True),              # 4 tiles, 4 SMs
    ("f32x4", True, 48, 256, 3, 4, False),             # 3 tiles
])
def test_use_staged_rule(body, ascending, m, n, batch, sms, want):
    R = rowsplit_spmm
    assert R.staged_tiles(m, n, batch) == \
        batch * -(-m // R.STAGED_ROWS) * -(-n // R.STAGED_COLS)
    assert R.use_staged(body, ascending, m, n, batch, sms) is want


def test_staged_constants_match_the_kernel():
    """The wrapper's rule and launch model read the staged body's sizes
    from rowsplit_spmm.py; they are the kernel's constexprs."""
    src = (_cuda.CSRC / "rowsplit_spmm.cu").read_text()
    got = {name: int(v) for name, v in re.findall(
        r"constexpr int kStaged(\w+) = (\d+);", src)}
    assert got == {"Warps": rowsplit_spmm.STAGED_WARPS,
                   "RowsPerWarp": rowsplit_spmm.STAGED_ROWS_PER_WARP,
                   "Halves": rowsplit_spmm.STAGED_HALVES,
                   "Window": rowsplit_spmm.STAGED_WINDOW,
                   "Stages": rowsplit_spmm.STAGED_STAGES}


F32 = Variant("f32", "float32", "float32", "float32", None, None)


def _small_card(sms):
    return dataclasses.replace(I.H100_SXM, sms=sms)


@pytest.mark.parametrize("ep_name", ["none", "bias_gelu_scale_residual"])
@pytest.mark.parametrize("kind", ["quarter", "ragged", "empty_rows"])
def test_staged_launch_model(kind, ep_name):
    """Where the rule picks the staged body, the model is its launch: the
    overload of rowsplit_kernel with body code 3, a block a tile, the
    producer warp, the ring and the pairs in dynamic shared memory, one
    block an SM, B requested once per block of rows, each live value
    gathered once a (batch, slice); it passes the audit (K020 K030 K040,
    T110 T120)."""
    R = rowsplit_spmm
    a, plan, t = _problem(kind)
    m, k = a.shape
    batch, n = 2, 512
    spec = EPILOGUES[ep_name]
    var = F32 if spec is None else dataclasses.replace(
        F32, epilogue=Epilogue(**spec))
    tiles = R.staged_tiles(m, n, batch)
    slices = -(-n // R.STAGED_COLS)
    assert tiles == batch * -(-m // R.STAGED_ROWS) * slices
    (model,) = R.launch_models(plan, n, batch, var, _small_card(tiles))
    assert model.body == "staged"
    assert model.symbol == "repro::rowsplit_kernel<3, float, float, float>"
    assert model.grid == (tiles, 1, 1)
    assert model.block == 32 * (R.STAGED_WARPS + 1)
    assert model.dynamic_smem == (
        R.STAGED_STAGES * R.STAGED_WINDOW * R.STAGED_COLS * 4
        + R.STAGED_ROWS * 64 * 8 + 128)
    assert model.static_smem == 16 * R.STAGED_STAGES
    assert model.min_blocks == 1
    ops = {o.name: o for o in model.operands}
    assert ops["b"].read_bytes == 4 * batch * -(-m // R.STAGED_ROWS) * k * n
    assert ops["b"].warp == ()
    assert ops["vals"].read_bytes == 4 * batch * slices * a.nnz()
    assert ops["out"].write_bytes == 4 * batch * m * n
    assert ("bias" in ops) == (spec is not None)
    diags, ok = kernel_audit.audit_models("staged", [model],
                                          _small_card(tiles))
    assert ok and not diags, diags
    assert access.check_launch(model) == []
    # One SM more and the launch no longer fills the card: warp-per-row.
    (model,) = R.launch_models(plan, n, batch, var, _small_card(tiles + 1))
    assert model.body == "f32x4" and model.block == 256


def test_staged_walk_counts_the_groups_fetched():
    """cols/slot_nz: the first three groups of a row, then one a group
    taken whole (a row of 64 live slots fetches 5 groups), over l's lanes;
    each live value once."""
    row_ptr = np.array([0, 64, 64, 100])
    col_ind = np.concatenate([np.arange(64), np.arange(36) * 2])
    a = convert.csr_from_numpy(row_ptr, col_ind,
                               np.ones(100, np.float32), (3, 256),
                               device="cpu")
    plan = build_plan(a, PlanPolicy(method="rowsplit", l_pad=144,
                                    with_transpose=False))
    l = plan.fwd["cols"].shape[1]
    assert l == 144                 # groups of 32, 32, 32, 32 and 16
    n = rowsplit_spmm.STAGED_COLS
    (model,) = rowsplit_spmm.launch_models(plan, n, 2, F32, _small_card(1))
    assert model.body == "staged"
    ops = {o.name: o for o in model.operands}
    # row 0 (64 live): groups 0-4, 144 lanes; row 1 (empty): groups 0-2,
    # 96 lanes; row 2 (36 live): groups 0-3, 128 lanes; one slice.
    assert ops["cols"].read_bytes == 4 * 2 * (144 + 96 + 128)
    assert ops["vals"].read_bytes == 4 * 2 * 100


# ------------------------------------------------------------ the card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launch(plan, vals, b, m, **kw):
    """One launch; returns C and the body the C entry reported."""
    before = dict(rowsplit_spmm.LAUNCHES_BY_BODY)
    out = rowsplit_spmm.rowsplit_spmm_cuda(plan.fwd, vals, b, m, **kw)
    torch.cuda.synchronize()
    ran = [key for key, v in rowsplit_spmm.LAUNCHES_BY_BODY.items()
           if v != before.get(key, 0)]
    assert len(ran) == 1
    return out, ran[0]


def _hold(plan, vals, b, m, **kw):
    """The staged body against the warp-per-row body at one part (bit for
    bit) and the plain version (2e-5)."""
    got, body = _launch(plan, vals, b, m, staged=True, **kw)
    assert body == "staged"
    row, body = _launch(plan, vals, b, m, parts=1, **kw)
    assert body == "f32x4"
    assert torch.equal(got, row)
    want = ref.rowsplit_execute_ref(plan.fwd, vals, b, m, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@pytest.mark.parametrize("kind", sorted(CASES))
def test_staged_equals_warp_per_row_on_card(kind, ep_name):
    dev = _card()
    a, plan, t = _problem(kind, device=str(dev))
    _hold(plan, a.vals, t["b"], a.m, **_kw(ep_name, t))


@pytest.mark.cuda
def test_staged_bf16_values_and_output_on_card():
    dev = _card()
    a, plan, t = _problem("quarter", device=str(dev))
    vals = a.vals.to(torch.bfloat16)
    got, body = _launch(plan, vals, t["b"], a.m, staged=True,
                        out_dtype=torch.bfloat16)
    row, _ = _launch(plan, vals, t["b"], a.m, parts=1,
                     out_dtype=torch.bfloat16)
    assert body == "staged" and got.dtype == torch.bfloat16
    assert torch.equal(got, row)


# The benchmark's launches: (m, k, rows kept, n, batch); Qwen2-72B's rows
# cut to keep the plain version's (rows, l, n) gather small.
SHAPES = {
    "granite_w1": (GRANITE_W1, 2048, GRANITE_W1, 256, 8),
    "granite_w2": (GRANITE_W2, 8192, GRANITE_W2, 256, 8),
    "qwen2_w1": (QWEN_W1, 8192, 2048, 256, 4),
    "qwen2_w2": (QWEN_W2, 29568, 1024, 256, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_staged_at_the_benchmark_shapes_on_card(shape):
    dev = _card()
    _, k, rows, n, batch = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(rows, k, generator=g, device=dev) * k ** -0.5
    a = prune_to_csr(w, 0.25)
    del w
    plan = build_plan(a, PlanPolicy(method="rowsplit",
                                    with_transpose=False))
    assert plan.fwd["ascending"] is True
    b = torch.randn(batch, k, n, generator=g, device=dev)
    if rows == SHAPES[shape][0]:      # full size: the rule picks it
        _, body = _launch(plan, a.vals, b, a.m)
        assert body == "staged"
    for i in range(batch):            # the plain version a batch at a time
        got, _ = _launch(plan, a.vals, b[i:i + 1], a.m, staged=True)
        row, _ = _launch(plan, a.vals, b[i:i + 1], a.m, parts=1)
        assert torch.equal(got, row)
        want = ref.rowsplit_execute_ref(plan.fwd, a.vals, b[i:i + 1], a.m)
        torch.testing.assert_close(got, want, **TOL)
    got, _ = _launch(plan, a.vals, b, a.m, staged=True)
    row, _ = _launch(plan, a.vals, b, a.m, parts=1)
    assert torch.equal(got, row)


@pytest.mark.cuda
def test_descending_row_never_staged_on_card():
    """The rule keeps a structure with a descending row on the warp-per-row
    body, even at a wide launch; forcing the staged body raises."""
    dev = _card()
    m, k, n, batch = 4096, 512, 256, 8
    rng = np.random.default_rng(9)
    row_ptr = np.arange(m + 1) * 8
    col_ind = np.stack([rng.choice(k, 8, replace=False) for _ in range(m)])
    col_ind[:, :] = np.sort(col_ind, 1)
    col_ind[7] = col_ind[7][::-1]                   # one descending row
    a = convert.csr_from_numpy(row_ptr, col_ind.reshape(-1),
                               rng.standard_normal(8 * m).astype(np.float32),
                               (m, k), device=str(dev))
    plan = build_plan(a, PlanPolicy(method="rowsplit",
                                    with_transpose=False))
    assert plan.fwd["ascending"] is False
    b = torch.randn(batch, k, n, device=dev)
    assert rowsplit_spmm.use_staged(
        "f32x4", True, m, n, batch,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    got, body = _launch(plan, a.vals, b, m)
    assert body == "f32x4"
    torch.testing.assert_close(
        got, ref.rowsplit_execute_ref(plan.fwd, a.vals, b, m), **TOL)
    with pytest.raises(ValueError, match="ascend"):
        rowsplit_spmm.rowsplit_spmm_cuda(plan.fwd, a.vals, b, m, staged=True)


@pytest.mark.cuda
def test_launch_below_the_rule_runs_warp_per_row_on_card():
    """A launch the rule does not pick runs the warp-per-row body with the
    rule's parts, exactly as an explicit call of them."""
    dev = _card()
    a, plan, t = _problem("quarter", device=str(dev))
    got, body = _launch(plan, a.vals, t["b"], a.m)
    assert body == "f32x4"
    l = plan.fwd["cols"].shape[1]
    parts = rowsplit_spmm.row_parts(a.m, t["b"].shape[-1], l,
                                    t["b"].shape[0],
                                    torch.cuda.get_device_properties(
                                        dev).multi_processor_count)
    want, _ = _launch(plan, a.vals, t["b"], a.m, parts=parts)
    assert torch.equal(got, want)
