"""The training slice as a whole — sparse fine-tuning of a pruned MLP — in
the port against the JAX reference.

The reference prunes and plans a small MLP (swiglu: w1/w3/w2; gelu: w1/w2,
whose w1 runs the fused nonlinear epilogue); ``repro_torch.convert`` carries
each layer's CSR across, so both trainers start from identical patterns
and values.  Five SGD steps of the port's ``make_sparse_train_step`` (the
plain versions on the CPU) against the reference's
``make_sparse_train_step(impl="xla")`` on the same numpy batch: losses and
values agree at rtol 1e-4 / atol 1e-5 (the gradient tolerance of
tests/test_spmm_grad.py; f32 sums in other orders, five steps deep).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.models.sparse import prune_mlp as jprune_mlp  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import PlanPolicy, SparseMatrix  # noqa: E402
from repro_torch.engine import cache_stats  # noqa: E402
from repro_torch.models import sparse as S  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

D_MODEL, D_FF, KEEP, LR, STEPS = 16, 48, 0.25, 0.5, 5
TOL = dict(rtol=1e-4, atol=1e-5)


def _mlp(kind, seed=1):
    rng = np.random.default_rng(seed)
    w = lambda *shape: (rng.standard_normal(shape) * shape[0] ** -0.5
                        ).astype(np.float32)
    p = {"w1": w(D_MODEL, D_FF), "w2": w(D_FF, D_MODEL)}
    if kind == "swiglu":
        p["w3"] = w(D_MODEL, D_FF)
    x = rng.standard_normal((2, 4, D_MODEL)).astype(np.float32)
    # The target is the dense MLP's output: the pruned layer is fine-tuned
    # toward the weights it came from.
    h = x @ p["w1"]
    if kind == "swiglu":
        h = h / (1 + np.exp(-h)) * (x @ p["w3"])
    else:
        h = 0.5 * h * (1 + np.tanh(0.7978845608028654 * (
            h + 0.044715 * h ** 3)))
    return p, x, (h @ p["w2"]).astype(np.float32)


def _both(kind, method):
    """(reference layers, port layers) of one pruned MLP."""
    p, x, y = _mlp(kind)
    jsp = jprune_mlp({k: jnp.asarray(v) for k, v in p.items()}, KEEP,
                     policy=JPlanPolicy(method=method, tunedb=None))
    tsp = convert.sparse_mlp_from_numpy(
        {name: (np.asarray(sl.weight.row_ptr), np.asarray(sl.weight.col_ind),
                np.asarray(sl.weight.vals), sl.weight.shape)
         for name, sl in jsp.items()},
        policy=PlanPolicy(method=method), device="cpu")
    for name, jl in jsp.items():
        assert tsp[name].method == jl.method == method
        assert tsp[name].plan.bwd is not None
    return jsp, tsp, x, y


@pytest.mark.parametrize("method", ["merge", "rowsplit"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_sparse_train_step_matches_reference(kind, method):
    jsp, tsp, x, y = _both(kind, method)
    jstep, jvals = jsteps.make_sparse_train_step(jsp, lr=LR, impl="xla")
    jstep = jax.jit(jstep)
    tstep, tvals = steps.make_sparse_train_step(tsp, lr=LR)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = cache_stats()
    jlosses, tlosses = [], []
    for _ in range(STEPS):
        jvals, jloss = jstep(jvals, jnp.asarray(x), jnp.asarray(y))
        tvals, tloss = tstep(tvals, tx, ty)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    assert cache_stats().misses == before.misses, "a step built a plan"
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    for name in jvals:
        assert not tvals[name].requires_grad
        np.testing.assert_allclose(tvals[name].numpy(),
                                   np.asarray(jvals[name]), err_msg=name,
                                   **TOL)
    # The loss falls, as in test_sparse_train_step_learns.
    assert all(b < a for a, b in zip(tlosses, tlosses[1:])), tlosses
    assert tlosses[-1] < 0.9 * tlosses[0], tlosses


def test_train_step_refuses_forward_only_plans():
    """A layer planned without the transpose (as serving plans) raises
    before the first step, naming the policy field that fixes it."""
    _, tsp, _, _ = _both("gelu", "rowsplit")
    fwd_only = {name: sl.with_plan(PlanPolicy(method="rowsplit",
                                              with_transpose=False))
                for name, sl in tsp.items()}
    assert all(sl.plan.bwd is None for sl in fwd_only.values())
    with pytest.raises(ValueError, match="with_transpose"):
        steps.make_sparse_train_step(fwd_only)


def test_ensure_spmm_plans_walks_dicts_and_lists():
    """Plans replay from the cache (0 built); other leaves pass through;
    an explicit policy re-plans; sharded plans are refused."""
    _, tsp, _, _ = _both("gelu", "merge")
    mtx = SparseMatrix(tsp["w1"].weight).plan(PlanPolicy(method="merge"))
    tree = {"mlp": tsp, "extra": [mtx, 3, "x"]}
    before = cache_stats()
    out = steps.ensure_spmm_plans(tree)
    assert cache_stats().misses == before.misses
    assert out["extra"][1:] == [3, "x"]
    assert out["extra"][0].spmm_plan is mtx.spmm_plan
    assert all(out["mlp"][n].plan is sl.plan for n, sl in tsp.items())
    rs = steps.ensure_spmm_plans(tsp, PlanPolicy(method="rowsplit"))
    assert {sl.method for sl in rs.values()} == {"rowsplit"}
    with pytest.raises(ValueError, match="not ported"):
        steps.ensure_spmm_plans(tsp, mesh=object())


def test_mlp_with_vals_rebinds_values_only():
    _, tsp, _, _ = _both("swiglu", "merge")
    vals = {k: v * 2 for k, v in S.mlp_vals(tsp).items()}
    out = S.mlp_with_vals(tsp, vals)
    for name, sl in out.items():
        assert sl.weight.vals is vals[name]
        assert sl.plan is tsp[name].plan
        assert sl.weight.col_ind is tsp[name].weight.col_ind
        assert sl.weight.row_ptr is tsp[name].weight.row_ptr


def test_gradients_flow_through_sparse_linear():
    """SparseLinear passes gradients to its input and its CSR values (the
    incoming cotangent is a transposed view; the backward makes it
    row-major for the kernels)."""
    _, tsp, x, _ = _both("gelu", "rowsplit")
    layer = tsp["w1"]
    vals = layer.weight.vals.clone().requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out = S.mlp_with_vals({"w1": layer}, {"w1": vals})["w1"](tx)
    gx, gv = torch.autograd.grad(out.square().sum(), [tx, vals])
    dense = layer.weight.to_dense()
    vals_d = vals.detach().clone().requires_grad_()
    tx_d = tx.detach().clone().requires_grad_()
    rows = torch.repeat_interleave(torch.arange(dense.shape[0]),
                                   layer.weight.row_lengths().long())
    nnz = layer.weight.nnz()
    w = torch.zeros_like(dense).index_put(
        (rows, layer.weight.col_ind[:nnz].long()), vals_d[:nnz])
    want = torch.autograd.grad((tx_d @ w.T).square().sum(), [tx_d, vals_d])
    torch.testing.assert_close(gx, want[0], **TOL)
    torch.testing.assert_close(gv, want[1], **TOL)
