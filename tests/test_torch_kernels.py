"""The port's SpMM executes (the plain versions the CPU runs) against the
JAX reference's Pallas kernels in interpret mode, on the same numpy
inputs; plus the no-fallback contract of the CUDA wrappers.

Tolerances are the reference's (tests/test_kernels.py): f32 rtol/atol
2e-5, bf16 2e-2 (one bf16 rounding of an f32 sum summed in another
order)."""
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
from repro_torch import convert  # noqa: E402
from repro_torch.core import (Epilogue, ExecutionConfig,  # noqa: E402
                              PlanPolicy, SparseMatrix, build_plan,
                              execute_plan, spmm)
from repro_torch.kernels import (merge_spmm, ops, ref,  # noqa: E402
                                 rowsplit_spmm)

KINDS = {
    "regular_long": (64, 96, 33),
    "irregular": (48, 64, (0, 24)),
    "short_rows": (96, 64, (0, 4)),
    "empty_heavy": (64, 32, (0, 2)),
    "single_row": (1, 128, 64),
    "single_col": (64, 1, 1),
}
EPILOGUES = {
    "none": None,
    "bias_gelu": dict(bias=True, activation="gelu"),
    "relu_scale_residual": dict(activation="relu", scale=0.5,
                                residual=True),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _case(kind, method, dt, n, lead, seed=0):
    """One problem in both packages: plans, values, B, bias, residual."""
    m, k, npr = KINDS[kind]
    ja = jrandom_csr(jax.random.PRNGKey(seed), m, k, nnz_per_row=npr)
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(seed + 1)
    vals = np.array(ja.vals, np.float32)
    b = rng.standard_normal(lead + (k, n)).astype(np.float32)
    bias = rng.standard_normal(m).astype(np.float32)
    res = rng.standard_normal(lead + (m, n)).astype(np.float32)
    jp = jbuild_plan(ja, policy=JPlanPolicy(method=method, tunedb=None))
    ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                np.asarray(ja.col_ind), vals, ja.shape,
                                device="cpu")
    tp = build_plan(ta, PlanPolicy(method=method))
    j = dict(vals=jnp.asarray(vals, jdt), b=jnp.asarray(b, jdt),
             bias=jnp.asarray(bias), res=jnp.asarray(res))
    t = dict(vals=torch.from_numpy(vals).to(tdt),
             b=torch.from_numpy(b).to(tdt), bias=torch.from_numpy(bias),
             res=torch.from_numpy(res))
    return jp, tp, j, t


def _run_both(kind, method, dt, n, lead, ep_name):
    jp, tp, j, t = _case(kind, method, dt, n, lead)
    spec = EPILOGUES[ep_name]
    kw_j, kw_t = {}, {}
    if spec is not None:
        kw_j["epilogue"], kw_t["epilogue"] = JEpilogue(**spec), \
            Epilogue(**spec)
        if spec.get("bias"):
            kw_j["bias"], kw_t["bias"] = j["bias"], t["bias"]
        if spec.get("residual"):
            kw_j["residual"], kw_t["residual"] = j["res"], t["res"]
    jfn = jops.merge_execute if method == "merge" else jops.rowsplit_execute
    tfn = ops.merge_execute if method == "merge" else ops.rowsplit_execute
    m = jp.meta.m
    want = jfn(jp.fwd, j["vals"], j["b"], m=m, impl="pallas",
               interpret=True, **kw_j)
    got = tfn(tp.fwd, t["vals"], t["b"], m=m, impl="torch", **kw_t)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


@pytest.mark.parametrize("n", [1, 32, 160])
@pytest.mark.parametrize("ep_name", sorted(EPILOGUES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", ["merge", "rowsplit"])
def test_plain_execute_matches_pallas_batched(method, dt, ep_name, n):
    _run_both("irregular", method, dt, n, (2,), ep_name)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("method", ["merge", "rowsplit"])
def test_plain_execute_matches_pallas_2d(method, kind):
    _run_both(kind, method, "f32", 32, (), "none")


@pytest.mark.parametrize("method", ["merge", "rowsplit"])
def test_degenerate_patterns_still_apply_epilogue(method):
    """m == 0 and k == 0 skip the kernel but not the epilogue tail."""
    for m, k in ((0, 8), (6, 0)):
        ja = jrandom_csr(jax.random.PRNGKey(0), m, k, nnz_per_row=0)
        jp = jbuild_plan(ja, policy=JPlanPolicy(method=method, tunedb=None))
        ta = convert.csr_from_numpy(np.asarray(ja.row_ptr),
                                    np.asarray(ja.col_ind),
                                    np.asarray(ja.vals), ja.shape,
                                    device="cpu")
        tp = build_plan(ta, PlanPolicy(method=method))
        bias = np.linspace(-1, 1, m).astype(np.float32)
        b = np.ones((k, 5), np.float32)
        ep = dict(bias=True, activation="gelu", scale=2.0)
        want = jops.merge_execute if method == "merge" else \
            jops.rowsplit_execute
        want = want(jp.fwd, ja.vals, jnp.asarray(b), m=m, impl="xla",
                    epilogue=JEpilogue(**ep), bias=jnp.asarray(bias))
        got = execute_plan(tp, ta.vals, torch.from_numpy(b),
                           ExecutionConfig(epilogue=Epilogue(**ep)),
                           bias=torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("method", ["auto", "merge", "rowsplit"])
def test_spmm_api_matches_dense(method):
    rng = np.random.default_rng(5)
    d = rng.standard_normal((40, 56)).astype(np.float32)
    d[rng.random(d.shape) < 0.8] = 0
    b = torch.from_numpy(rng.standard_normal((3, 56, 20)).astype(np.float32))
    a = SparseMatrix.from_dense(d)
    got = spmm(a.data, b, PlanPolicy(method=method))
    want = torch.from_numpy(d) @ b
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(a @ b[0], ref.spmm_dense_ref(a.data, b[0]),
                               rtol=2e-5, atol=2e-5)


def test_default_impl_follows_device_and_cuda_on_cpu_raises():
    a = SparseMatrix.from_dense(np.eye(8, dtype=np.float32)).plan()
    b = torch.ones(8, 3)
    torch.testing.assert_close(a.matmul(b), b)      # CPU → plain version
    with pytest.raises(ValueError, match="impl='cuda'"):
        a.matmul(b, ExecutionConfig(impl="cuda"))
    with pytest.raises(ValueError, match="impl must be"):
        ExecutionConfig(impl="pallas")


@pytest.mark.parametrize("method", ["merge", "rowsplit"])
def test_kernel_wrappers_refuse_cpu_tensors(method):
    """A wrapper launches its kernel or raises — it never falls back."""
    a = SparseMatrix.from_dense(np.eye(8, dtype=np.float32)).plan(
        PlanPolicy(method=method))
    b = torch.ones(1, 8, 3)
    wrapper = merge_spmm.merge_spmm_cuda if method == "merge" else \
        rowsplit_spmm.rowsplit_spmm_cuda
    counts = lambda: (merge_spmm.LAUNCHES, merge_spmm.EPILOGUE_LAUNCHES,
                      rowsplit_spmm.LAUNCHES)
    before = counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(a.spmm_plan.fwd, a.vals, b, 8)
    assert counts() == before


def test_kernel_modules_import_without_nvcc():
    """Importing builds nothing: nvcc runs only at a kernel's first use."""
    import subprocess
    import sys
    code = ("import repro_torch.kernels.ops, repro_torch.kernels._cuda as c;"
            "import sys; assert c._lib is None;"
            "print(c.library_path().name)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("libreprotorch_spmm_")


def _env():
    import os
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


def test_grad_required_on_plain_path_is_differentiable():
    """On the CPU a gradient runs the plain versions through the
    differentiable SpMM's backward (tests/test_torch_grad.py holds it
    against the reference)."""
    a = SparseMatrix.from_dense(np.eye(4, dtype=np.float32) * 2).plan()
    b = torch.ones(4, 2, requires_grad=True)
    a.matmul(b).sum().backward()
    torch.testing.assert_close(b.grad, torch.full((4, 2), 2.0))
