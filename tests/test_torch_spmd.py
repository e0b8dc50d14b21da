"""The sharded SpMM's SPMD path — one shard a rank over a gloo CPU process
group — against the per-shard loop, forward and backward.

One spawn of a 2-rank and one of a 3-rank group (a module-scoped fixture
each) run every case inside the ranks (``tests/torch_spmd_worker.py``:
rows and cols, epilogues,
batched B, a ``SparseLinear`` through ``ensure_spmm_plans(mesh=)``, and
the serve CLI's ``--mesh``); the results come back here and are held to
the loop path on the same inputs.  The gradient rule: on every rank the
gradients of vals, B, bias and residual equal the loop path's, with no
world-size factor.  Rendezvous through a ``file://`` store; every wait
has a limit."""
import ast
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_spmd_worker.py")
JOIN_S = 120

sys.path.insert(0, HERE)
import torch_spmd_worker as W  # noqa: E402

from repro_torch.core import SparseMatrix  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-5)      # f32, the reference's bar
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_spmm_grad.py:23


def _spawn(world: int, tmp) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    store = tmp / "store"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(store), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)], tmp


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("spmd2"))


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return _spawn(3, tmp_path_factory.mktemp("spmd3"))


@pytest.fixture(params=[2, 3])
def group(request):
    return request.param, request.getfixturevalue(f"ranks{request.param}")


def _loop(world, dim, ep, lead):
    a = W.pattern()
    plan = SparseMatrix(a).shard(n=world, dim=dim).spmm_plan
    assert plan.meta.spmd_mesh() is None
    return W.run_case(plan, a, ep, lead), plan


CASE_IDS = [c[0] for c in W.CASES]


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_spmd_forward_matches_loop(group, case):
    world, (results, _) = group
    name, dim, ep, lead = case
    want, plan = _loop(world, dim, ep, lead)
    for r, res in enumerate(results):
        got = res[name]
        assert got["spmd"] and got["uniform"], (r, name)
        assert got["bounds"] == plan.meta.bounds
        torch.testing.assert_close(got["c"], want["c"], **FWD_TOL)
        if dim == "rows":      # a shard's own rows, placed: the same bits
            assert torch.equal(got["c"], want["c"]), (r, name)


@pytest.mark.parametrize("case", W.CASES, ids=CASE_IDS)
def test_spmd_gradients_match_loop_no_world_factor(group, case):
    world, (results, _) = group
    name, dim, ep, lead = case
    want, _ = _loop(world, dim, ep, lead)
    keys = ("dvals", "db") + (("dbias", "dres") if ep is not None else ())
    for r, res in enumerate(results):
        got = res[name]
        for key in keys:
            torch.testing.assert_close(got[key], want[key], **GRAD_TOL,
                                       msg=lambda m: f"rank {r} {key}: {m}")


def test_spmd_sparse_linear_through_ensure_spmm_plans(group):
    world, (results, _) = group
    from repro_torch.models import sparse as S
    a = W.pattern()
    layer = S.SparseLinear(a, None).shard(n=world)
    xin = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, W.K_)).astype(np.float32)).requires_grad_(True)
    vals = a.vals.clone().requires_grad_(True)
    y = S.mlp_with_vals({"w1": layer}, {"w1": vals})["w1"](xin)
    (y * y).sum().backward()
    for res in results:
        got = res["linear"]
        assert got["spmd"]
        torch.testing.assert_close(got["y"], y.detach(), **FWD_TOL)
        torch.testing.assert_close(got["dx"], xin.grad, **GRAD_TOL)
        torch.testing.assert_close(got["dvals"], vals.grad, **GRAD_TOL)


def test_serve_cli_mesh_matches_unsharded(group, tmp_path):
    world, (results, out_dir) = group
    assert [res["serve_rc"] for res in results] == [0] * world
    assert {res["backend"] for res in results} == {"gloo"}
    path = tmp_path / "unsharded.pt"
    assert serve.main(["--smoke", "--prune-ffn", "0.25", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8",
                       "--logits-out", str(path)]) == 0
    want = torch.load(path)
    got = torch.load(out_dir / "logits.pt")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_cli_spmm_shards_over_group(group):
    """``train --spmm-shards WORLD`` inside the ranks' group: every rank
    trains and resumes, rank 0 alone prints and writes the checkpoints,
    and the CLI leaves the group it did not start up."""
    world, (results, out_dir) = group
    for steps_, first in ((2, 0), (3, 2)):
        runs = [res[f"train{steps_}"] for res in results]
        assert [r["rc"] for r in runs] == [0] * world
        assert all(r["group_up"] for r in runs)
        assert all(r["stdout"] == "" for r in runs[1:])
        out = runs[0]["stdout"]
        assert f"0 sparse leaves sharded into {world}" in out
        assert [ln.split()[1] for ln in out.splitlines()
                if ln.startswith("step")] == [
                    str(s) for s in range(first, steps_)]
        assert ("resumed from step 2" in out) == (first == 2)
    ckpt = out_dir / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000002",
                                        "step_00000003"]


def test_worker_imports_torch_and_the_port_only():
    with open(WORKER, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro"}, mods
