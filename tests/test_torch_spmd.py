"""The sharded SpMM's SPMD path — one shard a rank over a gloo CPU process
group — against the per-shard loop, forward and backward.

One spawn of a 2-rank and one of a 3-rank group (a module-scoped fixture
each) run every case inside the ranks (``tests/torch_spmd_worker.py``:
rows and cols, epilogues,
batched B, a ``SparseLinear`` through ``ensure_spmm_plans(mesh=)``, the
serve CLI's ``--mesh``, and online serving over the mesh, every rank's
server in lockstep); the results come back here and are held to the loop
path on the same inputs, and the served rows to the reference's and the
port's unsharded pruned forwards.  The gradient rule: on every rank the
gradients of vals, B, bias and residual equal the loop path's, with no
world-size factor.  Rendezvous through a ``file://`` store; every wait
has a limit."""
import ast
import dataclasses
import functools
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_spmd_worker.py")
JOIN_S = 120

sys.path.insert(0, HERE)
import torch_spmd_worker as W  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import PlanPolicy as JPlanPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import SparseMatrix  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

FWD_TOL = dict(rtol=2e-5, atol=2e-5)      # f32, the reference's bar
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_spmm_grad.py:23
# Served rows against a pruned forward at f32: the packages (and the
# sharded and unsharded plans) differ only in summation order, the bar of
# test_torch_serve.py's test_pruned_forward_matches_reference_f32.
ROWS_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=1)
def _reference_params():
    """The reference's smoke Llama params (PRNG key 0), as numpy."""
    jcfg = dataclasses.replace(jget_smoke(W.ARCH), compute_dtype="float32")
    return jax.tree.map(np.asarray,
                        jmodel.init_params(jcfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=1)
def _reference():
    """The reference's pruned blocks and jitted pruned forward at f32
    compute, compiled at the mesh server's bucket shapes."""
    jcfg = dataclasses.replace(jget_smoke(W.ARCH), compute_dtype="float32")
    jparams = _reference_params()
    jblocks = jserve.prune_ffn_blocks(
        jparams, jcfg, W.KEEP, policy=JPlanPolicy(method="rowsplit",
                                                  tunedb=None))
    jfwd = jax.jit(jserve.make_pruned_forward(jcfg))
    for b in (1, 2):
        jfwd(jparams, jblocks, np.zeros((b, W.ONLINE["prompt_len"]),
                                        np.int32))
    return jparams, jblocks, jfwd


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
        # The ranks' last stage reads the reference's params: written
        # whole, then renamed, while the ranks run their first cases.
        with open(tmp / "params.part", "wb") as f:
            np.save(f, _reference_params(), allow_pickle=True)
        os.replace(tmp / "params.part", tmp / "params.npy")
        _reference()
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


def _served(results):
    """Rank 0's served requests, and their bucket matrices, each once."""
    served = results[0]["online"]["served"]
    mats = {r["packed"].tobytes(): r["packed"] for r in served}
    return served, mats


def _hold_rows(served, mats, forward):
    want = {key: forward(mat) for key, mat in mats.items()}
    for r in served:
        n = len(r["tokens"])
        assert r["bucket"] == r["packed"].shape
        np.testing.assert_array_equal(r["packed"][r["row"], :n],
                                      r["tokens"])
        got = want[r["packed"].tobytes()][r["row"], :n]
        np.testing.assert_allclose(r["rows"].numpy(), got, **ROWS_TOL)


def test_serve_online_mesh_rows_match_reference(group):
    """Every request served over the mesh, its rows within 1e-4 of the
    reference's pruned forward on the bucket matrix it was packed in."""
    world, (results, _) = group
    online = results[0]["online"]
    assert online["ok"] == online["n"] == W.ONLINE["requests"]
    assert all(res["online"]["spmd"] for res in results)
    jparams, jblocks, jfwd = _reference()
    served, mats = _served(results)
    _hold_rows(served, mats, lambda mat: np.asarray(
        jfwd(jparams, jblocks, mat.astype(np.int32))))


def test_serve_online_mesh_rows_match_unsharded(group):
    """The same rows against the port's unsharded pruned forward."""
    world, (results, _) = group
    cfg = W.serve_cfg()
    params = convert.params_from_numpy(_reference_params(), cfg,
                                       device="cpu")
    blocks = serve.prune_ffn_blocks(params, cfg, W.KEEP)
    base = serve.make_pruned_forward(cfg)
    served, mats = _served(results)

    def forward(mat):
        with torch.inference_mode():
            return base(params, blocks, torch.from_numpy(mat)).numpy()

    _hold_rows(served, mats, forward)


def test_serve_online_mesh_followers_run_the_leaders_buckets(group):
    """Every rank ran the same buckets in the same order, each counted
    where its program call returned: on the leader one call a served
    bucket matrix (a fixed rate: no probe), on each follower one a RUN."""
    world, (results, _) = group
    ran = [res["online"]["ran"] for res in results]
    forwards = [res["online"]["forwards"] for res in results]
    _, mats = _served(results)
    assert forwards == [len(mats)] * world
    assert all(r == ran[0] for r in ran[1:]) and len(ran[0]) == len(mats)
    assert set(ran[0]) <= {(1, 8), (2, 8)}
    assert {r["bucket"] for r in results[0]["online"]["served"]} == \
        set(ran[0])


def test_serve_online_mesh_builds_nothing_after_warmup(group):
    world, (results, _) = group
    for r, res in enumerate(results):
        online = res["online"]
        assert (online["recompiles"], online["replans"]) == (0, 0), r
        assert online["programs"] == 2, r


def test_serve_cli_serve_mesh_over_group(group):
    """``serve --serve --mesh WORLD`` inside the ranks' group: every rank
    exits 0, and rank 0 alone prints the load's outcome."""
    world, (results, _) = group
    runs = [res["online_cli"] for res in results]
    assert [r["rc"] for r in runs] == [0] * world
    assert "12/12 ok (0 shed, 0 error)" in runs[0]["stdout"]
    assert "recompiles after warmup: 0" in runs[0]["stdout"]
    assert "plans built during serving: 0" in runs[0]["stdout"]
    assert f"lockstep over {world} ranks, gloo collectives" in \
        runs[0]["stdout"]
    for r in runs[1:]:       # a follower prints its rank line alone
        assert [ln.split(":")[0] for ln in r["stdout"].splitlines()] == \
            [f"[serve] rank {runs.index(r)} of {world}"]


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
