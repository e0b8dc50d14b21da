"""One rank of the sharded SpMM's SPMD path on a gloo CPU process group,
for ``tests/test_torch_spmd.py`` (imports torch and repro_torch only).

    python tests/torch_spmd_worker.py RANK WORLD STORE OUT_DIR

Every case builds the same seeded inputs as the parent test, runs the
SPMD path (one shard a rank) forward and backward, and saves what it got
to ``OUT_DIR/rank{RANK}.pt``; the parent holds it against the per-shard
loop.  Then ``train.main(... --spmm-shards WORLD)`` twice (a run, then
its resume) and ``serve.main(... --mesh WORLD)`` on the smoke model; the
CLIs leave the group they did not start up.  Last, online serving over
the mesh: ``serve.serve_online`` on the smoke Llama at f32 with the
params the parent saved (``OUT_DIR/params.npy``, the reference's, as
numpy; the worker waits for the file), every rank in lockstep, rank 0 keeping each served request; and
``serve.main(... --serve --mesh WORLD)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import CSR, Epilogue, ExecutionConfig
from repro_torch.core import PlanPolicy, ShardSpec, SparseMatrix
from repro_torch.distributed import spmm as dspmm
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve, train
from repro_torch.models import sparse as S
from repro_torch.runtime import steps

# (name, dim, epilogue, batch dims of B)
CASES = (
    ("rows", "rows", None, ()),
    ("rows_epilogue_batched", "rows",
     Epilogue(bias=True, activation="gelu", residual=True), (2,)),
    ("cols", "cols", None, ()),
    ("cols_epilogue_batched", "cols",
     Epilogue(bias=True, activation="relu", scale=0.5, residual=True),
     (2,)),
)
M_, K_, N_ = 41, 24, 5
# Online serving over the mesh: the smoke Llama at f32 compute, a fixed
# offered rate, 12 requests of lengths 2-8 into batches of up to 2.
ARCH, KEEP = "llama3.2-1b", 0.25
ONLINE = dict(batch=2, prompt_len=8, requests=12, rate=400.0, seed=0)
PARAMS_WAIT_S = 120      # the parent writes the params while ranks start


def serve_cfg():
    return dataclasses.replace(get_smoke_config(ARCH),
                               compute_dtype="float32")


def pattern(seed: int = 0) -> CSR:
    """A 41 x 24 irregular CSR (rows of 0 to 12 nonzeroes; some empty)
    with 6 padded slots, from a numpy seed."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 13, size=M_)
    row_ptr = np.zeros(M_ + 1, np.int32)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_ind = np.zeros(nnz + 6, np.int32)
    for r in range(M_):
        col_ind[row_ptr[r]:row_ptr[r + 1]] = np.sort(
            rng.choice(K_, size=lengths[r], replace=False))
    vals = np.zeros(nnz + 6, np.float32)
    vals[:nnz] = rng.standard_normal(nnz)
    return CSR(torch.from_numpy(row_ptr), torch.from_numpy(col_ind),
               torch.from_numpy(vals), (M_, K_))


def inputs(lead, seed: int = 1):
    """B, bias, residual and the loss weights of a case (numpy seed)."""
    rng = np.random.default_rng(seed + len(lead))
    f = np.float32
    return dict(b=rng.standard_normal(lead + (K_, N_)).astype(f),
                bias=rng.standard_normal(M_).astype(f),
                res=rng.standard_normal(lead + (M_, N_)).astype(f),
                w=rng.standard_normal(lead + (M_, N_)).astype(f))


def run_case(plan, a: CSR, ep, lead):
    """Forward and backward of ``sum(C * w)``; returns the output and the
    gradients of vals, b, bias and residual."""
    x = {k: torch.from_numpy(v) for k, v in inputs(lead).items()}
    vals = a.vals.clone().requires_grad_(True)
    b = x["b"].requires_grad_(True)
    kw = {}
    if ep is not None:
        kw = dict(bias=x["bias"].requires_grad_(True),
                  residual=x["res"].requires_grad_(True))
    c = dspmm.execute_sharded(plan, vals, b, ExecutionConfig(epilogue=ep),
                              **kw)
    (c * x["w"]).sum().backward()
    out = dict(c=c.detach(), dvals=vals.grad, db=b.grad)
    if ep is not None:
        out.update(dbias=kw["bias"].grad, dres=kw["residual"].grad)
    return out


def serve_online_mesh(mesh, out_dir: str) -> dict:
    """``serve_online`` with the pruned FFNs sharded by rows over ``mesh``
    (one shard a rank): what this rank ran, and on rank 0 every served
    request's tokens, bucket, row, packed matrix and output rows."""
    cfg = serve_cfg()
    path = os.path.join(out_dir, "params.npy")
    t_end = time.monotonic() + PARAMS_WAIT_S
    while not os.path.exists(path):      # written whole, then renamed
        if time.monotonic() > t_end:
            raise TimeoutError(f"no {path} after {PARAMS_WAIT_S} s")
        time.sleep(0.05)
    tree = np.load(path, allow_pickle=True).item()
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    policy = PlanPolicy(shards=ShardSpec(mesh=mesh, axis="data"))
    rep = serve.serve_online(cfg, params, KEEP, policy=policy,
                             keep_served=True, **ONLINE)
    blocks = rep.server.state[1]
    out = dict(ran=rep.ran, forwards=rep.forwards, programs=rep.programs,
               replans=rep.replans,
               recompiles=rep.recompiles,
               spmd=all(sl.plan.meta.spmd_mesh() is not None
                        for blk in blocks for sl in blk["mlp"].values()))
    if rep.load is not None:
        out.update(n=rep.load.n, ok=rep.load.ok, served=[
            dict(tokens=tokens, bucket=fut.bucket, row=fut.row,
                 packed=fut.packed, rows=fut.result())
            for tokens, fut in rep.load.served])
    return out


def main(rank: int, world: int, store: str, out_dir: str) -> int:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    results = {"backend": str(dist.get_backend())}
    a = pattern()
    rows_mesh = launch_mesh.make_local_mesh(device_type="cpu")  # (w, 1)
    cols_mesh = launch_mesh.make_local_mesh(world, device_type="cpu")  # (1, w)
    for name, dim, ep, lead in CASES:
        mesh = rows_mesh if dim == "rows" else cols_mesh
        plan = SparseMatrix(a).shard(mesh, dim=dim).spmm_plan
        results[name] = dict(run_case(plan, a, ep, lead),
                             spmd=plan.meta.spmd_mesh() is not None,
                             uniform=plan.meta.uniform,
                             bounds=plan.meta.bounds)
    # A SparseLinear sharded through ensure_spmm_plans(mesh=): y = x Wᵀ.
    layer = steps.ensure_spmm_plans(
        {"w1": S.SparseLinear(a, None)}, mesh=rows_mesh)["w1"]
    xin = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, K_)).astype(np.float32)).requires_grad_(True)
    vals = a.vals.clone().requires_grad_(True)
    y = S.mlp_with_vals({"w1": layer}, {"w1": vals})["w1"](xin)
    (y * y).sum().backward()
    results["linear"] = dict(y=y.detach(), dx=xin.grad, dvals=vals.grad,
                             spmd=layer.plan.meta.spmd_mesh() is not None)
    # The train CLI over the group, then its resume: rank 0 alone prints
    # and saves.
    ckpt = os.path.join(out_dir, "ckpt")
    for steps_ in (2, 3):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train.main(
                ["--smoke", "--device", "cpu", "--steps", str(steps_),
                 "--global-batch", "2", "--seq-len", "16", "--log-every",
                 "1", "--spmm-shards", str(world), "--ckpt-dir", ckpt])
        results[f"train{steps_}"] = dict(rc=rc, stdout=out.getvalue(),
                                         group_up=dist.is_initialized())
    # The serve CLI over the group: rank 0 saves the logits.
    logits = os.path.join(out_dir, "logits.pt")
    results["serve_rc"] = serve.main(
        ["--smoke", "--prune-ffn", "0.25", "--device", "cpu", "--batch",
         "2", "--prompt-len", "8", "--mesh", str(world), "--logits-out",
         logits])
    results["online"] = serve_online_mesh(rows_mesh, out_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(
            ["--smoke", "--prune-ffn", "0.25", "--device", "cpu", "--serve",
             "--batch", "2", "--prompt-len", "8", "--serve-requests", "12",
             "--mesh", str(world)])
    results["online_cli"] = dict(rc=rc, stdout=out.getvalue())
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    launch_mesh.shutdown()
    return 0


if __name__ == "__main__":
    r, w, s, o = sys.argv[1:5]
    sys.exit(main(int(r), int(w), s, o))
