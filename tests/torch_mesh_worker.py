"""One rank of the model-parallel checks on a gloo CPU process group, for
``tests/test_torch_sharding.py`` (imports torch and repro_torch only).

    python tests/torch_mesh_worker.py RANK WORLD STORE OUT_DIR

On a 2 x 2 ("data", "model") mesh of the four ranks, the smoke Llama at
f32 compute through ``dryrun.build_step_and_shardings`` and
``sharding.sharded``: the first batch's gradients and two train steps
for ``fsdp`` and ``zero1``, each gathered whole; then the fsdp state resharded 2 x 2 -> 4 x 1 -> 2 x 2 with
``elastic``.  What it gathered goes to ``OUT_DIR/rank{RANK}.pt``; the
parent holds it against the one-process step on the same inputs.
"""
from __future__ import annotations

import dataclasses
import datetime
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_smoke_config
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as launch_mesh
from repro_torch.runtime import steps as R
from repro_torch.tree import leaves

# (name, param_mode, microbatches)
MODES = (("fsdp", "fsdp", 1), ("zero1", "zero1", 1))
BATCH, SEQ, STEPS = 4, 32, 2


def config():
    return dataclasses.replace(get_smoke_config("llama3.2-1b"),
                               compute_dtype="float32")


def batches(cfg, microbatches: int) -> list:
    """STEPS seeded batches of BATCH x SEQ tokens, shaped (microbatches,
    local, SEQ) when microbatches > 1."""
    g = torch.Generator().manual_seed(11)
    out = []
    for _ in range(STEPS):
        tok = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g)
        b = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if microbatches > 1:
            b = {k: v.reshape(microbatches, -1, SEQ) for k, v in b.items()}
        out.append(b)
    return out


def run_mode(mesh, param_mode: str, microbatches: int) -> dict:
    cfg = config()
    shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
    step, _, in_sh, out_sh, cfg = dryrun.build_step_and_shardings(
        cfg, shape, mesh, microbatches=microbatches, param_mode=param_mode)
    state = R.init_train_state(cfg, 0, param_mode=param_mode, device="cpu")
    bs = batches(cfg, microbatches)
    dstate = sh.redistribute(state, in_sh["state"])
    first = bs[0] if microbatches == 1 else {k: v[0] for k, v in
                                             bs[0].items()}
    with sh.use_mesh(mesh):
        loss, _, grads = R.loss_and_grads(
            dstate["params"], cfg,
            sh.redistribute(first, sh.batch_shardings(first, mesh)))
    out = {"grad_loss": loss.full_tensor(), "grads": sh.gather(grads),
           "grad_placements": [str(g.placements) for g in leaves(grads)],
           "param_placements": [str(p.placements)
                                for p in leaves(dstate["params"])]}
    run = sh.sharded(step, mesh, tuple(in_sh.values()), out_sh)
    losses = []
    for b in bs:
        dstate, metrics = run(dstate, b)
        losses.append(metrics["loss"].to_local())
    out.update(losses=torch.stack(losses), state=sh.gather(dstate),
               dstate=dstate)
    return out


def main(rank: int, world: int, store: str, out_dir: str) -> int:
    torch.set_num_threads(1)          # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"), "cpu")
    results = {}
    for name, mode, mb in MODES:
        results[name] = run_mode(mesh, mode, mb)
    # Elastic: the fsdp state 2 x 2 -> 4 x 1 -> 2 x 2.
    mesh41 = launch_mesh.make_mesh((4, 1), ("data", "model"), "cpu")
    st = results["fsdp"].pop("dstate")
    for r in results.values():
        r.pop("dstate", None)

    def moved(s, to):
        return {"params": elastic.reshard_params(s["params"], to),
                "opt": elastic.reshard_state(s["opt"], to)}

    s41 = moved(st, mesh41)
    s22 = moved(s41, mesh)
    results["reshard"] = {
        "before": sh.gather(st), "4x1": sh.gather(s41),
        "after": sh.gather(s22),
        "placements_4x1": [str(x.placements) for x in leaves(s41)],
        "placements_back": all(a.placements == b.placements
                               for a, b in zip(leaves(st), leaves(s22))),
        "validate": elastic.validate_elastic_resize(mesh, mesh41, BATCH)}
    torch.save(results, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    r, w, store_path, out = sys.argv[1:5]
    sys.exit(main(int(r), int(w), store_path, out))
