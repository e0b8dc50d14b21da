"""Training entry point (the reference's ``repro.launch.train``): real steps on
one device -- the card unless ``--device cpu`` -- with checkpoint/resume,
preemption handling, straggler watermarking and deterministic data.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50
    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 50 --global-batch 8 --seq-len 128 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --smoke --steps 3 --device cpu

Each step is ``runtime.steps.make_train_step``: forward and backward
with per-block remat and the chunked loss, then AdamW (``optim.adamw``),
optionally through int8 error-feedback compression.  MoE experts run
through the batched matmul (the grouped GEMM kernel has no backward).
``--trace-out PATH`` turns tracing on (a ``train.step`` span a step) and
writes the Chrome trace there; ``--metrics-out PATH`` dumps the metrics
registry.  ``--spmm-shards N`` rebuilds every sparse leaf's plan as N
nnz-balanced row shards (``repro_torch.distributed.spmm``).  Under
``torchrun --nproc-per-node N`` each rank runs its own shard of every
sparse layer on the same batches, so every rank holds the same state;
rank 0 alone prints and saves checkpoints.  The dense params' placement
over a mesh (the reference's ``distributed/sharding.py``) comes with the
next slice of the port.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import DataConfig, make_source
from repro_torch.distributed import fault
from repro_torch.kernels import registry
from repro_torch.launch import mesh as launch_mesh
from repro_torch.optim import adamw
from repro_torch.runtime import steps as R

# Step latency (the first observation includes the card's warm-up; the
# histogram's p50 reads as steady state, max as the first step).
_step_latency = obs.registry.histogram(
    "train_step_latency_us", "train.py per-step wall time")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--grad-compression", default="none",
                    choices=list(R.GRAD_COMPRESSIONS))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-path", default="")
    ap.add_argument("--tunedb", default="", metavar="PATH",
                    help="TuneDB JSON (python -m repro_torch.tune) of this "
                    "device: sparse-layer plan (re)builds resolve their "
                    "kernel method from its measurements")
    ap.add_argument("--spmm-method", default="", metavar="METHOD",
                    choices=("",) + registry.method_names(),
                    help="force the SpMM kernel method for sparse-layer "
                    "plan rebuilds (default: auto)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="enable structured tracing and write the Chrome "
                    "trace-event JSON here on exit")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write a JSON snapshot of the metrics registry "
                    "(step-latency histogram, plan counters) on exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                    "plain versions)")
    ap.add_argument("--spmm-shards", type=int, default=0, metavar="N",
                    help="rebuild sparse-layer plans as N nnz-balanced row "
                    "shards (repro_torch.distributed.spmm); when N is the "
                    "local mesh's data size under torchrun each rank runs "
                    "its own shard, otherwise the shards run as a "
                    "per-shard loop")
    args = ap.parse_args(argv)
    if args.spmm_shards < 0:
        ap.error(f"--spmm-shards {args.spmm_shards}: a shard count is "
                 "positive")
    if args.global_batch % args.microbatches:
        ap.error(f"--global-batch {args.global_batch} does not split into "
                 f"--microbatches {args.microbatches}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run the plain versions")
    own_group = not torch.distributed.is_initialized()
    try:
        if args.spmm_shards:    # under torchrun: the group, before prints
            launch_mesh.init_from_env(device.type)
        with launch_mesh.rank0_prints():
            return _run(args, device)
    finally:
        if own_group:       # the group torchrun's environment started here
            launch_mesh.shutdown()


def _run(args, device: torch.device) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.trace_out:
        obs.enable()

    if args.tunedb:
        from repro_torch import engine
        from repro_torch.tune import backend_key
        db = engine.load_tunedb(args.tunedb, backend=backend_key(device))
        print(f"[train] tunedb {args.tunedb}: backend={db.backend} "
              f"entries={len(db)} threshold={db.threshold}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = adamw.AdamWConfig(learning_rate=args.lr,
                                warmup_steps=args.warmup,
                                total_steps=args.steps)
    step_fn = R.make_train_step(
        cfg, opt_cfg, microbatches=args.microbatches,
        loss_chunk=min(512, args.seq_len),
        grad_compression=args.grad_compression)

    state = R.init_train_state(cfg, args.seed,
                               grad_compression=args.grad_compression,
                               device=device)
    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume == "auto":
            restored, step, _ = manager.restore_latest(state)
            if restored is not None:
                state, start_step = restored, step
                print(f"[train] resumed from step {step}")
    # Route any sparse layers through the SpMM engine: plans are (re)built
    # once here, so a step never plans (the identity on a dense tree).
    spmm_policy = None
    if args.spmm_method or args.spmm_shards:
        from repro_torch.core import PlanPolicy, ShardSpec
        shards = None
        if args.spmm_shards:
            from repro_torch.core.config import mesh_axis_size
            mesh = launch_mesh.make_local_mesh(device_type=device.type)
            shard_mesh = (mesh if mesh_axis_size(mesh, "data")
                          == args.spmm_shards else None)
            shards = ShardSpec(n=args.spmm_shards, mesh=shard_mesh)
        spmm_policy = PlanPolicy(method=args.spmm_method or "auto",
                                 shards=shards)
    state["params"] = R.ensure_spmm_plans(state["params"],
                                          policy=spmm_policy)
    if args.spmm_shards:
        print(f"[train] {R.count_sparse_leaves(state['params'])} sparse "
              f"leaves sharded into {args.spmm_shards}")
    if launch_mesh.world_size() > 1:
        # Every rank has restored before rank 0 writes a checkpoint.
        torch.distributed.barrier()

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                          global_batch=args.global_batch, seed=args.seed,
                          input_mode=cfg.input_mode, d_model=cfg.d_model)
    source = make_source(data_cfg, args.data_path or None)

    guard = fault.PreemptionGuard().install()
    watermark = fault.StragglerWatermark()
    for step in range(start_step, args.steps):
        batch = _to_device(source.batch_at(step), device, args.microbatches)
        with fault.StepTimer() as t:
            with obs.span("train.step", cat="train", step=step):
                state, metrics = step_fn(state, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        _step_latency.observe(t.seconds * 1e6)
        if watermark.observe(step, t.seconds):
            print(f"[straggler] step {step} took {t.seconds:.2f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"nll={float(metrics['nll']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {t.seconds:.2f}s")
        want_ckpt = manager and (
            (step + 1) % args.ckpt_every == 0 or step == args.steps - 1
            or guard.should_checkpoint())
        if want_ckpt and launch_mesh.rank() == 0:
            fault.retry(lambda: manager.save(step + 1, state))
        if guard.should_checkpoint():
            print(f"[train] preempted; checkpointed at {step + 1}; "
                  f"exiting for restart")
            _export_obs(args)
            return 0
    if watermark.flagged:
        print(f"[train] stragglers flagged: {watermark.flagged[:5]}")
    _export_obs(args)
    return 0


def _to_device(batch: dict, device, microbatches: int) -> dict:
    """A host batch on ``device``, shaped (microbatches, local, ...) when
    the step accumulates over microbatches."""
    out = {k: v.to(device) for k, v in batch.items()}
    if microbatches > 1:
        out = {k: v.reshape(microbatches, -1, *v.shape[1:])
               for k, v in out.items()}
    return out


def _export_obs(args) -> None:
    if args.trace_out:
        tr = obs.get_tracer()
        print(f"[train] trace: {tr.export(args.trace_out)} "
              f"({len(tr)} events)")
    if args.metrics_out:
        print(f"[train] metrics: {obs.dump_metrics(args.metrics_out)}")


if __name__ == "__main__":
    raise SystemExit(main())
