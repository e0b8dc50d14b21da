"""Dry run over the production meshes: does the distribution compose?

For every (architecture × input shape × mesh) cell, on a ``fake`` process
group of 256 (16 × 16) or 512 (2 × 16 × 16) ranks in this one process
(``launch.mesh.make_production_mesh``)::

    step, specs, in_sh, out_sh, cfg = build_step_and_shardings(...)
    with the step's inputs as meta tensors placed by in_sh:
        run the step under sharding.use_mesh(mesh) and move its outputs
        to out_sh

A cell is ``ok`` when the step's placements compose over shape-only
inputs: every op of the forward, the backward and the optimizer finds a
DTensor sharding rule, and every redistribution of the model's
``constrain`` calls, the inputs and the outputs runs.  The run takes one
layer of each segment's block pattern and one microbatch: every other
layer and microbatch repeats their shapes and placements, as the
reference's scans over layers and microbatches compile one body each.  The fake group's
collectives move no data and the meta tensors hold none, so nothing is
computed and nothing is allocated.  Each cell's record holds the bytes
one rank keeps of params, optimizer state (moments, master, step and the
compression residual), gradients, caches and batch, from the
placements, and whether their sum fits one card's 80 GB; activations are
not counted.  A failure is recorded with its traceback, and the loop
carries on.

The reference lowers and compiles each cell with XLA and prints its
``memory_analysis``, ``cost_analysis`` and HLO statistics; PyTorch has no
whole-program compile here, so those have no counterpart: the byte
counts above come from the placements alone.

The same :func:`build_step_and_shardings` runs a real step over a real
mesh (``chip_smoke.py``'s ``model_parallel`` phase: four gloo ranks on
one card, held against the one-process step).

Usage (the CPU, no card; a process of its own, since the fake group is
global to its process)::

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, ModelConfig, ShapeConfig,
                                 get_config, shape_cells)
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import cache_specs, input_specs, meta
from repro_torch.optim import adamw
from repro_torch.runtime import steps as R
from repro_torch.tree import leaves, tree_map

CARD_BYTES = 80e9           # one H100's HBM
METRICS = ("loss", "nll", "aux", "grad_norm", "lr", "skipped")


def default_microbatches(cfg, global_batch: int = 256,
                         dp: int = 16) -> int:
    """Keep live activations a rank bounded; the per-microbatch batch
    stays divisible by the DP width."""
    want = 16 if cfg.d_model >= 6144 else 4
    return max(1, min(want, global_batch // dp))


def build_step_and_shardings(arch, shape_name, mesh, *,
                             microbatches: int | None = None,
                             grad_compression: str = "none",
                             remat: bool = True,
                             param_mode: str = "fsdp",
                             seq_shard: bool = False):
    """``(step, specs, in_sh, out_sh, cfg)`` of one cell: the step
    function of the shape's kind, its arguments' stand-ins (``specs``, in
    positional order), a tree of ``sharding.Sharding`` for each argument
    (``in_sh``, keyed like ``specs``) and for its result (``out_sh``).
    ``arch`` is a name or a ``ModelConfig``, ``shape_name`` a name or a
    ``ShapeConfig``.  ``sharding.sharded(step, mesh, tuple(in_sh.values()),
    out_sh)`` runs it over ``mesh``."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if seq_shard:  # sequence parallelism for the residual stream
        cfg = dataclasses.replace(cfg, residual_spec=("dp", "model", None))
    if param_mode == "fsdp2":  # pure ZeRO-3: no TP, batch over every rank
        cfg = dataclasses.replace(cfg, tp=False,
                                  residual_spec=("dpm", None, None))
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    dp = sh._axis_size(mesh, sh.dp_axes(mesh))
    if param_mode == "fsdp2":
        dp *= sh._axis_size(mesh, "model")
    mb = microbatches or (
        default_microbatches(cfg, shape.global_batch, dp)
        if shape.kind == "train" else 1)
    specs = input_specs(cfg, shape, grad_compression, mb, param_mode)
    rep = sh.replicated(mesh)

    def pshard(tree, mode=None):
        m = mode or ("fsdp2" if param_mode == "fsdp2" else "fsdp")
        return sh.params_shardings(tree, mesh, m)

    batch_model = param_mode == "fsdp2"
    b = shape.global_batch
    if shape.kind == "train":
        step = R.make_train_step(
            cfg, adamw.AdamWConfig(), microbatches=mb, remat=remat,
            grad_compression=grad_compression, param_mode=param_mode)
        state, opt = specs["state"], specs["state"]["opt"]
        state_sh = {"params": pshard(state["params"],
                                     mode="zero1" if param_mode == "zero1"
                                     else None),
                    "opt": {"step": rep, "m": pshard(opt["m"]),
                            "v": pshard(opt["v"])}}
        if "master" in opt:
            state_sh["opt"]["master"] = pshard(opt["master"])
        if "residual" in state:
            state_sh["residual"] = pshard(state["residual"])
        in_sh = {"state": state_sh,
                 "batch": sh.batch_shardings(specs["batch"], mesh,
                                             batch_axis=1 if mb > 1 else 0,
                                             include_model=batch_model)}
        out_sh = (state_sh, {k: rep for k in METRICS})
        return step, specs, in_sh, out_sh, cfg

    logits = meta((b, 1, cfg.vocab_size), torch.float32)
    if shape.kind == "prefill":
        step = R.make_prefill_step(cfg)
        in_sh = {"params": pshard(specs["params"]),
                 "batch": sh.batch_shardings(specs["batch"], mesh)}
        out_sh = {"caches": sh.cache_shardings(
                      cache_specs(cfg, b, shape.seq_len), mesh),
                  "logits": sh.batch_shardings(logits, mesh),
                  "pos": sh.batch_shardings(meta((b,), torch.int64), mesh)}
        return step, specs, in_sh, out_sh, cfg

    step = R.make_decode_step(cfg)
    in_sh = {"params": pshard(specs["params"]),
             "caches": sh.cache_shardings(specs["caches"], mesh),
             "batch": sh.batch_shardings(specs["batch"], mesh),
             "pos": sh.batch_shardings(specs["pos"], mesh)}
    out_sh = (sh.batch_shardings(logits, mesh), in_sh["caches"])
    return step, specs, in_sh, out_sh, cfg


def _one_of_each(cfg):
    """``cfg`` with each segment's pattern once."""
    segments = tuple((pattern, 1) for pattern, _ in cfg.segments)
    return dataclasses.replace(
        cfg, segments=segments,
        num_layers=sum(len(pattern) for pattern, _ in segments))


def cell_bytes(specs, in_sh, out_sh, caches, mb: int) -> dict:
    """Bytes one rank holds of each part of a cell, from the placements:
    the inputs', and a prefill's ``caches`` (its output)."""
    nbytes = {"params": 0, "opt": 0, "grads": 0, "caches": 0, "batch": 0}
    if "state" in specs:
        st, st_sh = specs["state"], in_sh["state"]
        nbytes["params"] = sh.local_bytes(st["params"], st_sh["params"])
        nbytes["opt"] = sh.local_bytes(st["opt"], st_sh["opt"])
        if "residual" in st:
            nbytes["opt"] += sh.local_bytes(st["residual"],
                                            st_sh["residual"])
        # Gradients in each param's dtype; summed over microbatches in f32.
        grads = tree_map(lambda p: meta(p.shape, torch.float32 if mb > 1
                                        else p.dtype), st["params"])
        nbytes["grads"] = sh.local_bytes(grads, st_sh["params"])
    else:
        nbytes["params"] = sh.local_bytes(specs["params"], in_sh["params"])
    if "caches" in specs:
        nbytes["caches"] = sh.local_bytes(specs["caches"], in_sh["caches"])
    elif caches is not None:
        nbytes["caches"] = sh.local_bytes(caches, out_sh["caches"])
    nbytes["batch"] = sh.local_bytes(specs["batch"], in_sh["batch"])
    return nbytes


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatches: int | None = None,
             grad_compression: str = "none", remat: bool = True,
             param_mode: str = "fsdp", seq_shard: bool = False,
             verbose: bool = True) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False,
           "param_mode": param_mode, "seq_shard": seq_shard}
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        step, specs, in_sh, out_sh, cfg = build_step_and_shardings(
            arch, shape_name, mesh, microbatches=microbatches,
            grad_compression=grad_compression, remat=remat,
            param_mode=param_mode, seq_shard=seq_shard)
        lab = specs["batch"].get("labels")
        mb = lab.shape[0] if lab is not None and lab.dim() == 3 else 1
        # The run: one layer of each segment's pattern and one microbatch
        # (every other layer and microbatch repeats their shapes and
        # placements, as the reference's scans compile one body each).
        shape = SHAPES[shape_name]
        step, specs_run, in_run, out_run, _ = build_step_and_shardings(
            _one_of_each(cfg), dataclasses.replace(
                shape, global_batch=shape.global_batch // mb),
            mesh, microbatches=1, grad_compression=grad_compression,
            remat=remat, param_mode=param_mode, seq_shard=seq_shard)
        t1 = time.time()
        run = sh.sharded(step, mesh, tuple(in_run.values()), out_run)
        run(*specs_run.values())
        t2 = time.time()
        caches = (cache_specs(cfg, shape.global_batch, shape.seq_len)
                  if shape.kind == "prefill" else None)
        per_rank = cell_bytes(specs, in_sh, out_sh, caches, mb)
        total = sum(per_rank.values())
        params = specs["state"]["params"] if "state" in specs \
            else specs["params"]
        rec.update(ok=True, build_s=round(t1 - t0, 2),
                   run_s=round(t2 - t1, 2), microbatches=mb,
                   run_layers=_one_of_each(cfg).num_layers,
                   per_rank_bytes=per_rank, per_rank_total=total,
                   fits_card=total <= CARD_BYTES,
                   model_params=sum(x.numel() for x in leaves(params)))
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] ok in "
                  f"{rec['run_s']}s; per rank "
                  + ", ".join(f"{k} {v / 1e9:.3f} GB"
                              for k, v in per_rank.items())
                  + f"; total {total / 1e9:.3f} GB "
                  f"({'fits' if rec['fits_card'] else 'exceeds'} 80 GB)")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAILED: "
                  f"{rec['error'][:300]}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--param-mode", default="fsdp",
                    choices=["fsdp", "zero1", "fsdp2"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shp) for arch in ARCHS for shp in shape_cells(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    n_ok = 0
    for arch, shp in cells:
        for mp in meshes:
            rec = run_cell(arch, shp, multi_pod=mp,
                           microbatches=args.microbatches,
                           grad_compression=args.grad_compression,
                           remat=not args.no_remat,
                           param_mode=args.param_mode)
            n_ok += rec["ok"]
            name = f"{arch}__{shp}__{rec['mesh']}.json"
            with open(os.path.join(args.out, name), "w",
                      encoding="utf-8") as f:
                json.dump(rec, f, indent=1)
    total = len(cells) * len(meshes)
    print(f"\ndry-run: {n_ok}/{total} cells composed")
    return 0 if n_ok == total else 1


if __name__ == "__main__":
    raise SystemExit(main())
