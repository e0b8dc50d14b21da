"""Step functions: the units the launchers run.

``make_train_step``: forward, backward and AdamW over a whole model, with
gradient accumulation over microbatches, per-block remat, the chunked
loss, and optional int8 error-feedback gradient compression.
``init_train_state`` makes the state it takes.

    step = make_train_step(cfg, adamw.AdamWConfig(), microbatches=2)
    state = init_train_state(cfg, seed=0)           # on the card
    for i in range(steps):
        b = {k: v.cuda() for k, v in source.batch_at(i).items()}
        b = {k: v.reshape(2, -1, *v.shape[1:]) for k, v in b.items()}
        state, metrics = step(state, b)

``make_prefill_step`` / ``make_decode_step``: the serving pair;
``microbatched``: a scoring call in fixed-size slices.

``ensure_spmm_plans`` / ``make_sparse_train_step``: the SpMM-engine hooks.
Plans are attached once, before the first step, so a step never plans;
the sparse step is SGD on the CSR values of a pruned MLP (the pruned
pattern, and so every plan, is frozen).  It runs the whole differentiable
SpMM: the forward through the cached plans, ``dB`` through the merge
kernel on the transpose plans, ``dvals`` through the SDDMM kernel.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import ExecutionConfig, SparseMatrix
from repro_torch.models import model as M
from repro_torch.models import sparse as S
from repro_torch.optim import adamw
from repro_torch.optim import compression as gc
from repro_torch.tree import leaves, tree_map, unflatten

PARAM_MODES = ("fsdp", "zero1", "fsdp2")
GRAD_COMPRESSIONS = ("none", "int8_ef")


def _check_modes(grad_compression: str, param_mode: str) -> None:
    if param_mode not in PARAM_MODES:
        raise ValueError(f"param_mode {param_mode!r}: expected one of "
                         f"{PARAM_MODES}")
    if grad_compression not in GRAD_COMPRESSIONS:
        raise ValueError(f"grad_compression {grad_compression!r}: expected "
                         f"one of {GRAD_COMPRESSIONS}")


def loss_and_grads(params, cfg, batch, *, remat: bool = True,
                   loss_chunk: int = 512):
    """``(loss, aux, grads)`` of ``M.loss_and_aux`` on one batch: the
    gradient of every param, in a tree like ``params`` and in each param's
    dtype; ``loss`` and ``aux`` detached.  A param the loss does not use
    (``ln2`` of a parallel block) gets a zero gradient, as the
    reference's ``jax.grad`` gives it."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, aux = M.loss_and_aux(unflatten(params, flat), cfg, batch,
                               remat=remat, loss_chunk=loss_chunk)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    # Over a mesh each gradient takes its param's placements (its partial
    # sums reduced and scattered, as FSDP does).
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) else g for g, p in zip(grads, flat)]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten(params, grads))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    loss_chunk: int = 512, grad_compression: str = "none",
                    param_mode: str = "fsdp"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params", "opt"[, "residual"]}`` (``init_train_state``);
    the step returns a new state and leaves the one it was given as it
    was.  ``batch`` holds tokens and labels (b, s) on the params' device;
    with ``microbatches > 1`` they arrive shaped (microbatches, local, s),
    the float32 gradients of the microbatches are summed and averaged, the
    loss averaged, and ``nll``/``aux`` are the last microbatch's.
    ``param_mode``: ``"fsdp"`` (float32 params; AdamW on them),
    ``"fsdp2"`` (the same step; over a mesh the params take the pure-FSDP
    placements) or ``"zero1"`` (compute-dtype params, the float32 master
    in the optimizer state).  Over a mesh (``launch.dryrun.
    build_step_and_shardings``) the state's leaves are DTensors placed by
    ``distributed.sharding``; on one card the modes differ only in
    precision.
    ``grad_compression="int8_ef"`` passes the gradients through
    ``compression.roundtrip`` with the residual in the state, a scale for
    each of the reference's stacked tensors (``M.stack_keys``).
    ``metrics``: ``loss``, ``nll``, ``aux``, ``grad_norm``, ``lr`` and
    ``skipped``, 0-d float32 tensors on the device (nothing is read back).
    """
    _check_modes(grad_compression, param_mode)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params, batch):
        if microbatches == 1:
            return loss_and_grads(params, cfg, batch, remat=remat,
                                  loss_chunk=loss_chunk)
        n = {v.shape[0] for v in batch.values()}
        if n != {microbatches}:
            raise ValueError(f"batch leaves lead with {sorted(n)}, expected "
                             f"(microbatches={microbatches}, local, ...)")
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatches):
            mb = {k: v[i] for k, v in batch.items()}
            loss, aux, grads = loss_and_grads(params, cfg, mb, remat=remat,
                                              loss_chunk=loss_chunk)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        inv = 1.0 / microbatches
        return loss_sum * inv, aux, tree_map(lambda g: g * inv, acc)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        loss, aux, grads = grads_of(params, batch)
        if grad_compression == "int8_ef":
            grads, residual = gc.roundtrip(grads, state["residual"],
                                           M.stack_keys(params, cfg))
        update = (adamw.apply_updates_zero1 if param_mode == "zero1"
                  else adamw.apply_updates)
        new_params, new_opt, metrics = update(params, grads, opt, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt}
        if grad_compression == "int8_ef":
            new_state["residual"] = residual
        metrics = dict(metrics, loss=loss, nll=aux["nll"], aux=aux["aux"])
        return new_state, metrics

    return train_step


def init_train_state(cfg, seed: int, *, grad_compression: str = "none",
                     param_mode: str = "fsdp", device="cuda") -> dict:
    """``{"params", "opt"[, "residual"]}``: random params from ``seed``
    (``M.init_params``, drawn on ``device``), zero moments at step 0, and
    with ``int8_ef`` a zero residual."""
    _check_modes(grad_compression, param_mode)
    params = M.init_params(cfg, seed, device)
    if param_mode == "zero1":
        params, opt = adamw.init_state_zero1(params, cfg.cdtype)
    else:
        opt = adamw.init_state(params)
    state = {"params": params, "opt": opt}
    if grad_compression == "int8_ef":
        state["residual"] = gc.init_residual(params)
    return state


def make_prefill_step(cfg, *, cache_len: int | None = None):
    """``prefill_step(params, batch) -> {"caches", "logits", "pos"}``: the
    prompt's forward, filling KV caches of ``cache_len`` positions."""
    def prefill_step(params, batch):
        caches, logits, pos = M.prefill(params, cfg, batch,
                                        cache_len=cache_len)
        return {"caches": caches, "logits": logits, "pos": pos}

    return prefill_step


def make_decode_step(cfg):
    """``decode_step(params, caches, batch, pos) -> (logits, caches)``:
    one token per sequence against the caches."""
    def decode_step(params, caches, batch, pos):
        return M.decode_step(params, cfg, caches, batch, pos)

    return decode_step


def microbatched(fn, microbatch: int, *, argnums=(0,), pad=True):
    """Run ``fn`` over fixed-size slices of the selected args' leading axis.

    ``fn`` is called once per ``microbatch``-sized slice of every arg in
    ``argnums`` (other args pass through whole), and the per-slice outputs
    (a tensor, or dicts, lists and tuples of them) are concatenated along
    axis 0.  Every slice has the same shape, so one shape -- one bucket
    program, one set of kernel launch shapes -- serves any request batch:
    a ragged tail (``total % microbatch != 0``, or ``total`` smaller than
    one microbatch) is padded up to the microbatch by repeating its last
    row, and the padded rows are trimmed from the outputs.  ``pad=False``
    raises on a ragged total instead (for an ``fn`` that mixes rows, such
    as a batch-mean loss, where padding would skew the result).
    """
    if microbatch <= 0:
        raise ValueError(f"microbatch must be positive, got {microbatch}")

    def run(*args):
        sizes = {args[i].shape[0] for i in argnums}
        if len(sizes) != 1:
            raise ValueError(
                f"microbatched args disagree on the leading axis: {sizes}")
        (total,) = sizes
        if total == 0:
            raise ValueError("microbatched got an empty batch")
        rem = total % microbatch
        if rem and not pad:
            raise ValueError(
                f"batch {total} does not divide into microbatches of "
                f"{microbatch}; pad the batch or change --microbatch")
        outs = []
        for s in range(0, total, microbatch):
            n = min(microbatch, total - s)

            def cut(a):
                sl = a[s:s + n]
                if n < microbatch:
                    fill = sl[-1:].expand((microbatch - n,) + sl.shape[1:])
                    sl = torch.cat([sl, fill], dim=0)
                return sl

            sliced = [cut(a) if i in argnums else a
                      for i, a in enumerate(args)]
            outs.append(fn(*sliced))
        out = tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)
        if rem:
            out = tree_map(lambda x: x[:total], out)
        return out

    return run


def ensure_spmm_plans(tree, policy=None, mesh=None):
    """(Re)attach engine-cached SpmmPlans to every sparse leaf of a tree
    of dicts and lists (``SparseLinear`` layers and ``SparseMatrix``
    leaves); anything else passes through.

    ``policy`` (a ``PlanPolicy``) pins the plan request for every leaf;
    with ``policy=None`` each leaf's attached plan has its statics
    replayed (a cache hit when the plan exists).  With ``mesh`` (a
    ``DeviceMesh``) given, or ``policy.shards`` set, every leaf gets a
    device-sharded plan: nnz-balanced row shards, one local plan a shard
    (``repro_torch.distributed.spmm``).  Call it outside the hot loop: the
    steps then never plan.
    """
    if mesh is not None and policy is not None and \
            policy.shards is not None:
        raise ValueError(
            "ensure_spmm_plans: pass the mesh either as mesh= or inside "
            "policy.shards, not both")

    def attach(x):
        if mesh is not None and isinstance(x, (S.SparseLinear,
                                               SparseMatrix)):
            return x.shard(mesh, policy=policy)
        if isinstance(x, S.SparseLinear):
            return x.with_plan(policy)
        if isinstance(x, SparseMatrix):
            if policy is None and x.spmm_plan is not None:
                return x.plan_like(x.spmm_plan.meta)
            return x.plan(policy)
        if isinstance(x, dict):
            return {k: attach(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(attach(v) for v in x)
        return x

    return attach(tree)


def count_sparse_leaves(tree) -> int:
    """The ``SparseLinear`` and ``SparseMatrix`` leaves of a tree of dicts
    and lists."""
    if isinstance(tree, (S.SparseLinear, SparseMatrix)):
        return 1
    if isinstance(tree, dict):
        return sum(count_sparse_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_sparse_leaves(v) for v in tree)
    return 0


def make_sparse_train_step(sparse_p: dict, *, lr: float = 1e-2,
                           exec: ExecutionConfig | None = None):
    """SGD step over the CSR *values* of a SparseLinear MLP.

    Returns ``(step, vals0)``; ``step(vals, x, y) -> (vals, loss)`` takes
    the MSE of ``sparse_mlp_apply`` against ``y``, its gradients with
    respect to the values dict, and one SGD update.  ``exec`` carries the
    per-call backend knobs (``impl`` by the device when unset).  Raises
    before the first step if a layer's plan has no transpose: the kernel
    backward runs ``dB`` on it.
    """
    sparse_p = ensure_spmm_plans(sparse_p)
    missing = sorted(name for name, sl in sparse_p.items()
                     if not sl.plan.meta.has_transpose)
    if missing:
        raise ValueError(
            f"make_sparse_train_step: the plans of {missing} have no "
            "transpose (CSC) plan, which the backward's dB runs on. Plan "
            "the layers with PlanPolicy(with_transpose=True), the default "
            "(serving's prune_ffn_blocks leaves it out).")

    def step(vals: dict, x: torch.Tensor, y: torch.Tensor):
        loss, grads = sparse_mlp_grads(sparse_p, vals, x, y, exec)
        with torch.no_grad():
            new = {k: v - lr * grads[k].to(v.dtype) for k, v in vals.items()}
        return new, loss

    return step, S.mlp_vals(sparse_p)


def sparse_mlp_grads(sparse_p: dict, vals: dict, x: torch.Tensor,
                     y: torch.Tensor, exec: ExecutionConfig | None = None):
    """``(loss, grads)``: the MSE of ``sparse_mlp_apply`` with ``vals``
    bound onto the layers, against ``y``, and its gradient for every
    entry of ``vals`` (the step's forward and backward, without the
    update)."""
    vals = {k: v.detach().requires_grad_(True) for k, v in vals.items()}
    layers = S.mlp_with_vals(sparse_p, vals)
    pred = S.sparse_mlp_apply(layers, x, None, exec=exec)
    loss = ((pred - y) ** 2).mean()
    grads = torch.autograd.grad(loss, list(vals.values()))
    return loss.detach(), dict(zip(vals, grads))
