"""Step functions: the serving steps (prefill, decode), microbatched
scoring, and sparse fine-tuning, SGD on the CSR values of a pruned MLP.

    prefill = make_prefill_step(cfg, cache_len=s + gen + 8)
    decode = make_decode_step(cfg)
    out = prefill(params, {"tokens": prompt})      # caches, logits, pos
    logits, caches = decode(params, out["caches"], {"tokens": tok},
                            out["pos"])

    sparse_p = prune_mlp(mlp_params, 0.25)          # plans with transpose
    step, vals = make_sparse_train_step(sparse_p, lr=1e-2)
    for x, y in batches:
        vals, loss = step(vals, x, y)

The pruned pattern — and so every plan — is frozen; the values are the
degrees of freedom.  A step runs the whole differentiable SpMM: the
forward through the cached plans, ``dB`` through the merge kernel on the
transpose plans, ``dvals`` through the SDDMM kernel.  Plans are attached
once, before the first step (:func:`ensure_spmm_plans`), so a step never
plans.  The reference's ``microbatched`` is a serving helper and comes
with the serving slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import ExecutionConfig, SparseMatrix
from repro_torch.models import model as M
from repro_torch.models import sparse as S


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


def _tree_map(fn, *trees):
    """``fn`` over matching tensor leaves of dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


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
        out = _tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)
        if rem:
            out = _tree_map(lambda x: x[:total], out)
        return out

    return run


def ensure_spmm_plans(tree, policy=None, mesh=None):
    """(Re)attach engine-cached SpmmPlans to every sparse leaf of a tree
    of dicts and lists (``SparseLinear`` layers and ``SparseMatrix``
    leaves); anything else passes through.

    ``policy`` (a ``PlanPolicy``) pins the plan request for every leaf;
    with ``policy=None`` each leaf's attached plan has its statics
    replayed (a cache hit when the plan exists).  Call it outside the hot
    loop: the steps then never plan.  Sharded plans (``mesh``) are not
    ported.
    """
    if mesh is not None:
        raise ValueError("ensure_spmm_plans: device-sharded plans (mesh=) "
                         "are not ported yet")

    def attach(x):
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
                     if sl.plan.bwd is None)
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
