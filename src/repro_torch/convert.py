"""Carry weights across from the JAX reference, as numpy arrays.

The reference keeps its params as a pytree whose ``segments[si][pi]``
hold each block's params stacked over that segment's layers; this port
keeps one dict per layer in ``params["blocks"]``.  :func:`params_from_numpy`
takes the reference tree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``) and returns the port's params, so
both packages can run the same model.  :func:`csr_from_numpy` carries an
already-pruned reference CSR across as ``(row_ptr, col_ind, vals,
shape)``, and :func:`sparse_mlp_from_numpy` a whole pruned MLP (the
reference's ``prune_mlp`` dict), so both packages fine-tune the same
patterns from the same values.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import PlanPolicy
from repro_torch.core.csr import CSR
from repro_torch.engine import get_plan
from repro_torch.models.sparse import SparseLinear


def _tensor(x, device) -> torch.Tensor:
    x = np.array(x, order="C")              # a writable copy
    if x.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        return torch.as_tensor(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(x, device=device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """The reference's param tree (numpy leaves) → the port's params.

    Keeps ``embed`` (and ``unembed`` when untied), ``final_norm``, and
    unstacks ``segments[si][pi]`` into per-layer dicts in layer order.
    """
    params = {k: _map(tree[k], lambda x: _tensor(x, device))
              for k in ("embed", "unembed", "final_norm") if k in tree}
    blocks = []
    for si, (pattern, count) in enumerate(cfg.segments):
        for ci in range(count):
            for pi in range(len(pattern)):
                blocks.append(_map(tree["segments"][si][pi],
                                   lambda x, ci=ci: _tensor(x[ci], device)))
    params["blocks"] = blocks
    return params


def csr_from_numpy(row_ptr, col_ind, vals, shape, device="cuda") -> CSR:
    """A reference CSR given as numpy arrays → the port's CSR."""
    return CSR(_tensor(np.asarray(row_ptr, np.int32), device),
               _tensor(np.asarray(col_ind, np.int32), device),
               _tensor(vals, device), tuple(int(s) for s in shape))


def sparse_mlp_from_numpy(layers: dict, policy=None,
                          device="cuda") -> dict:
    """A reference ``prune_mlp`` dict, each ``SparseLinear``'s CSR given as
    numpy ``(row_ptr, col_ind, vals, shape)`` → the port's SparseLinear
    layers, each with its engine-cached plan (``policy``, default
    ``PlanPolicy()``: with the transpose the backward needs)."""
    out = {}
    for name, (row_ptr, col_ind, vals, shape) in layers.items():
        csr = csr_from_numpy(row_ptr, col_ind, vals, shape, device=device)
        out[name] = SparseLinear(csr, get_plan(csr, policy or PlanPolicy()))
    return out
