"""Error-feedback int8 gradient compression (the reference's
``repro.optim.compression``).

Each gradient leaf, plus the residual carried from the last step, is
quantized to int8 with one float32 scale a tensor (max |x| / 127); the
quantization error becomes the next residual, so over steps nothing is
lost (Seide et al., 1-bit SGD lineage).  The reference quantizes the
cross-replica all-reduce payload; on one card :func:`roundtrip` applies the
same arithmetic to the gradients, so both packages train alike.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the payload
and scales are the reference's bit for bit on the same float32 input.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def _q(xf, amax):
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.to(torch.float32) * scale
    return q, scale, err


def compress(grads, residual, groups=None):
    """→ (int8 tree, scale tree of 0-d float32, new residual tree).

    ``groups``: a key a leaf, in ``leaves`` order; leaves of one key share
    one scale, from the largest |x| among them.  The reference keeps a
    segment's layers stacked on a leading axis, one scale a stacked
    tensor; ``models.model.stack_keys`` names those stacks for the port's
    per-layer leaves.  ``None``: a scale a leaf."""
    xs = [g.to(torch.float32) + r
          for g, r in zip(leaves(grads), leaves(residual))]
    amax = [torch.max(torch.abs(x)) for x in xs]
    if groups is not None:
        top = {}
        for k, a in zip(groups, amax):
            top[k] = a if k not in top else torch.maximum(top[k], a)
        amax = [top[k] for k in groups]
    out = [_q(x, a) for x, a in zip(xs, amax)]
    return tuple(unflatten(grads, [t[i] for t in out]) for i in range(3))


def decompress(q_tree, scale_tree):
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree,
                    scale_tree)


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def roundtrip(grads, residual, groups=None):
    """compress → decompress; returns (grads', residual')."""
    q, s, err = compress(grads, residual, groups)
    return decompress(q, s), err
