"""AdamW with global-norm clipping, a warmup + cosine schedule, and a
guard that skips a step whose gradients are not finite (the reference's
``repro.optim.adamw``).

Functional over the port's trees (``repro_torch.tree``): params, grads and
the moments are dicts and lists of tensors, ``state`` is ``{"step": 0-d
int32, "m": tree, "v": tree}``, and every call returns new tensors.  The
arithmetic is the reference's, in its order and all in float32, and stays
on the device: the skip is a ``torch.where`` on a 0-d bool tensor, nothing
is read back to the host, so a step can be captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup to
    ``learning_rate``, then a cosine down to ``min_lr_ratio`` of it at
    ``total_steps``; float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm,
                                           cos)


def init_state(params) -> dict:
    """Zero moments (float32, shaped like each param) at step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def init_state_zero1(params_f32, compute_dtype) -> tuple:
    """Low-precision compute params and an optimizer state that holds the
    float32 master copy besides the moments: ``(params, state)``.  (The
    reference shards the master and moments over the data axis; on one
    card the two modes differ only in the params' precision.)"""
    cast = lambda p: p.to(compute_dtype) if p.is_floating_point() else p
    state = init_state(params_f32)
    state["master"] = params_f32
    return tree_map(cast, params_f32), state


def apply_updates_zero1(params, grads, state, cfg: AdamWConfig,
                        skip_nonfinite: bool = True):
    """AdamW against the float32 master; returns fresh params in the
    compute params' dtype, the new state and the metrics."""
    new_master, new_state, metrics = apply_updates(
        state["master"], grads, {k: state[k] for k in ("step", "m", "v")},
        cfg, skip_nonfinite)
    new_state["master"] = new_master
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), new_master, params)
    return new_params, new_state, metrics


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, float32, 0-d."""
    sq = torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                      for x in leaves(tree)])
    return torch.sqrt(sq.sum())


def apply_updates(params, grads, state, cfg: AdamWConfig,
                  skip_nonfinite: bool = True):
    """Returns (new_params, new_state, metrics).

    ``skip_nonfinite``: a step whose gradients' global norm is not finite
    leaves params, moments and the step count as they were, and reports
    ``skipped`` 1.  ``metrics``: ``grad_norm``, ``lr``, ``skipped``, each a
    0-d float32 tensor on the params' device.
    """
    step = state["step"] + 1
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    scale = torch.where(gnorm > cfg.grad_clip, cfg.grad_clip / gnorm, 1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        pf = p.to(torch.float32)
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        u = u + cfg.weight_decay * pf
        p_new = pf - lr * u
        if skip_nonfinite:
            p_new = torch.where(finite, p_new, pf)
            m_new = torch.where(finite, m_new, m)
            v_new = torch.where(finite, v_new, v)
        return p_new.to(p.dtype), m_new, v_new

    out = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"]))]
    new_params, new_m, new_v = (unflatten(params, [t[i] for t in out])
                                for i in range(3))
    new_state = {"step": torch.where(finite, step, state["step"]),
                 "m": new_m, "v": new_v}
    metrics = {"grad_norm": gnorm, "lr": lr,
               "skipped": (~finite).to(torch.float32)}
    return new_params, new_state, metrics

