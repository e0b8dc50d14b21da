"""Elastic scaling: re-shard a training state onto another mesh (the
reference's ``repro.distributed.elastic``).

Grow or shrink the data-parallel width (node failures, capacity changes)
without conversion tooling: a checkpoint stores whole tensors, and placing
them on a new mesh is ``distribute_tensor`` with the new mesh's rules.
Here each DTensor is gathered whole first (an all-gather on its old mesh),
then every rank keeps its part under the new placements, so the values
move bit for bit.  The data pipeline is index-based, so a new ``dp`` width
re-partitions batches deterministically.
"""
from __future__ import annotations

from . import sharding as sh


def reshard_params(params, new_mesh):
    """``params`` (DTensors or whole tensors) placed on ``new_mesh`` by
    the FSDP rules."""
    full = sh.gather(params)
    return sh.distribute(full, sh.params_shardings(full, new_mesh))


def reshard_state(state, new_mesh):
    """An optimizer state on ``new_mesh``: the moments ``m``/``v`` and,
    where present, the float32 ``master`` and the compression
    ``residual`` follow the parameter rules; ``step`` is replicated."""
    out = dict(state)
    for key in ("m", "v", "master", "residual"):
        if key in state:
            out[key] = reshard_params(state[key], new_mesh)
    out["step"] = sh.distribute(sh.gather(state["step"]),
                                sh.replicated(new_mesh))
    return out


def validate_elastic_resize(old_mesh, new_mesh,
                            global_batch: int) -> list[str]:
    """Static checks before attempting a live resize."""
    problems = []
    old, new = sh._sizes(old_mesh), sh._sizes(new_mesh)
    if new.get("model", 1) != old.get("model", 1):
        problems.append(
            "model-axis resize changes TP layout; requires full re-shard "
            "(supported, but flagging for operator confirmation)")
    dp = 1
    for a in sh.dp_axes(new_mesh):
        dp *= new[a]
    if global_batch % dp:
        problems.append(
            f"global_batch {global_batch} not divisible by new DP width {dp}")
    return problems
