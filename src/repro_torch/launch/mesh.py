"""Device meshes of the port (the reference's ``repro.launch.mesh``):
``make_mesh`` over ``torch.distributed.device_mesh.init_device_mesh`` and
``make_local_mesh``, the mesh of whatever this process group holds.

Nothing tells a process of a cluster: under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment)
:func:`make_local_mesh` initialises the default process group from the
environment, with the backend of :func:`pick_backend`, and puts rank
``r`` on ``cuda:{r % device_count}``; otherwise it is the one-rank mesh
of this process, with no process group (sharded plans then run their
per-shard loop).  The reference's production TPU meshes (16 x 16 chips,
two pods) have no counterpart here.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# How long a rendezvous or a collective may wait before it raises.
TIMEOUT_S = 300


def pick_backend(device_type: str, local_world: int) -> str:
    """``nccl`` when each of the ``local_world`` ranks of this host has a
    card of its own; ``gloo`` on the CPU and when ranks share a card
    (NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def make_mesh(shape, axes, device_type: str) -> DeviceMesh:
    """A mesh of ``shape`` over the default process group's ranks, its
    dims named ``axes`` (``init_device_mesh``)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def init_from_env(device_type: str) -> bool:
    """Initialise the default process group from ``torchrun``'s
    environment, once; returns whether a group is up.  Rank ``r`` goes
    on ``cuda:{r % device_count}`` first."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(pick_backend(device_type, local_world),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def make_local_mesh(model: int = 1, *, device_type: str) -> DeviceMesh:
    """The ``("data", "model")`` mesh of this process group, ``world //
    model`` by ``model``; the one-rank mesh without a process group."""
    if not init_from_env(device_type):
        if model != 1:
            raise ValueError(
                f"make_local_mesh(model={model}) needs {model} ranks; one "
                "process without a process group holds one (run under "
                f"torchrun --nproc-per-node {model})")
        return DeviceMesh(device_type, [[0]],
                          mesh_dim_names=("data", "model"),
                          _init_backend=False, _rank=0)
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"world size {world} does not split into model "
                         f"axis {model}")
    return make_mesh((world // model, model), ("data", "model"),
                     device_type)


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@contextlib.contextmanager
def rank0_prints():
    """Only rank 0 prints: the other ranks' stdout is dropped."""
    if rank() == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
