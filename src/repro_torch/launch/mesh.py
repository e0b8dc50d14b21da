"""Device meshes of the port (the reference's ``repro.launch.mesh``):
``make_mesh`` over ``torch.distributed.device_mesh.init_device_mesh`` and
``make_local_mesh``, the mesh of whatever this process group holds.

Nothing tells a process of a cluster: under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment)
:func:`make_local_mesh` initialises the default process group from the
environment, with the backend of :func:`pick_backend`, and puts rank
``r`` on ``cuda:{r % device_count}``; otherwise it is the one-rank mesh
of this process, with no process group (sharded plans then run their
per-shard loop).  :func:`make_production_mesh` gives the reference's
production meshes (16 x 16, two pods of them) over a ``fake`` process
group, for the shape-only dry run.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import os
import warnings

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


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production meshes, 16 x 16 ``("data", "model")``
    or 2 x 16 x 16 ``("pod", "data", "model")``, over a ``fake`` process
    group of 256 or 512 ranks in this process, as rank 0: its collectives
    move no data, so a step over this mesh runs shape-only
    (``launch.dryrun``).  A fake group of another size is replaced; any
    other group is refused.  The group is global to the process: run this
    in a process of its own."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"make_production_mesh: a {dist.get_backend()} group is up;"
                " the production meshes take a fake group of their own "
                "process")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=dist.HashStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


_GLOO_CUDA_LIB: list = []


def gloo_cuda_all_gather() -> None:
    """Run DTensor's all-gathers through ``dist.all_gather_into_tensor``
    in this process, for gloo groups whose ranks share a card.

    On torch 2.11 with CUDA 12.8 on the H100, the functional all-gather
    (``_c10d_functional.all_gather_into_tensor``, which DTensor calls for
    every ``Shard`` → ``Replicate``) kills the process with SIGSEGV on a
    gloo group over CUDA tensors, while ``dist.all_gather_into_tensor`` on
    the same group and tensors is right; the functional all-reduce and
    reduce-scatter are right too.  This registers, for the CUDA dispatch
    key, a kernel of that op which makes the same all-gather through
    ``dist.all_gather_into_tensor`` and returns the gathered tensor whole
    (its ``wait_tensor`` then has nothing to wait for).  Only for
    processes whose every group is gloo: it raises on any other backend.
    Installed once; a second call does nothing."""
    if _GLOO_CUDA_LIB:
        return
    from torch.distributed import distributed_c10d as c10d

    def all_gather_into_tensor(inp, group_size, group_name):
        group = c10d._resolve_process_group(group_name)
        backend = dist.get_backend(group)
        if backend != "gloo":
            raise RuntimeError(f"gloo_cuda_all_gather: a {backend} group; "
                               "this process's all-gathers are routed for "
                               "gloo alone")
        out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():   # "overriding a registered kernel"
        warnings.simplefilter("ignore")
        lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GLOO_CUDA_LIB.append(lib)


def control_group():
    """A new gloo group of every rank, for messages on CPU tensors beside
    whatever backend the default group has (a lockstep server's control
    channel, ``serving.Lockstep``).  Every rank calls it at the same point;
    it raises without a process group."""
    if not dist.is_initialized():
        raise RuntimeError("control_group: no process group is up (run "
                           "under torchrun, or init_process_group first)")
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))


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
