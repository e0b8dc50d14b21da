"""Sharding rules: parameter FSDP × TP, batch DP, cache layouts, and
activation constraints (the reference's ``repro.distributed.sharding``).

Scheme (MaxText-style 2-D, with an optional pod axis), rule for rule the
reference's:

* mesh axes ``("data", "model")`` on one pod, ``("pod", "data", "model")``
  across pods; ``dp`` below is ``("pod", "data")`` when the pod axis
  exists, else ``("data",)``;
* params: the contracting-free large dim over ``data`` (FSDP), the other
  over ``model`` (TP);
* every rule is divisibility-checked: an axis that does not divide its dim
  is dropped, minor axis first (Granite's vocab 49155 over 16 stays
  whole);
* batch ``(dp, None, ...)``; KV caches: batch over ``dp`` when it divides,
  sequence over ``model``, and over ``dp × model`` when the batch does not
  shard (the 500k single-sequence cell).

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of axis names (major first), or ``None`` — the counterpart of JAX's
``PartitionSpec``.  The port keeps params and caches per layer where the
reference stacks a segment's layers on a leading axis, so these rules take
a per-layer leaf and give the reference's spec of the stacked leaf without
its leading ``None``.  :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh`` (a dim over two axes is ``Shard(d)`` on
both mesh dims, the major axis first, which must be the mesh's order);
:class:`Sharding` is the pair (mesh, spec), the counterpart of
``NamedSharding``.

``use_mesh(mesh)`` activates the constraints: model code calls
``constrain(x, *axes)``, which is the identity without an active mesh and
under one redistributes a DTensor to the resolved placements (``"dp"``,
``"dpm"`` = dp + model flattened, ``"model"``, ``None``).  Under an active
mesh, plain tensors that meet DTensors in an op (positions, masks, RoPE
tables, zero accumulators: the same on every rank) count as replicated
(DTensor's ``implicit_replication``).  The active mesh is process-wide,
not thread-local as in the reference: autograd replays checkpointed
forwards on its own device threads, and those must see the same layouts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.tree import leaves, unflatten

PARAM_MODES = ("fsdp", "zero1", "fsdp2")

# ------------------------------------------------------------ mesh axes ----


def axis_names(mesh) -> tuple:
    """A ``DeviceMesh``'s dim names, or a stub's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _sizes(mesh) -> dict:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _fit(mesh, dim: int, axes):
    """``axes`` if they divide ``dim``, else with the minor axes dropped
    until they do (``None`` when none is left)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    while axes and dim % _axis_size(mesh, axes) != 0:
        axes = axes[:-1]
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _p(mesh, dims, *axes) -> tuple:
    """A spec of ``len(dims)`` entries, each axis divisibility-checked
    (dims past ``axes`` are ``None``)."""
    axes = axes + (None,) * (len(dims) - len(axes))
    return tuple(_fit(mesh, d, a) for d, a in zip(dims, axes))


# ----------------------------------------------------------- parameters ----

_PARAM_RULES = {
    # name -> axes of the *last* ndims (leading dims -> None)
    "embed": ("data", "model"),
    "unembed": ("data", "model"),
    "router": ("data", None),
    "wq": ("data", "model"), "wk": ("data", "model"),
    "wv": ("data", "model"), "wo": ("model", "data"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "w1": ("data", "model"), "w3": ("data", "model"),
    "w2": ("model", "data"),
    "in_proj": ("data", "model"), "out_proj": ("model", "data"),
    "conv": (None, "model"),
    "wx_in": ("data", "model"), "wg_in": ("data", "model"),
    "out": ("model", "data"),
    "gate_a": ("model",), "gate_x": ("model",), "lam": ("model",),
    "scale": (None,), "bias": (None,),
    "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
}

_MOE_3D = {"w1": (None, "data", "model"), "w3": (None, "data", "model"),
           "w2": (None, "model", "data")}


def _parts(path) -> list[str]:
    return path.split("/") if isinstance(path, str) else [str(k)
                                                         for k in path]


def _leaf_name(parts) -> str | None:
    """The last dict key of a path (list indices are digits)."""
    for k in reversed(parts):
        if not k.isdigit():
            return k
    return None


def _check_mode(mode: str) -> None:
    if mode not in PARAM_MODES:
        raise ValueError(f"param mode {mode!r}: expected one of "
                         f"{PARAM_MODES}")


def param_pspec(path, leaf, mesh, mode: str = "fsdp") -> tuple:
    """The spec of one param (``path`` as ``tree.paths`` gives it, e.g.
    ``"blocks/3/attn/wq"``, or a sequence of keys).  ``mode``: ``"fsdp"``
    (data-FSDP × model-TP), ``"zero1"`` (model-TP only: the compute
    replica; the master is FSDP inside the optimizer), ``"fsdp2"`` (ZeRO-3
    over the flattened data × model axes, no TP)."""
    _check_mode(mode)
    parts = _parts(path)
    name = _leaf_name(parts)
    dims = tuple(leaf.shape)
    if name not in _PARAM_RULES:
        return (None,) * len(dims)
    rules = _PARAM_RULES[name]
    # MoE expert weights (E, d_in, d_out), told apart from a dense MLP by
    # the "moe" key on their path.  (Expert-parallel sharding, E over
    # data, was refuted in the reference: its token buffer resharded at
    # 9x the wire bytes.)
    if name in _MOE_3D and len(dims) >= 3 and "moe" in parts:
        rules = _MOE_3D[name]
    if mode == "zero1":
        rules = tuple(None if r == "data" else r for r in rules)
    elif mode == "fsdp2":
        dpm = dp_axes(mesh) + ("model",)
        rules = tuple(dpm if r == "data" else None for r in rules)
    lead = len(dims) - len(rules)
    if lead < 0:                       # an unexpected rank: replicate
        return (None,) * len(dims)
    return _p(mesh, dims, *((None,) * lead + tuple(rules)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the counterpart of ``NamedSharding``)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``i`` is
    ``Shard(d)`` when tensor dim ``d`` names its axis, else
    ``Replicate()``.  A dim over several axes lists them major first, in
    the mesh's order (DTensor shards a dim over its mesh dims in mesh
    order)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, a in enumerate(spec):
        if a is None:
            continue
        idx = [names.index(x) for x in ((a,) if isinstance(a, str) else a)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d}'s axes {a} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 "shards two dims")
            out[i] = Shard(d)
    return tuple(out)


def _map_with_path(fn, tree, prefix=""):
    """A tree like ``tree`` of ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix.rstrip("/"), tree)


def params_shardings(params, mesh, mode: str = "fsdp"):
    """A tree like ``params`` of each leaf's :class:`Sharding`."""
    return _map_with_path(
        lambda path, leaf: Sharding(mesh, param_pspec(path, leaf, mesh,
                                                      mode)), params)


# ------------------------------------------------------------ batches ------


def batch_pspec(shape, mesh, batch_axis: int = 0,
                include_model: bool = False) -> tuple:
    dp = dp_axes(mesh)
    if include_model:
        dp = dp + ("model",)
    axes = [None] * len(shape)
    axes[batch_axis] = dp
    return _p(mesh, tuple(shape), *axes)


def batch_shardings(batch, mesh, batch_axis: int = 0,
                    include_model: bool = False):
    return _map_with_path(
        lambda _, leaf: Sharding(mesh, batch_pspec(
            leaf.shape, mesh, batch_axis, include_model)), batch)


# ------------------------------------------------------------- caches ------


def cache_pspec(path, leaf, mesh) -> tuple:
    """One layer's cache.  KV (b, S, kv, dh): batch over dp, sequence over
    model; when the batch does not shard (b = 1 at 500k), the sequence
    takes dp too.  Recurrent states (b, ...): batch over dp, the widest
    trailing dim over model.  Anything else: batch over dp."""
    dims = tuple(leaf.shape)
    name = _leaf_name(_parts(path))
    dp = dp_axes(mesh)
    if name in ("k", "v") and len(dims) == 4:      # (b, S, kv, dh)
        if dims[0] % _axis_size(mesh, dp) == 0:
            return _p(mesh, dims, dp, "model", None, None)
        return _p(mesh, dims, None, dp + ("model",), None, None)
    if name == "ssm" and len(dims) == 4:           # (b, H, P, N)
        return _p(mesh, dims, dp, "model", None, None)
    if name == "conv" and len(dims) == 3:          # (b, w-1, c)
        return _p(mesh, dims, dp, None, "model")
    if name == "h" and len(dims) == 2:             # (b, w)
        return _p(mesh, dims, dp, "model")
    axes = [None] * len(dims)
    if dims:
        axes[0] = dp
    return _p(mesh, dims, *axes)


def cache_shardings(caches, mesh):
    return _map_with_path(
        lambda path, leaf: Sharding(mesh, cache_pspec(path, leaf, mesh)),
        caches)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


# ------------------------------------------------ placing and gathering ----


def distribute(tree, shardings):
    """Each leaf as a DTensor placed by its :class:`Sharding` (a tree of
    shardings like ``tree``, or one for every leaf).  Every rank holds the
    whole tensor (made from the same seed, or meta): each keeps its own
    part, with no communication."""
    shs = (leaves(shardings) if not isinstance(shardings, Sharding)
           else [shardings] * len(leaves(tree)))
    return unflatten(tree, [
        x if isinstance(x, DTensor) else distribute_tensor(
            x, s.mesh, s.placements, src_data_rank=None)
        for x, s in zip(leaves(tree), shs)])


def redistribute(tree, shardings):
    """Each leaf moved to its :class:`Sharding`'s placements (a tree like
    ``tree``, or one for every leaf); a plain tensor, the same on every
    rank, is placed as :func:`distribute` places it."""
    shs = (leaves(shardings) if not isinstance(shardings, Sharding)
           else [shardings] * len(leaves(tree)))
    return unflatten(tree, [
        x.redistribute(s.mesh, s.placements) if isinstance(x, DTensor)
        else distribute_tensor(x, s.mesh, s.placements, src_data_rank=None)
        for x, s in zip(leaves(tree), shs)])


def sharded(fn, mesh, in_shardings, out_shardings):
    """``fn`` over a mesh (the counterpart of ``jax.jit(fn, in_shardings=,
    out_shardings=)``): its positional arguments placed by
    ``in_shardings`` (a tuple, one tree of shardings an argument), ``fn``
    run under :func:`use_mesh`, and its result moved to
    ``out_shardings``."""
    def call(*args):
        args = [redistribute(a, s) for a, s in zip(args, in_shardings)]
        with use_mesh(mesh):
            out = fn(*args)
        return redistribute(out, out_shardings)
    return call


def gather(tree):
    """Each DTensor leaf as the whole tensor on every rank."""
    return unflatten(tree, [x.full_tensor() if isinstance(x, DTensor)
                            else x for x in leaves(tree)])


def local_shape(shape, sharding: Sharding) -> tuple:
    """The largest per-rank block of a tensor of ``shape`` placed by
    ``sharding`` (ceil division by each axis that shards a dim)."""
    out = list(shape)
    for d, a in enumerate(sharding.spec):
        if a is not None:
            out[d] = -(-out[d] // _axis_size(sharding.mesh, a))
    return tuple(out)


def local_bytes(tree, shardings) -> int:
    """Bytes one rank holds of ``tree`` (leaves with ``shape`` and
    ``dtype``: tensors, meta tensors) placed by ``shardings``."""
    return sum(math.prod(local_shape(x.shape, s)) * x.dtype.itemsize
               for x, s in zip(leaves(tree), leaves(shardings)))


# ------------------------------------------- activation constraints --------

_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate the activation constraints (and implicit replication of
    plain tensors) for model code run inside."""
    _ACTIVE.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, *axes):
    """``x`` redistributed to ``axes`` under the active mesh; the identity
    without one.

    Axis entries: ``"dp"`` → the data (+ pod) axes, ``"dpm"`` → data (+
    pod) + model flattened (pure-FSDP mode), ``"model"``, ``None``;
    divisibility-checked like every rule.  Under a mesh ``x`` must be a
    DTensor: a plain tensor there means an input was never placed."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh got a {type(x).__name__}, "
                        "not a DTensor: place the step's inputs first")

    def resolve(a):
        if a == "dp":
            return dp_axes(mesh)
        if a == "dpm":
            return dp_axes(mesh) + ("model",)
        return a

    want = placements(mesh, _p(mesh, tuple(x.shape),
                               *[resolve(a) for a in axes]))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def pad(x, widths):
    """``F.pad(x, widths)`` with zeros; a DTensor on each rank's part,
    whose padded dims no mesh axis may shard (aten.constant_pad_nd's
    DTensor rule fails on torch 2.11: its redistribution plan indexes past
    the placements)."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    shape = list(x.shape)
    for i, n in enumerate(widths):
        shape[x.dim() - 1 - i // 2] += n
    padded = {x.dim() - 1 - i // 2 for i, n in enumerate(widths) if n}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        raise ValueError(f"pad: dims {sorted(padded)} sharded by "
                         f"{x.placements}")
    shape = torch.Size(shape)
    return DTensor.from_local(
        F.pad(x.to_local(), widths), x.device_mesh, x.placements,
        shape=shape, stride=torch.empty(shape, device="meta").stride())


def on_every_rank(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` over a mesh with its operands whole on every
    rank: each DTensor leaf of ``args`` gathered to ``Replicate`` and run
    as a plain tensor, each tensor of the result made a replicated DTensor
    on the first operand's mesh, each rank computing the same thing.  For
    blocks built of ops DTensor has no sharding rule for (named where it
    is called)."""
    mesh = next(x for x in leaves(args) if isinstance(x, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim
    local = unflatten(args, [
        x.redistribute(mesh, rep).to_local() if isinstance(x, DTensor)
        else x for x in leaves(args)])
    out = fn(*local, **kwargs)
    return unflatten(out, [
        DTensor.from_local(x, mesh, rep) if isinstance(x, torch.Tensor)
        else x for x in leaves(out)])


def whole(x, dim: int):
    """A DTensor with ``dim`` held whole on every rank (no mesh axis
    shards it, partial sums reduced), its other dims as they were; a
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    want = tuple(Replicate() if p.is_partial() or (p.is_shard()
                                                   and p.dim == dim) else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)
