"""Shape-only stand-ins for every model input (the reference's
``repro.launch.specs``): meta tensors, which hold a shape and a dtype and
no data, so the dry run never allocates.  Params, optimizer state and
caches are made by the port's own initialisers under ``FakeTensorMode``
(same shapes and dtypes as a real run), then turned into meta tensors.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, ModelConfig, ShapeConfig, get_config
from repro_torch.models import model as M
from repro_torch.runtime import steps as R
from repro_torch.tree import tree_map


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_tree(make):
    """``make()``'s tree, run under ``FakeTensorMode``, as meta tensors."""
    with FakeTensorMode():
        tree = make()
    return tree_map(lambda x: meta(x.shape, x.dtype), tree)


def batch_specs(cfg, shape: ShapeConfig, microbatches: int = 1) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"tokens": meta((b, 1), torch.int64)}
        return {"embeds": meta((b, 1, cfg.d_model), cfg.cdtype)}
    # train batches arrive pre-shaped (microbatches, local, ...)
    lead = (microbatches, b // microbatches) if microbatches > 1 else (b,)
    out = {"labels": meta((*lead, s), torch.int64)}
    if cfg.input_mode == "tokens":
        out["tokens"] = meta((*lead, s), torch.int64)
    else:
        out["embeds"] = meta((*lead, s, cfg.d_model), cfg.cdtype)
    if shape.kind == "prefill":
        out.pop("labels")
    return out


def params_specs(cfg, dtype=None):
    """The params' stand-ins; ``dtype`` casts the floating leaves (serving
    checkpoints in the compute dtype halve the weight traffic)."""
    specs = _meta_tree(lambda: M.init_params(cfg, 0, "cpu"))
    if dtype is None:
        return specs
    return tree_map(lambda x: meta(x.shape, dtype) if x.is_floating_point()
                    else x, specs)


def state_specs(cfg, grad_compression: str = "none",
                param_mode: str = "fsdp"):
    return _meta_tree(lambda: R.init_train_state(
        cfg, 0, grad_compression=grad_compression, param_mode=param_mode,
        device="cpu"))


def cache_specs(cfg, batch: int, cache_len: int):
    return _meta_tree(lambda: M.init_caches(cfg, batch, cache_len, "cpu"))


def input_specs(arch, shape_name="train_4k", grad_compression: str = "none",
                microbatches: int = 1, param_mode: str = "fsdp") -> dict:
    """The step function's arguments for this (arch, shape) cell, in its
    positional order.  ``arch`` is a name or a ``ModelConfig``,
    ``shape_name`` a name or a ``ShapeConfig``."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    if shape.kind == "train":
        return {"state": state_specs(cfg, grad_compression, param_mode),
                "batch": batch_specs(cfg, shape, microbatches)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg, cfg.cdtype),
                "batch": batch_specs(cfg, shape)}
    # decode: one new token against a cache of seq_len
    return {"params": params_specs(cfg, cfg.cdtype),
            "caches": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "batch": batch_specs(cfg, shape),
            "pos": meta((shape.global_batch,), torch.int64)}
