"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Holds the architectures the port runs so far (the reference registers
ten; the others arrive with the slices that port their block types).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
