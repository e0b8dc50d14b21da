"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The reference's ten architectures, selectable through ``--arch <id>`` in
the launchers.
"""
from __future__ import annotations

import importlib

from .base import ModelConfig

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "command-r-35b": "command_r_35b",
    "granite-3-2b": "granite_3_2b",
    "qwen2-72b": "qwen2_72b",
    "llama3.2-1b": "llama3_2_1b",
    "musicgen-large": "musicgen_large",
    "internvl2-76b": "internvl2_76b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
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
