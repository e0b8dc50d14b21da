"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

The reference's ten architectures, selectable through ``--arch <id>`` in
the launchers, and the input-shape cells each runs (``SHAPES``,
``shape_cells``); the port's own (``PORT_ARCHS``: ``granite-4.0-h-micro``)
by name and in the serve CLI.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, HybridConfig, ModelConfig, ShapeConfig, TrainConfig

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

# The port's own architectures, beyond the reference's: reached by name,
# kept out of ``ARCHS``.
_PORT_MODULES = {
    "granite-4.0-h-micro": "granite_4_0_h_micro",
}
PORT_ARCHS = tuple(_PORT_MODULES)

# long_500k needs sub-quadratic sequence mixing:
SUBQUADRATIC = ("mixtral-8x22b", "mamba2-1.3b", "recurrentgemma-2b")


def _module(name: str):
    mod = _MODULES.get(name) or _PORT_MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{list(_MODULES) + list(_PORT_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def shape_cells(arch: str) -> list[str]:
    """The (arch x shape) cells that run for this arch: long_500k only
    for the sub-quadratic ones."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        cells.append("long_500k")
    return cells


__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "SUBQUADRATIC", "HybridConfig",
           "ModelConfig", "ShapeConfig", "TrainConfig", "get_config",
           "get_smoke_config", "shape_cells"]
