"""Optimizer of the port: AdamW with global-norm clipping and the cosine
schedule, and int8 error-feedback gradient compression (the reference's
``repro.optim``)."""
from . import compression
from .adamw import (AdamWConfig, apply_updates, apply_updates_zero1,
                    global_norm, init_state, init_state_zero1, schedule)

__all__ = ["AdamWConfig", "apply_updates", "apply_updates_zero1",
           "global_norm", "init_state", "init_state_zero1", "schedule",
           "compression"]
