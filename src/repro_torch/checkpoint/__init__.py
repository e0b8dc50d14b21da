"""Checkpoints of the port (the reference's ``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
