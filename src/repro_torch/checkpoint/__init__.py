"""Checkpoints of the port: async write with an atomic commit."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
