"""Optimizer substrate of the port: AdamW with mixed precision and its
schedule — the PyTorch twin of ``repro/optim``."""
from . import adamw
from .adamw import AdamWConfig, OptState, cast_params, global_norm

__all__ = ["adamw", "AdamWConfig", "OptState", "cast_params", "global_norm"]
