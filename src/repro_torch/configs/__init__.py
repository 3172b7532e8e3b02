"""Per-architecture configs (assignment pool) + registry — copies of
``repro.configs``, which the port does not import."""
from .base import ArchConfig, SHAPES
from .registry import ARCHS, get_config, list_archs

__all__ = ["ArchConfig", "SHAPES", "ARCHS", "get_config", "list_archs"]
