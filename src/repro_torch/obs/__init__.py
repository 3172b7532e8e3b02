"""Observability records of the port (so far only ``SyncPoint``)."""

from .trace import SyncPoint

__all__ = ["SyncPoint"]
