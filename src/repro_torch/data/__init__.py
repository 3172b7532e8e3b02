"""Host data structures of the port (so far the serving engine's
free-page ring)."""

from .pipeline import HostRing

__all__ = ["HostRing"]
