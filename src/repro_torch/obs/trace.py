"""Host-sync heartbeat records — the part of ``repro/obs/trace.py`` the
round engine needs.  The trace and span planes come with the
observability slice."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class SyncPoint:
    """One host-sync heartbeat: the ``sync_log`` entry every engine
    records (fused: one per chunk; legacy: one per round).  Dict-style
    access matches the reference's callers."""
    rounds: int
    occupancy: int
    wall_time: float
    host_syncs: int = 0

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
