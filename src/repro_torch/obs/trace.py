"""In-loop trace planes — the PyTorch twin of ``repro/obs/trace.py``:
per-round records carried by the fused round engines and drained on the
host at each readback.

A ``TracePlane`` is a fixed-capacity ring of per-round records, two int32
tensors and a cursor on the engine's device:

* ``scalars``  (C, 5)    — ``(round, imbalance, min_key, max_key,
  overflow)`` per slot;
* ``pershard`` (C, S, 3) — ``(pops, pushes, occupancy)`` per shard;
* ``count``    ()        — rounds ever recorded (the write cursor; a
  count above C means the oldest records were overwritten, which the
  drain reports as ``dropped``, never as an error).

The round engines record through ``obs.record.obs_record`` (one kernel
launch a round on the card, these torch ops on the CPU), in place on the
engine's kept planes.  ``trace_record`` is the functional face: it
returns a new plane.  ``drain_plane`` and ``Telemetry`` turn the plane
into host ``RoundRecord``s (numpy on the host); ``SyncPoint`` is the
heartbeat every engine's ``sync_log`` holds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels._build import resolve_device

__all__ = [
    "KEY_SENTINEL", "RoundRecord", "SyncPoint", "Telemetry", "TracePlane",
    "drain_plane", "masked_min_max", "trace_init", "trace_record",
]

# min_key when a round popped nothing (max_key gets -KEY_SENTINEL): an
# int32 extremum no live key reaches (heap keys are below 2^30 - 1 and
# payloads below IDX_BOT)
KEY_SENTINEL = 2 ** 31 - 1


class TracePlane(NamedTuple):
    """Fixed-capacity ring of per-round records (see the module doc).
    The accessors work on tensors and on numpy arrays alike."""
    scalars: Any        # (C, 5): round, imbalance, min_key, max_key, overflow
    pershard: Any       # (C, S, 3): pops, pushes, occupancy
    count: Any          # () int32: records ever written

    @property
    def capacity(self) -> int:
        return self.scalars.shape[0]

    @property
    def shards(self) -> int:
        return self.pershard.shape[1]

    @property
    def round(self):
        return self.scalars[:, 0]

    @property
    def imbalance(self):
        return self.scalars[:, 1]

    @property
    def min_key(self):
        return self.scalars[:, 2]

    @property
    def max_key(self):
        return self.scalars[:, 3]

    @property
    def overflow(self):
        return self.scalars[:, 4]

    @property
    def pops(self):
        return self.pershard[:, :, 0]

    @property
    def pushes(self):
        return self.pershard[:, :, 1]

    @property
    def occupancy(self):
        return self.pershard[:, :, 2]


def trace_init(capacity: int, shards: int = 1, *,
               device="cuda") -> TracePlane:
    """Empty plane for ``capacity`` round records over ``shards`` shards
    on ``device``."""
    c, s = int(capacity), int(shards)
    if c < 1:
        raise ValueError(f"trace capacity must be >= 1, got {c}")
    if s < 1:
        raise ValueError(f"trace shards must be >= 1, got {s}")
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    empty = torch.tensor([-1, 0, KEY_SENTINEL, -KEY_SENTINEL, 0], **i32)
    return TracePlane(scalars=empty.repeat(c, 1),
                      pershard=torch.zeros((c, s, 3), **i32),
                      count=torch.zeros((), **i32))


def _vec(x, s: int, like: torch.Tensor) -> torch.Tensor:
    """A per-shard (S,) int32 vector from an (S,) or one-element value."""
    x = torch.as_tensor(x, dtype=torch.int32, device=like.device)
    return torch.broadcast_to(x.reshape(-1), (s,))


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.int32).reshape(())


def trace_record_(tp: TracePlane, round_idx, pops, pushes, occupancy,
                  min_key, max_key, overflow) -> TracePlane:
    """Write one round record at slot ``count % C`` and bump ``count``, IN
    PLACE, with torch ops only (nothing is read back).  ``pops``,
    ``pushes`` and ``occupancy`` are (S,) vectors or one-element values
    (S = 1); the claim imbalance is max - min of ``pops``."""
    s = tp.shards
    pops = _vec(pops, s, tp.count)
    row = torch.stack([
        _i32(round_idx, tp.count), (pops.max() - pops.min()).int(),
        _i32(min_key, tp.count), _i32(max_key, tp.count),
        _i32(overflow, tp.count)])
    per = torch.stack([pops, _vec(pushes, s, tp.count),
                       _vec(occupancy, s, tp.count)], dim=-1)
    slot = torch.remainder(tp.count, tp.capacity).reshape(1).long()
    tp.scalars.index_copy_(0, slot, row[None])
    tp.pershard.index_copy_(0, slot, per[None])
    tp.count.add_(1)
    return tp


def trace_record(tp: TracePlane, round_idx, pops, pushes, occupancy,
                 min_key, max_key, overflow) -> TracePlane:
    """Functional ``trace_record_``: a new plane with the record written
    (reference ``trace_record``)."""
    out = TracePlane(*(t.clone() for t in tp))
    return trace_record_(out, round_idx, pops, pushes, occupancy, min_key,
                         max_key, overflow)


def masked_min_max(keys, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extrema of ``keys`` where ``valid``, as 0-d int32 tensors: the
    round's min / max popped key (or payload); the sentinels when nothing
    popped."""
    keys = torch.as_tensor(keys).to(torch.int32)
    valid = torch.as_tensor(valid, device=keys.device).bool()
    mn = torch.where(valid, keys, KEY_SENTINEL).min()
    mx = torch.where(valid, keys, -KEY_SENTINEL).max()
    return mn.int(), mx.int()


def host_plane(tp: TracePlane) -> TracePlane:
    """A copy of the plane as numpy arrays on the host (never a view of a
    plane the engine keeps updating)."""
    return TracePlane(*(np.array(t.cpu() if isinstance(t, torch.Tensor)
                                 else t) for t in tp))


@dataclasses.dataclass
class RoundRecord:
    """One drained per-round record — the host face of a plane slot,
    timestamped at drain (in-loop rounds have no host clock;
    ``wall_time`` is when the record became visible)."""
    engine: str
    round: int
    pops: List[int]
    pushes: List[int]
    occupancy: List[int]
    imbalance: int
    min_key: int
    max_key: int
    overflow: bool
    sync: int            # index of the host sync that drained this record
    wall_time: float     # drain timestamp (time.time())

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoundRecord":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def drain_plane(tp: TracePlane, prev_count: int, *, engine: str = "fused",
                sync: int = 0, wall_time: float = None
                ) -> Tuple[List[RoundRecord], int, int]:
    """Read the plane back and extract the records written since
    ``prev_count``, oldest first.  Returns ``(records, new_count,
    dropped)``, ``dropped`` counting rounds whose slots were overwritten
    before this drain."""
    host = host_plane(tp)
    cap = host.capacity
    count = int(host.count)
    fresh = count - int(prev_count)
    if fresh <= 0:
        return [], count, 0
    dropped = max(fresh - cap, 0)
    keep = fresh - dropped
    wall_time = time.time() if wall_time is None else wall_time
    slots = np.arange(count - keep, count) % cap
    sync = int(sync)
    records = [
        RoundRecord(engine=engine, round=r, pops=p, pushes=pu, occupancy=o,
                    imbalance=im, min_key=mn, max_key=mx, overflow=bool(of),
                    sync=sync, wall_time=wall_time)
        for r, p, pu, o, im, mn, mx, of in zip(
            host.round[slots].tolist(), host.pops[slots].tolist(),
            host.pushes[slots].tolist(), host.occupancy[slots].tolist(),
            host.imbalance[slots].tolist(), host.min_key[slots].tolist(),
            host.max_key[slots].tolist(), host.overflow[slots].tolist())]
    return records, count, dropped


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


class Telemetry:
    """Host-side telemetry collector for one engine instance.

    Pass ``telemetry=Telemetry(...)`` to a fused round engine: the engine
    carries a ``TracePlane`` of ``capacity`` records through its rounds
    and drains it here at every readback (the same readback: telemetry
    adds no sync of its own).  ``records`` accumulates drained
    ``RoundRecord``s across runs until ``reset()``; ``dropped`` counts
    overwritten rounds; ``sync_points`` mirrors the engine's
    ``sync_log``.  With ``telemetry=None`` the engine's round is the
    unobserved one.  ``registry`` (a ``MetricsRegistry``, made when not
    given) receives the engine's stats as ``engine.<stat>`` gauges."""

    def __init__(self, capacity: int = 1024, *, engine: str = "fused",
                 registry=None) -> None:
        if int(capacity) < 1:
            raise ValueError(f"telemetry capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self.engine = engine
        if registry is None:
            from .metrics import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self.reset()

    def reset(self) -> None:
        self._records: List[RoundRecord] = []
        self._pending: List[Tuple[TracePlane, int, int, float]] = []
        self.sync_points: List[SyncPoint] = []
        self.dropped = 0
        self._count = 0

    def begin_run(self) -> None:
        """Called by the engine at the start of ``run``: a fresh plane
        means a fresh cursor (records of earlier runs are kept)."""
        self._count = 0

    @property
    def records(self) -> List[RoundRecord]:
        """Drained ``RoundRecord``s, oldest first, made from the host
        copies ``drain`` took on first access."""
        if self._pending:
            for host, prev, sync, wall_time in self._pending:
                recs, _, _ = drain_plane(host, prev, engine=self.engine,
                                         sync=sync, wall_time=wall_time)
                self._records.extend(recs)
            self._pending = []
        return self._records

    def drain(self, tp: TracePlane, *, sync: int = 0,
              wall_time: float = None) -> int:
        """Copy the plane to the host and account for it; returns the
        number of fresh records kept."""
        host = host_plane(tp)
        count = int(host.count)
        fresh = count - self._count
        if fresh <= 0:
            return 0
        dropped = max(fresh - host.capacity, 0)
        self._pending.append(
            (host, self._count, sync,
             time.time() if wall_time is None else wall_time))
        self._count = count
        self.dropped += dropped
        if dropped:
            self.registry.counter(f"{self.engine}.trace_dropped", dropped)
        return fresh - dropped

    def heartbeat(self, point: SyncPoint) -> None:
        self.sync_points.append(point)

    def finish(self, stats: Dict[str, int]) -> None:
        """Absorb the engine's stats into the registry as stable
        ``engine.<stat>`` gauges."""
        for k, v in stats.items():
            self.registry.gauge(f"{self.engine}.{k}", v)
