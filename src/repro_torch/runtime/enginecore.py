"""The fused-engine core — the PyTorch twin of
``repro/runtime/enginecore.py``: one chunk runner, one plane registry,
one host driver behind every round engine.

An engine is a configuration of this core:

* ``_round(qstate, acc, live)`` — the one-round body.  Returns
  ``(qstate, acc, k, total, over)``: ``k`` the round's claim count,
  ``total`` the installed-children count (0 when ``over``), ``over`` the
  overflow flag.  ``live`` is a 0-d bool device tensor; a round with
  ``live`` false must leave the queue state untouched and return
  ``k = total = 0`` and ``over = False``.  The core masks ``acc`` itself.
* ``_occ_of(qstate)`` — the occupancy as a 0-d int32 device tensor.
* a ``PlaneRegistry`` describing the queue planes the engine carries.

PyTorch has no ``lax.while_loop``.  ``fused_loop`` stands in for it: it
runs a chunk of exactly ``limit`` rounds, each predicated on the device
flag ``live = (occupancy > 0) & ~overflow & (rounds < limit)``, so a
drained, overflowed or finished loop runs on as bit-exact no-ops and the
host reads nothing between rounds.  ``_run_chunks`` reads back
``(occupancy, rounds, overflow, processed, spawned, max_occupancy)`` once
per chunk, and ``_drive`` raises the reference's overflow and truncation
errors, word for word, at the readback after the flagged round.

The trace and span planes of the reference wait for the observability
slice: passing ``telemetry`` or ``spans`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.trace import SyncPoint

#: longest chunk between two readbacks when ``sync_every=0``
MAX_CHUNK = 64


def _sds(shape, dtype=torch.int32) -> torch.Tensor:
    """Shape-only leaf for registry declarations (a meta tensor: no
    memory is allocated)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a nest of tuples, lists and dicts (None is an
    empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_to(tree, device: torch.device):
    """Move an accumulator tree onto ``device``.  Non-tensor leaves
    (Python or numpy numbers and arrays) become tensors with 64-bit types
    narrowed to 32 bits, as the reference's ``jnp.asarray`` does."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(t, device) for t in tree)
    a = np.asarray(tree)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def tree_where(live: torch.Tensor, new, old):
    """``torch.where(live, new, old)`` leaf by leaf."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(live, new, old)
    if isinstance(new, dict):
        return {k: tree_where(live, new[k], old[k]) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(tree_where(live, a, b) for a, b in zip(new, old))
    raise TypeError(f"unsupported tree node {type(new).__name__}")


class PlaneGroup(NamedTuple):
    """One named group of carried leaves (a queue plane set)."""
    name: str
    shapes: Tuple[Tuple[Tuple[int, ...], str], ...]   # ((shape, dtype), ...)
    sharded: bool

    @property
    def nbytes(self) -> int:
        return sum(int(np.prod(s, dtype=np.int64))
                   * getattr(torch, d).itemsize for s, d in self.shapes)


class PlaneRegistry:
    """The carried-plane registry: each engine registers its plane groups
    once (name + leaves + sharded flag) and the registry answers how many
    bytes of carried state a shard holds (``bytes_per_shard``: sharded
    groups divide by the shard count, replicated groups do not).  The
    reference's shard_map specs come with the mesh engines."""

    def __init__(self) -> None:
        self._groups: Dict[str, PlaneGroup] = {}

    def register(self, name: str, example, *, sharded: bool = False) -> None:
        shapes = tuple((tuple(int(d) for d in leaf.shape),
                        str(leaf.dtype).removeprefix("torch."))
                       for leaf in tree_leaves(example))
        self._groups[name] = PlaneGroup(name, shapes, sharded)

    @property
    def groups(self) -> Tuple[PlaneGroup, ...]:
        return tuple(self._groups.values())

    def bytes_per_shard(self, shards: int = 1) -> int:
        return sum(g.nbytes // shards if g.sharded else g.nbytes
                   for g in self._groups.values())


class EngineEntry(NamedTuple):
    """One row of the engine matrix (``ENGINE_REGISTRY``)."""
    name: str
    runner: type
    priority: bool          # PriorityStepFn + run(keys, vals) signature
    mesh: bool              # constructor takes mesh=
    kwargs: Dict[str, Any]  # mode selectors
    spans_ok: bool          # span planes supported in this configuration


ENGINE_REGISTRY: Dict[str, EngineEntry] = {}


def register_engine(name: str, runner: type, *, priority: bool, mesh: bool,
                    kwargs: Optional[Dict[str, Any]] = None,
                    spans_ok: bool = True) -> None:
    """Register a runner configuration in the engine matrix."""
    ENGINE_REGISTRY[name] = EngineEntry(name, runner, priority, mesh,
                                        dict(kwargs or {}), spans_ok)


def reject_obs(telemetry, spans) -> None:
    """Trace and span planes are not ported yet: refuse them loudly."""
    if telemetry is not None or spans is not None:
        raise NotImplementedError(
            "telemetry and spans planes come with the observability slice "
            "of the PyTorch port (repro_torch.obs); pass telemetry=None and "
            "spans=None")


class EngineCore:
    """Shared core of every fused round engine: the predicated chunk
    runner (``fused_loop``), the chunked host driver (``_run_chunks`` /
    ``_drive``) and the plane registry.  Subclasses configure ``_round``
    and ``_occ_of``."""

    sync_every: int
    capacity: int

    def _reset(self) -> None:
        self.stats: Dict[str, int] = {}
        self.sync_log: List[SyncPoint] = []

    @property
    def registry(self) -> PlaneRegistry:
        if getattr(self, "_registry", None) is None:
            self._registry = PlaneRegistry()
        return self._registry

    def loop_carry_bytes(self, shards: Optional[int] = None) -> int:
        """Per-shard bytes of registered carried planes (the workload's
        acc is excluded: it is the caller's state, not the engine's)."""
        return self.registry.bytes_per_shard(
            shards if shards is not None else getattr(self, "shards", 1))

    def fused_loop(self, round_fn, occ_of, qstate, acc, processed, spawned,
                   max_occ, limit: int):
        """Run exactly ``limit`` occupancy-predicated rounds on the
        device, with no readback.  Returns ``(qstate, acc, processed,
        spawned, max_occ, oflow, rounds)``: the counters are 0-d device
        tensors and ``rounds`` counts the live rounds only.  The counter
        updates are the reference's ``fused_loop`` updates, applied only
        where ``live``."""
        dev = processed.device
        oflow = torch.zeros((), dtype=torch.bool, device=dev)
        rounds = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(limit):
            live = (occ_of(qstate) > 0) & ~oflow & (rounds < limit)
            qstate, new_acc, k, total, over = round_fn(qstate, acc, live)
            acc = tree_where(live, new_acc, acc)
            processed = processed + k
            spawned = spawned + total
            max_occ = torch.where(live,
                                  torch.maximum(max_occ, occ_of(qstate)),
                                  max_occ)
            oflow = oflow | (over & live)
            rounds = rounds + live.to(torch.int32)
        return qstate, acc, processed, spawned, max_occ, oflow, rounds

    # -- host drivers --------------------------------------------------------

    def _run_chunks(self, state, occ_of, what: str, max_rounds: int) -> None:
        """Drive ``fused_loop`` over ``self._round`` to quiescence.
        ``state = [qstate, acc, processed, spawned, max_occ]`` is updated
        in place; each chunk ends in ONE readback of six integers."""

        def chunk_fn(limit):
            out = self.fused_loop(self._round, occ_of, *state, limit)
            state[:] = out[:5]
            oflow, r = out[5], out[6]
            occ, r, oflow, processed, spawned, max_occ = torch.stack(
                [occ_of(state[0]), r, oflow.to(torch.int32), state[2],
                 state[3], state[4]]).tolist()          # THE host sync
            return occ, r, bool(oflow), processed, spawned, max_occ

        self._drive(chunk_fn, max_rounds, what)

    def _drive(self, chunk_fn, max_rounds: int, what: str) -> None:
        """``chunk_fn(limit)`` advances the state by up to ``limit`` rounds
        and returns (occupancy, rounds_delta, overflow, processed,
        spawned, max_occ) — one host sync per call.  Chunks are
        ``sync_every`` rounds long, or, with ``sync_every=0``, 1, 2, 4, ...
        rounds, doubling up to ``MAX_CHUNK``: a short run reads back about
        log2 of its length times and wastes fewer predicated no-op rounds
        than it ran, a long run reads back once per ``MAX_CHUNK`` rounds."""
        rounds = host_syncs = 0
        grow = 1
        while True:
            if self.sync_every > 0:
                chunk = self.sync_every
            else:
                chunk, grow = grow, min(2 * grow, MAX_CHUNK)
            limit = min(chunk, max_rounds - rounds)
            occ, r, oflow, processed, spawned, max_occ = chunk_fn(limit)
            rounds += r
            host_syncs += 1
            self.sync_log.append(SyncPoint(rounds=rounds, occupancy=occ,
                                           wall_time=time.time(),
                                           host_syncs=host_syncs))
            self.stats = {
                "rounds": rounds, "processed": processed, "spawned": spawned,
                "max_occupancy": max_occ, "drained": int(occ == 0),
                "host_syncs": host_syncs,
            }
            if oflow:
                raise RuntimeError(
                    f"{what} overflow: occupancy {occ} + spawned children "
                    f"exceed capacity {self.capacity} at round {rounds} "
                    f"(raise capacity_log2 or lower the fanout)")
            if occ == 0:
                return
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"{what} round loop truncated at max_rounds="
                    f"{max_rounds} with occupancy {occ}: not quiescent "
                    f"(stats['drained']=0)")
