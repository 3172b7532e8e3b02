"""The fused-engine core — the PyTorch twin of
``repro/runtime/enginecore.py``: one chunk runner, one plane registry,
one host driver behind every round engine.

An engine is a configuration of this core:

* ``_round(qstate, acc, live, sp=None, births=None)`` — the one-round
  body.  Returns ``(qstate, acc, k, total, over, wave)``: ``k`` the
  round's claim count, ``total`` the installed-children count (0 when
  ``over``), ``over`` the overflow flag, ``wave`` the claim wave's
  ``ObsWave`` when telemetry or spans are on (else None).  ``live`` is a
  0-d bool device tensor; a round with ``live`` false must leave the
  queue state untouched and return ``k = total = 0`` and ``over =
  False``.  The core runs rounds only while the loop condition holds, so
  it always passes a true ``live``.  ``sp`` (the span plane) and
  ``births`` (the heap's stamp plane) are given when spans are on: the
  round stamps its installs with ``sp.round``.  A mesh round's wave
  carries its shards' pops, pushes and occupancies, recorded as one
  trace row with per-shard columns and a stacked span plane.
* ``_occ_of(qstate)`` — the occupancy as a 0-d int32 device tensor.
* a ``PlaneRegistry`` describing the queue planes the engine carries.

A chunk is the reference's ``lax.while_loop``: rounds run while
``occupancy > 0 and not overflow and rounds < limit`` (and, for an
engine with a stop word, ``not stop``: ``_stop_of``, the reference's
``_extra_cond``), the condition tested before every round, and the chunk
ends in ONE readback of
``(occupancy, rounds, overflow, processed, spawned, max_occupancy)``.  A
chunk is ``sync_every`` rounds, or ``max_rounds`` when ``sync_every`` is
0, so a drained run reads back once, as in the reference, and
``host_syncs`` and ``sync_log`` are the reference's.  ``_drive`` raises
the reference's overflow and truncation errors, word for word, at the
readback after the flagged round.

Each round is ``_round_into``: the engine's round on the chunk's carried
buffers (``Carry``), written back into them IN PLACE, then, with
telemetry or spans on, the round's record (``obs.record.obs_record``:
the trace row and the span histogram, one launch on the card) where the
reference's ``fused_loop`` calls ``trace_record``.  On the card a
chunk is one launch of a ``DeviceLoop``: a CUDA graph whose conditional
WHILE node (``csrc/loop.cu``) replays the round body, captured once per
engine and shape, and tests the condition on the card; nothing is read
back between rounds.  On the CPU the same body runs in a Python loop that
tests the same condition after every round.  A round body therefore may
not read anything back to the host (no ``.item()``, ``bool()`` or
``.tolist()`` of a device tensor, no copy of a Python value to the card)
and must launch the same kernels every round; its allocations come from
the graph's private pool at capture time.

Observability (``repro_torch.obs``): with a ``Telemetry`` or ``Spans``
collector the carry holds a trace plane, a span plane and (heap) a
births plane beside the queue state, zeroed at the start of a run
outside the captured round; ``_drive`` drains them at each chunk's
readback (trace plane first, then span plane, as in the reference), so
``host_syncs`` and ``sync_log`` are the unobserved run's.  Packed ring
stamps cap the round clock at ``SPAN_ROUND_CAP``: with spans on, the
chunk loop clamps each chunk to it and raises the reference's error past
it.  With both collectors off the captured round is the unobserved one,
node for node.

The mesh runners' legacy loop (``meshrounds._MeshBase._legacy``, the
reference's ``_legacy_loop``) issues one round at a time from the host
and reads back after each; an empty run reads nothing back.

A mesh across processes (one shard a rank) makes one collective a round
and runs its chunks in the Python loop on either backend: each round is
issued from the host after one readback of the loop's condition, which
reads replicated words only (occupancy, overflow, the round count and
the stop word), so every rank runs the same rounds and makes the same
collectives.  ``host_syncs`` and ``sync_log`` count chunks, as on one
card.
"""

from __future__ import annotations

import ctypes
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import _build
from ..kernels.ring_slots import SPAN_ROUND_CAP
from ..obs.record import obs_record
from ..obs.spans import Spans, span_init
from ..obs.trace import SyncPoint, Telemetry, trace_init


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


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of a nest of tuples (named
    tuples included), lists and dicts; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
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


def tree_copy_(dst, src) -> None:
    """Write the leaves of ``src`` into those of ``dst`` (one structure),
    in place; a leaf that already is its destination is left alone."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


class Carry(NamedTuple):
    """The buffers one chunk of rounds runs on, updated in place: the
    queue state and acc, the run's counters (0-d int32: processed,
    spawned, max_occ), the chunk's (oflow, a 0-d bool; rounds), the
    occupancy after the last round, the chunk's round limit, a true
    ``live`` flag for ``_round``, and the observability planes (the
    trace plane, the span plane, the heap's births plane; None when
    off)."""
    q: Any
    acc: Any
    processed: torch.Tensor
    spawned: torch.Tensor
    max_occ: torch.Tensor
    oflow: torch.Tensor
    rounds: torch.Tensor
    occ: torch.Tensor
    limit: torch.Tensor
    live: torch.Tensor
    tp: Any = None
    sp: Any = None
    births: Any = None


class ObsWave(NamedTuple):
    """What a round hands its record: the claim wave's keys (the popped
    keys, or the FIFO payloads: the trace row's extrema and ``class_of``'s
    input), its ``valid`` lanes, the payloads (``ref``) and, with spans
    on, the claimed items' birth rounds.  A mesh round's wave is its
    (S, batch) claim grid flattened, with ``shards`` = S, each shard's
    ``pops``, ``pushes`` and occupancy after the round (``occs``, (S,)
    int32) for the trace row, and the class rows (``cls``) it records
    without a ``class_of``."""
    keys: torch.Tensor
    valid: torch.Tensor
    ref: torch.Tensor
    births: Optional[torch.Tensor]
    shards: Optional[int] = None
    pops: Optional[torch.Tensor] = None
    pushes: Optional[torch.Tensor] = None
    occs: Optional[torch.Tensor] = None
    cls: Optional[torch.Tensor] = None


def new_carry(q, acc, device: torch.device, obs=(None, None, None)) -> Carry:
    """A ``Carry`` over ``q``, ``acc`` and the observability planes
    ``obs`` = (tp, sp, births) with zeroed counters and a true ``live``."""
    i32 = dict(dtype=torch.int32, device=device)
    return Carry(q, acc, *(torch.zeros((), **i32) for _ in range(3)),
                 torch.zeros((), dtype=torch.bool, device=device),
                 *(torch.zeros((), **i32) for _ in range(3)),
                 torch.ones((), dtype=torch.bool, device=device), *obs)


class DeviceLoop:
    """A chunk of rounds as one CUDA graph launch: ``body(carry)`` (one
    round, written back into ``carry``) is captured once with
    ``torch.cuda.graph`` after one uncaptured warm-up on a copy of the
    carry (which builds the kernels, sets their attributes and allocates
    the engine's kept scratch), and ``csrc/loop.cu`` wraps the captured
    graph in a conditional WHILE node over ``carry.occ``, ``.oflow``,
    ``.rounds`` and ``.limit``, and ``stop`` (a bool device tensor, or
    None): the optional fifth word, whose first element, once a round
    sets it, ends the chunk (the reference's ``_extra_cond``).

    ``_build.LAUNCHES`` is counted by the kernel wrappers, which run once,
    at capture; ``per_round`` is what the capture counted (taken back out
    of ``LAUNCHES``), and ``count(rounds)`` adds it once per replayed
    round.  Failing to capture or to build the node raises: nothing falls
    back to eager rounds."""

    def __init__(self, body: Callable[[Carry], None], carry: Carry,
                 stop: Optional[torch.Tensor] = None) -> None:
        lib = _build.library("loop")
        body(tree_map(torch.clone, carry))            # warm-up, on a copy
        torch.cuda.synchronize(carry.occ.device)
        before = dict(_build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(self.graph):
                body(carry)
        finally:
            self.per_round = {k: v - before[k]
                              for k, v in _build.LAUNCHES.items()
                              if v != before[k]}
            _build.LAUNCHES.update(before)
        graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib.repro_loop_create(
            self.graph.raw_cuda_graph(), carry.occ.data_ptr(),
            carry.oflow.data_ptr(), carry.rounds.data_ptr(),
            carry.limit.data_ptr(),
            None if stop is None else stop.data_ptr(), ctypes.byref(graph),
            ctypes.byref(exe)),
            "device loop: building the conditional WHILE graph")
        self._lib = lib
        self._exec = exe.value
        self._free = weakref.finalize(self, lib.repro_loop_destroy,
                                      graph.value, exe.value)

    def launch(self, stream: int) -> None:
        _build.check(self._lib.repro_loop_launch(self._exec, stream),
                     "device loop: graph launch")
        _build.LAUNCHES["device_loop"] += 1

    def count(self, rounds: int) -> None:
        for k, v in self.per_round.items():
            _build.LAUNCHES[k] += v * rounds


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


class EngineCore:
    """Shared core of every fused round engine: the in-place round body
    (``_round_into``), the chunk runners (a ``DeviceLoop`` on the card, a
    Python loop on the CPU), the host side (``_run_chunks`` /
    ``_drive``), the observability planes' lifecycle and the plane
    registry.  Subclasses configure ``_round`` and ``_occ_of``."""

    sync_every: int
    capacity: int
    batch: int
    device: torch.device
    telemetry: Optional[Telemetry] = None
    spans: Optional[Spans] = None
    span_round_cap: int = SPAN_ROUND_CAP

    def _reset(self) -> None:
        self.stats: Dict[str, int] = {}
        self.sync_log: List[SyncPoint] = []
        if self.telemetry is not None:
            self.telemetry.begin_run()
        if self.spans is not None:
            self.spans.begin_run()

    @property
    def _observed(self) -> bool:
        return self.telemetry is not None or self.spans is not None

    @property
    def _host_rounds(self) -> bool:
        """Whether the chunk's rounds are issued from the host on the card
        too: a mesh across processes, whose collective is not captured."""
        mesh = getattr(self, "mesh", None)
        return mesh is not None and mesh.group is not None

    @property
    def registry(self) -> PlaneRegistry:
        if getattr(self, "_registry", None) is None:
            self._registry = PlaneRegistry()
        return self._registry

    def _register_obs_planes(self, shards: int = 1, *, stacked: bool = False,
                             births_shape=None,
                             births_sharded: bool = False) -> None:
        """Register the trace, span and births groups (empty when their
        collector is off), as the reference does: a trace plane of
        ``shards`` per-shard columns, and with ``stacked`` (the mesh
        engines) a span plane under a leading shard axis, sharded, one
        class row a shard without ``class_of``.  ``births_shape`` is the
        heap's stamp plane (the ring packs its stamps into a flag plane),
        sharded with ``births_sharded`` (one heap a shard)."""
        reg = self.registry
        self._obs_layout = (shards, stacked)
        self._births_shape = births_shape
        tel = spn = births = None
        if self.telemetry is not None:
            c = self.telemetry.capacity
            tel = (_sds((c, 5)), _sds((c, shards, 3)), _sds(()))
        if self.spans is not None:
            sp = self.spans
            lead = (shards,) if stacked else ()
            spn = (_sds(lead + (self.batch, self._span_rows(shards, stacked),
                                sp.buckets + 1)),
                   _sds(lead + (sp.flow_capacity, 4)), _sds(lead),
                   _sds(lead))
            if births_shape is not None:
                births = _sds(births_shape)
        reg.register("trace", tel)
        reg.register("span", spn, sharded=stacked)
        reg.register("births", births, sharded=births_sharded)

    def loop_carry_bytes(self, shards: Optional[int] = None) -> int:
        """Per-shard bytes of registered carried planes, observability
        planes included (the workload's acc is excluded: it is the
        caller's state, not the engine's); sharded groups divide by the
        shard count."""
        return self.registry.bytes_per_shard(
            shards if shards is not None else getattr(self, "shards", 1))

    # -- observability planes -------------------------------------------------

    def _span_rows(self, shards: int = 1, stacked: bool = False) -> int:
        """Histogram rows: the collector's classes, or one a shard on a
        stacked plane without ``class_of`` (reference ``_span_init``)."""
        if stacked and self.spans.class_of is None:
            return shards
        return self.spans.classes

    def _tel_init(self, shards: int = 1):
        """A fresh trace plane of ``shards`` per-shard columns on the
        engine's device (telemetry on), else None."""
        if self.telemetry is None:
            return None
        return trace_init(self.telemetry.capacity, shards,
                          device=self.device)

    def _span_init(self, shards: int = 1, *, stacked: bool = False):
        """A fresh span plane, one accumulator slice per batch lane (spans
        on), else None; ``stacked`` puts one plane a shard under a
        leading shard axis."""
        if self.spans is None:
            return None
        sp = self.spans
        z = span_init(self._span_rows(shards, stacked), buckets=sp.buckets,
                      flow_capacity=sp.flow_capacity, lanes=self.batch,
                      device=self.device)
        if stacked:
            z = type(z)(*(x.expand((shards,) + x.shape).clone() for x in z))
        return z

    def _births_init(self, shape):
        """A zeroed birth-stamp plane (spans on), else None: seeds are
        born at round 0."""
        if self.spans is None or shape is None:
            return None
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _obs_init(self):
        """Fresh (trace, span, births) planes for one run."""
        shards, stacked = getattr(self, "_obs_layout", (1, False))
        return (self._tel_init(shards),
                self._span_init(shards, stacked=stacked),
                self._births_init(self._births_shape))

    def _span_cls(self, keys_or_vals):
        """Per-lane class rows: the collector's ``class_of`` applied to
        the popped keys (priority) or payloads (FIFO), else None (class
        0)."""
        if self.spans is not None and self.spans.class_of is not None:
            return torch.as_tensor(self.spans.class_of(keys_or_vals)).to(
                torch.int32)
        return None

    # -- the round ------------------------------------------------------------

    def _round_into(self, c: Carry) -> None:
        """One round on the carried buffers, written back into them in
        place, with the reference's ``fused_loop`` counter updates and,
        when observed, the round's trace and span record."""
        q, acc, k, total, over, wave = self._round(c.q, c.acc, c.live,
                                                   c.sp, c.births)
        tree_copy_(c.q, q)
        tree_copy_(c.acc, acc)
        occ = self._occ_of(c.q)
        c.processed.add_(k)
        c.spawned.add_(total)
        torch.maximum(c.max_occ, occ, out=c.max_occ)
        c.oflow.logical_or_(over)
        c.rounds.add_(1)
        c.occ.copy_(occ)
        if wave is not None:
            cls = self._span_cls(wave.keys)
            mesh = wave.shards is not None
            obs_record(c.tp, c.sp, keys=wave.keys, valid=wave.valid,
                       ref=wave.ref, births=wave.births,
                       cls=wave.cls if cls is None else cls,
                       k=wave.pops if mesh else k,
                       total=wave.pushes if mesh else total,
                       occ=wave.occs if mesh else occ, over=over,
                       shards=wave.shards)

    def _device_loop(self, q, acc, obs) -> Tuple[Carry, DeviceLoop]:
        """The engine's kept carry and device loop for this shape of queue
        state, acc and observability planes (and ``class_of``), built
        (and the round captured) at first use."""
        loops = self.__dict__.setdefault("_loops", {})
        key = tuple((tuple(t.shape), t.dtype) for t in
                    tree_leaves(q) + tree_leaves(acc) + tree_leaves(obs))
        key += (tuple(x is None for x in obs),
                id(getattr(self.spans, "class_of", None)))
        if key not in loops:
            carry = new_carry(tree_map(torch.clone, q),
                              tree_map(torch.clone, acc), self.device,
                              tree_map(torch.clone, obs))
            loops[key] = (carry, DeviceLoop(self._round_into, carry,
                                            self._stop_of(carry)))
        return loops[key]

    def _stop_of(self, carry: Carry) -> Optional[torch.Tensor]:
        """The engine's stop word in ``carry``: a bool device tensor whose
        first element, once a round sets it, ends the chunk (the
        reference's ``_extra_cond``); None for an engine without one."""
        return None

    def _run_chunk(self, carry: Carry, loop: Optional[DeviceLoop],
                   limit: int) -> None:
        """One chunk of up to ``limit`` rounds on ``carry``: a launch of
        the device loop on the card (nothing read back), else the Python
        loop, which reads the same condition back before every round in
        one stacked readback."""
        if loop is not None:
            carry.limit.fill_(limit)
            loop.launch(_build.stream_of(carry.occ))
            return
        carry.rounds.zero_()
        carry.oflow.zero_()
        stop = self._stop_of(carry)
        words = [carry.occ, carry.oflow, carry.rounds] + (
            [] if stop is None else [stop.reshape(-1)[0]])
        while True:
            occ, oflow, rounds, *halt = torch.stack(
                [w.long() for w in words]).tolist()
            if occ <= 0 or oflow or rounds >= limit or any(halt):
                return
            self._round_into(carry)

    # -- host drivers --------------------------------------------------------

    def _run_chunks(self, q, acc, max_occ: int, what: str,
                    max_rounds: int):
        """Run rounds from queue state ``q`` and ``acc`` to quiescence, in
        chunks that each end in ONE readback of six integers; ``max_occ``
        is the occupancy the run starts at.  ``acc`` is not changed; on
        the CPU ``q``'s tensors are updated in place.  The observability
        planes start fresh (zeroed outside the captured round).  Returns
        the final ``(q, acc)``."""
        obs = self._obs_init()
        if self.device.type == "cuda" and not self._host_rounds:
            carry, loop = self._device_loop(q, acc, obs)
            tree_copy_(carry.q, q)
            tree_copy_(carry.acc, acc)
            tree_copy_((carry.tp, carry.sp, carry.births), obs)
        else:
            loop = None
            carry = new_carry(q, tree_map(torch.clone, acc), self.device,
                              obs)
        carry.processed.zero_()
        carry.spawned.zero_()
        carry.max_occ.fill_(max_occ)
        carry.occ.copy_(self._occ_of(carry.q))

        def chunk_fn(limit):
            self._run_chunk(carry, loop, limit)
            occ, r, oflow, processed, spawned, max_occ = torch.stack(
                [carry.occ, carry.rounds, carry.oflow.to(torch.int32),
                 carry.processed, carry.spawned,
                 carry.max_occ]).tolist()                # THE host sync
            if loop is not None:
                loop.count(r)
            return occ, r, bool(oflow), processed, spawned, max_occ

        self._drive(chunk_fn, max_rounds, what, carry.tp, carry.sp)
        if loop is not None:         # the kept buffers serve the next run
            return tree_map(torch.clone, carry.q), tree_map(torch.clone,
                                                            carry.acc)
        return carry.q, carry.acc

    def _drive(self, chunk_fn, max_rounds: int, what: str, tp,
               sp) -> None:
        """``chunk_fn(limit)`` advances the state by up to ``limit`` rounds
        and returns (occupancy, rounds_delta, overflow, processed,
        spawned, max_occ) — one host sync per call.  Chunks are
        ``sync_every`` rounds long, or ``max_rounds`` with
        ``sync_every=0``, as in the reference; with spans on no chunk
        runs past ``span_round_cap``.  After each readback the trace plane
        ``tp`` and the span plane ``sp`` are drained into their
        collectors."""
        chunk = self.sync_every if self.sync_every > 0 else max_rounds
        rounds = host_syncs = 0
        while True:
            limit = min(chunk, max_rounds - rounds)
            if self.spans is not None:
                # no round past the cap writes a packed stamp
                limit = min(limit, self.span_round_cap - rounds)
            occ, r, oflow, processed, spawned, max_occ = chunk_fn(limit)
            rounds += r
            host_syncs += 1
            now = time.time()
            point = SyncPoint(rounds=rounds, occupancy=occ, wall_time=now,
                              host_syncs=host_syncs)
            self.sync_log.append(point)
            self.stats = {
                "rounds": rounds, "processed": processed, "spawned": spawned,
                "max_occupancy": max_occ, "drained": int(occ == 0),
                "host_syncs": host_syncs,
            }
            if self.telemetry is not None:
                self.telemetry.drain(tp, sync=host_syncs - 1, wall_time=now)
                self.telemetry.heartbeat(point)
                self.telemetry.finish(self.stats)
            if self.spans is not None:
                self.spans.drain(sp, wall_time=now)
                self.spans.finish(self.stats)
            if oflow:
                raise RuntimeError(
                    f"{what} overflow: occupancy {occ} + spawned children "
                    f"exceed capacity {self.capacity} at round {rounds} "
                    f"(raise capacity_log2 or lower the fanout)")
            if occ == 0:
                return
            if self.spans is not None and rounds >= self.span_round_cap:
                raise RuntimeError(
                    f"{what} span round clock reached the packed "
                    f"birth-stamp cap ({self.span_round_cap} rounds) with "
                    f"occupancy {occ}: stamps would wrap the "
                    f"(birth << 1) | 1 flag plane (run without spans or "
                    f"split the run)")
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"{what} round loop truncated at max_rounds="
                    f"{max_rounds} with occupancy {occ}: not quiescent "
                    f"(stats['drained']=0)")
