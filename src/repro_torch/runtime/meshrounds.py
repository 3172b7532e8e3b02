"""Mesh round engines — the FIFO half of ``repro/runtime/meshrounds.py``
as configurations of the port's engine core, on one card.

The reference runs each shard on its own device under ``shard_map``: a
round is a collective-free claim, each shard's step on its claimed
slice, and a publish that costs one psum.  Here the shard axis is the
leading dimension of the tensors: replicated state is held once,
sharded state is ``(S, ...)``, the psum's gather is the stacked rows and
a shard's ``axis_index`` is its row.  A round is

    claim (``ring_dequeue_wave``: one launch over the S x batch grid) →
    the user's step, once per shard in shard order, on that shard's row
    of the stacked acc and claim → [``wave_compact`` on each shard's row
    when the child rows are wider than the ring] → publish
    (``ring_enqueue_wave``: one launch over the S x n child grid)

with the reference's per-shard semantics, so the planes, head/tail,
stats and the shards' accumulators are the reference's, bit for bit.

* ``MeshRingEngine`` — the replicated ring (``core.distqueue.
  DistQueueState``): the claim splits ``min(occupancy, S * batch)``
  evenly over the shards (``claim_schedule``), the publish ranks every
  shard's children shard-major and suppresses the whole round on
  overflow.  With ``spans=`` its waves carry packed birth stamps in the
  enq-flag plane, as ``RingEngine``'s do (``run`` strips them), and the
  span plane is stacked, one a shard.
* ``ShardedMeshRingEngine`` — S rings of 2 * capacity / S slots
  (``DistShardedQueueState``): the claim drains the fullest rings first
  (``priority_claim_schedule``), the publish sprays rank r to ring
  ``r % S``.  Exact against the replicated engine on totals and
  order-insensitive accumulators; no spans (the reference's refusal).
* ``MeshRoundRunner`` — ``fused=True`` (default) delegates to either
  engine (``sharded=``); ``fused=False`` is the legacy loop: the same
  round issued from the host with one readback after each.

The core runs the round in its device loop on the card (one CUDA graph
launch a chunk, nothing read back between rounds) and in a Python loop
on the CPU.  Accumulators are per shard, returned stacked ``(S, ...)``
unless ``combine`` reduces them.  Overflow and truncation raise the
reference's ``RuntimeError`` at the readback after the flagged round.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.distqueue import (DistQueueState, DistShardedQueueState,
                              _compact_rows, dist_queue_init,
                              dist_sharded_queue_init)
from ..kernels._build import resolve_device
from ..kernels.compact import (compact_scratch, compact_scratch_words,
                               compact_width)
from ..kernels.ring_slots import (enq_planes, ring_dequeue_wave,
                                  ring_enqueue_wave)
from ..obs.spans import Spans
from ..obs.trace import Telemetry
from .enginecore import (EngineCore, ObsWave, _sds, register_engine,
                         tree_map, tree_to)
from .fusedrounds import IDX_BOT, StepFn

__all__ = ["MeshRingEngine", "MeshRoundRunner", "ShardedMeshRingEngine"]


def _stack(rows):
    """The per-shard trees ``rows`` stacked leaf by leaf under a leading
    shard axis."""
    first = rows[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(rows)
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in rows]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(x)) for x in zip(*rows)))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(x)) for x in zip(*rows))
    raise TypeError(f"unsupported tree node {type(first).__name__}")


def _tickets(base: int, n: int) -> np.ndarray:
    """``base + [0, n)`` as int32 tickets, wrapping mod 2^32."""
    t = (int(base) + np.arange(n, dtype=np.int64)) % (2 ** 32)
    return np.where(t >= 2 ** 31, t - 2 ** 32, t).astype(np.int32)


class _MeshFifoBase(EngineCore):
    """Shared FIFO-mesh scaffolding: the constructor's fields and checks,
    the per-shard step, the child rows' compaction and the acc's
    broadcast and combine."""

    def __init__(self, step_fn: StepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 device="cuda") -> None:
        self.step_fn = step_fn
        self.mesh = mesh
        self.axis = axis
        self.shards = int(mesh.shape[axis])
        self.capacity_log2 = capacity_log2
        self.capacity = 1 << capacity_log2
        self.nslots_log2 = capacity_log2 + 1
        self.batch = batch
        if batch * self.shards > self.capacity:
            raise ValueError(
                f"mesh batch {batch} x {self.shards} shards exceeds ring "
                f"capacity {self.capacity}")
        self.sync_every = sync_every
        self.combine = combine
        self.telemetry = telemetry
        self.spans = spans
        self.compact = compact
        self.device = resolve_device(device)
        self._compact_scratch = None
        # each lane's shard: the span class row without class_of
        self._shard_of = torch.arange(
            self.shards, dtype=torch.int32,
            device=self.device).repeat_interleave(batch)
        self._reset()

    def _initial_acc(self, acc):
        """``acc`` on the engine's device, one copy a shard (stacked)."""
        return tree_map(lambda x: x.expand((self.shards,) + x.shape).clone(),
                        tree_to(acc, self.device))

    def _finish(self, acc):
        return acc if self.combine is None else self.combine(acc)

    def _step(self, acc, vals, ok):
        """``step_fn`` once per shard, in shard order, on its row of the
        stacked acc and claim.  Returns the stacked acc and the (S, n)
        child rows (values int32, mask bool)."""
        accs, cvs, cms = [], [], []
        for s in range(self.shards):
            a, cv, cm = self.step_fn(tree_map(lambda x: x[s], acc), vals[s],
                                     ok[s])
            accs.append(a)
            cms.append(torch.broadcast_to(cm.bool(), cv.shape).reshape(-1))
            cvs.append(cv.reshape(-1).to(torch.int32))
        return _stack(accs), torch.stack(cvs), torch.stack(cms)

    def _wave(self, cv, cm):
        """The publish's children: the ballot over the flat rows, or (the
        dense-wave rule, rows wider than the ring) each row compacted by
        ``wave_compact``, on the engine's kept scratch on the card, with
        its true count."""
        wdth = compact_width(cv.shape[1], self.capacity, self.compact)
        if wdth is None:
            return cv.reshape(-1), dict(mask=cm.reshape(-1))
        scratch, n = None, cv.shape[1]
        if self.device.type == "cuda":
            scratch = self._compact_scratch
            if scratch is None or scratch.numel() < compact_scratch_words(n):
                scratch = self._compact_scratch = compact_scratch(
                    n, self.device)
        dense, counts = _compact_rows(cv, cm, wdth, scratch)
        return dense, dict(counts=counts)


class MeshRingEngine(_MeshFifoBase):
    """The replicated-ring FIFO mesh round engine: ``run`` mirrors
    ``RingEngine.run`` and returns ``(acc, final DistQueueState)`` with
    int head/tail, acc stacked ``(S, ...)`` unless ``combine`` reduces
    it.  Runs on ``device`` ("cuda" by default; "cpu" runs the kernels'
    plain versions)."""

    def __init__(self, step_fn: StepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 device="cuda") -> None:
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=device)
        n2 = 2 << capacity_log2
        self.registry.register("ring", (_sds((n2,)),) * 4
                               + (_sds(()), _sds(())))
        # the stamps pack into the enq-flag plane: no births plane
        self._register_obs_planes(self.shards, stacked=True)

    def _seed(self, st: DistQueueState, initial: np.ndarray
              ) -> DistQueueState:
        k = len(initial)
        if k > self.capacity:
            raise RuntimeError(
                f"mesh ring overflow: {k} seed values exceed capacity "
                f"{self.capacity} (raise capacity_log2)")
        if k == 0:
            return st
        dev = self.device
        cyc, saf, enq, idx, ok = enq_planes(
            *st[:4], torch.as_tensor(_tickets(int(st.tail), k), device=dev),
            torch.as_tensor(initial, device=dev), st.head,
            nslots_log2=self.nslots_log2, idx_bot=IDX_BOT,
            active=torch.ones(k, dtype=torch.bool, device=dev))
        assert bool(ok.all()), "exact tickets cannot miss"
        return DistQueueState(cyc, saf, enq, idx, tail=st.tail + k,
                              head=st.head)

    @staticmethod
    def _occ_of(q):
        return q.tail - q.head

    def _round(self, q, acc, live, sp=None, births=None):
        """claim (one launch) → the shards' steps → publish (one
        launch); head and tail advance in place, so the state returned is
        ``q``.  With spans the claim reads the consumed stamps and the
        publish stamps the shards' clock (one value: every shard ticks
        once a round)."""
        cyc, saf, enq, idx, tail, head = q
        kw = dict(nslots_log2=self.nslots_log2, idx_bot=IDX_BOT)
        claim = ring_dequeue_wave(cyc, saf, enq, idx, head, tail, live,
                                  batch=self.batch, shards=self.shards,
                                  birth_packed=sp is not None, **kw)
        vals, ok, k, pops = claim[:4]
        acc, cv, cm = self._step(acc, vals, ok)
        values, wave = self._wave(cv, cm)
        total, over, pushes = ring_enqueue_wave(
            cyc, saf, enq, idx, head, tail, values, live,
            capacity=self.capacity, shards=self.shards,
            birth_round=None if sp is None else sp.round[0], **wave, **kw)
        obs = None
        if self._observed:               # FIFO: payload extrema and refs
            flat = vals.reshape(-1)
            obs = ObsWave(flat, ok.reshape(-1), flat,
                          None if sp is None else claim[4].reshape(-1),
                          shards=self.shards, pops=pops, pushes=pushes,
                          occs=(tail - head).reshape(1).repeat(self.shards),
                          cls=self._shard_of)
        return q, acc, k, total, over, obs

    def run(self, initial: np.ndarray, acc: Any = None,
            max_rounds: int = 10_000) -> Tuple[Any, DistQueueState]:
        """Seed the replicated ring and run mesh rounds to quiescence, one
        readback a chunk (``sync_every`` rounds, or the whole run with
        ``sync_every=0``).  Bit-identical to the reference's engine and to
        the legacy loop: acc, planes, head/tail and stats.  Raises
        ``RuntimeError`` on ring overflow or truncation."""
        self._reset()
        initial = np.asarray(initial, np.int32).reshape(-1)
        st = self._seed(dist_queue_init(self.capacity, device=self.device),
                        initial)
        q, acc = self._run_chunks(st, self._initial_acc(acc), len(initial),
                                  "mesh ring", max_rounds)
        enqs = q.enqs if self.spans is None else q.enqs & 1
        return self._finish(acc), DistQueueState(
            q.cycles, q.safes, enqs, q.idxs, tail=int(q.tail),
            head=int(q.head))


class ShardedMeshRingEngine(_MeshFifoBase):
    """The per-shard-ring FIFO mesh round engine: S rings of 2 *
    capacity / S slots, ``(S, 2n_l)`` planes, (S,) heads and tails.  The
    claim is load-aware (fullest rings first), the publish sprays
    children round-robin by global rank.  Exact against the replicated
    engine on totals and order-insensitive accumulators; the claim order
    differs by design.  Spans are refused, as in the reference."""

    def __init__(self, step_fn: StepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 device="cuda") -> None:
        if spans is not None:
            raise ValueError(
                "sharded ring planes keep no replicated birth-stamp "
                "rider: spans needs the replicated mesh engine "
                "(sharded=False)")
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=device)
        self.local_capacity = self.capacity // self.shards
        self.lslots_log2 = (capacity_log2
                            - (self.shards.bit_length() - 1)) + 1
        n2 = 2 * self.local_capacity
        reg = self.registry
        # stacked shapes; bytes_per_shard divides the sharded group
        reg.register("ring", (_sds((self.shards, n2)),) * 4, sharded=True)
        reg.register("tickets", (_sds((self.shards,)), _sds((self.shards,))))
        self._register_obs_planes(self.shards, stacked=True)

    def _seed(self, st: DistShardedQueueState, initial: np.ndarray
              ) -> DistShardedQueueState:
        """Round-robin by seed rank into the rings (seed r to ring r %
        S)."""
        k = len(initial)
        if k > self.capacity:
            raise RuntimeError(
                f"sharded mesh ring overflow: {k} seed values exceed "
                f"capacity {self.capacity} (raise capacity_log2)")
        if k == 0:
            return st
        dev = self.device
        rows = [list(p) for p in st[:4]]
        tails = st.tails.clone()
        for s in range(self.shards):
            vals = initial[s::self.shards]
            c = len(vals)
            if c == 0:
                continue
            cyc, saf, enq, idx, ok = enq_planes(
                *(r[s] for r in rows),
                torch.as_tensor(_tickets(int(tails[s]), c), device=dev),
                torch.as_tensor(vals, device=dev), st.heads[s],
                nslots_log2=self.lslots_log2, idx_bot=IDX_BOT,
                active=torch.ones(c, dtype=torch.bool, device=dev))
            assert bool(ok.all()), "exact tickets cannot miss"
            for r, new in zip(rows, (cyc, saf, enq, idx)):
                r[s] = new
            tails[s] += c
        return DistShardedQueueState(*(torch.stack(r) for r in rows),
                                     tails=tails, heads=st.heads)

    @staticmethod
    def _occ_of(q):
        return (q.tails - q.heads).sum(dtype=torch.int32)

    def _round(self, q, acc, live, sp=None, births=None):
        """claim (one launch: the load-aware schedule and every shard's
        dequeues) → the shards' steps → publish (one launch: the ranks,
        the spray and the overflow test of every ring)."""
        cyc, saf, enq, idx, tails, heads = q
        kw = dict(nslots_log2=self.lslots_log2, idx_bot=IDX_BOT)
        vals, ok, k, pops = ring_dequeue_wave(cyc, saf, enq, idx, heads,
                                              tails, live, batch=self.batch,
                                              **kw)
        acc, cv, cm = self._step(acc, vals, ok)
        # a round spawning more than the global capacity overflows some
        # ring, where both waves install nothing
        values, wave = self._wave(cv, cm)
        total, over, assigned = ring_enqueue_wave(
            cyc, saf, enq, idx, heads, tails, values, live,
            capacity=self.local_capacity, **wave, **kw)
        obs = None
        if self._observed:
            flat = vals.reshape(-1)
            obs = ObsWave(flat, ok.reshape(-1), flat, None,
                          shards=self.shards, pops=pops, pushes=assigned,
                          occs=tails - heads, cls=self._shard_of)
        return q, acc, k, total, over, obs

    def run(self, initial: np.ndarray, acc: Any = None,
            max_rounds: int = 10_000) -> Tuple[Any, DistShardedQueueState]:
        """Seed the rings (round-robin by seed rank) and run to
        quiescence; the replicated engine's readback, overflow and
        truncation contract.  Returns (acc, the final state with
        stacked planes)."""
        self._reset()
        initial = np.asarray(initial, np.int32).reshape(-1)
        st = self._seed(dist_sharded_queue_init(self.capacity, self.shards,
                                                device=self.device),
                        initial)
        q, acc = self._run_chunks(st, self._initial_acc(acc), len(initial),
                                  "sharded mesh ring", max_rounds)
        return self._finish(acc), q


class MeshRoundRunner(_MeshFifoBase):
    """Mesh twin of ``RoundRunner``: ``fused=True`` (default) delegates
    to ``MeshRingEngine`` (``ShardedMeshRingEngine`` with
    ``sharded=True``); ``fused=False`` keeps the legacy loop: the
    replicated engine's round issued from the host with one readback
    after it (``host_syncs == rounds``; an empty run reads back once, as
    the fused engine's does).  Fused and legacy are bit-identical on the
    replicated ring."""

    def __init__(self, step_fn: StepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 fused: bool = True, sharded: bool = False,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 device="cuda") -> None:
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=device)
        self.fused = fused
        self.sharded = sharded
        if spans is not None and not fused:
            raise ValueError(
                "span planes are in-loop state: spans needs the fused "
                "engine (fused=True)")
        if sharded and not fused:
            raise ValueError(
                "sharded rings are a fused-engine configuration (the "
                "per-shard planes live in the megaround carry): use "
                "fused=True")
        self._engine = None
        if fused:
            cls = ShardedMeshRingEngine if sharded else MeshRingEngine
            self._engine = cls(
                step_fn, mesh=mesh, axis=axis, capacity_log2=capacity_log2,
                batch=batch, sync_every=sync_every, combine=combine,
                telemetry=telemetry, spans=spans, compact=compact,
                device=self.device)

    # the legacy loop runs the replicated engine's round and seed
    _seed = MeshRingEngine._seed
    _round = MeshRingEngine._round
    _occ_of = staticmethod(MeshRingEngine._occ_of)

    def loop_carry_bytes(self, shards: int = None) -> int:
        # the fused engine owns the plane registry; the legacy loop
        # carries nothing between rounds
        if self._engine is not None:
            return self._engine.loop_carry_bytes(shards)
        return super().loop_carry_bytes(shards)

    def run(self, initial: np.ndarray, acc: Any = None,
            max_rounds: int = 10_000) -> Tuple[Any, DistQueueState]:
        """Run to quiescence on the selected engine.  ``fused=True``: the
        engine's contract (one readback a chunk); ``fused=False``: one
        readback a round.  Both bit-deterministic; both raise on overflow
        or truncation."""
        if self._engine is not None:
            try:
                return self._engine.run(initial, acc, max_rounds)
            finally:
                self.stats = dict(self._engine.stats, fused=1)
                self.sync_log = self._engine.sync_log
        self._reset()
        initial = np.asarray(initial, np.int32).reshape(-1)
        q = self._seed(dist_queue_init(self.capacity, device=self.device),
                       initial)
        acc = self._initial_acc(acc)
        live = torch.ones((), dtype=torch.bool, device=self.device)
        run = dict(occ=len(initial), processed=0, spawned=0,
                   max_occ=len(initial))

        def chunk_fn(limit):
            """One round issued from the host and ONE readback after it
            (``host_syncs == rounds``); returns the running totals."""
            nonlocal q, acc
            if limit < 1 or run["occ"] == 0:
                return (run["occ"], 0, False, run["processed"],
                        run["spawned"], run["max_occ"])
            q, acc, k, total, over = self._round(q, acc, live)[:5]
            occ, k, total, over = torch.stack(
                [self._occ_of(q).to(torch.int32), k.to(torch.int32),
                 total.to(torch.int32), over.to(torch.int32)]).tolist()
            run.update(occ=occ, processed=run["processed"] + k,
                       spawned=run["spawned"] + total,
                       max_occ=max(run["max_occ"], occ))
            return (occ, 1, bool(over), run["processed"], run["spawned"],
                    run["max_occ"])

        try:
            self._drive(chunk_fn, max_rounds, "mesh ring")
        finally:
            self.stats = dict(self.stats, fused=0)
        return self._finish(acc), DistQueueState(
            q.cycles, q.safes, q.enqs, q.idxs, tail=int(q.tail),
            head=int(q.head))


# engine-matrix rows
register_engine("mesh", MeshRoundRunner, priority=False, mesh=True)
register_engine("mesh-sharded", MeshRoundRunner, priority=False, mesh=True,
                kwargs={"sharded": True}, spans_ok=False)
