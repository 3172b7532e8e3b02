"""Mesh round engines — ``repro/runtime/meshrounds.py`` as configurations
of the port's engine core, on one card or one shard a process.

The reference runs each shard on its own device under ``shard_map``: a
round is a collective-free claim, each shard's step on its claimed
slice, and a publish that costs one psum.  On one card the shard axis is
the leading dimension of the tensors: replicated state is held once,
sharded state is ``(S, ...)``, the psum's gather is the stacked rows and
a shard's ``axis_index`` is its row.  A FIFO round is

    claim (``ring_dequeue_wave``: one launch over the S x batch grid) →
    the user's step, once per shard in shard order, on that shard's row
    of the stacked acc and claim → [``wave_compact`` on each shard's row
    when the child rows are wider than the ring] → publish
    (``ring_enqueue_wave``: one launch over the S x n child grid)

and a priority round is

    claim schedule (tensor ops on the carried sizes and hints) → pop
    wave (``heap_apply_grid``: one launch, a block a heap) → the step, a
    shard at a time → publish (the stacked child rows, their ranks, the
    overflow test and each child's heap, tensor ops, with ``wave_compact``
    on each row under the dense-wave rule) → insert wave
    (``heap_apply_grid``: one launch)

with the reference's per-shard semantics, so the planes, head/tail or
sizes and hints, stats and the shards' accumulators are the reference's,
bit for bit.

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
* ``MeshHeapEngine`` — the priority mesh (``core.distqueue.
  DistHeapState``).  ``relaxed=True``: one heap a shard, ``(S, cap)``
  planes with ``(S,)`` sizes and min-key hints in the carry; the claim
  is ``priority_claim_schedule`` (the remainder to the lowest hints),
  child rank r goes to heap ``r % S`` and the whole round is suppressed
  when any heap would overflow.  ``relaxed=False``: one heap popped
  ``S * batch`` wide in exact min-key order, shard s stepping its
  ``claim_schedule`` slice, every child installed.  ``split=True``
  carries a third plane (``aux``, the split-payload words) through the
  heaps as ``heap_apply``'s rider.
* ``PriorityMeshRoundRunner`` — ``fused=True`` delegates to
  ``MeshHeapEngine``; ``fused=False`` is the legacy loop, which with
  ``trace=True`` records each round's pops and pushes.

The core runs the round in its device loop on the card (one CUDA graph
launch a chunk, nothing read back between rounds) and in a Python loop
on the CPU.  Accumulators are per shard, returned stacked ``(S, ...)``
unless ``combine`` reduces them.  Overflow and truncation raise the
reference's ``RuntimeError`` at the readback after the flagged round.

Across processes (``mesh=make_mesh((S,), ("data",), group=...)``, one
shard a rank) every engine runs the reference's per-shard program: the
rank steps its own claim row once a round, and the round's one psum is
one ``all_reduce`` of the rank's row (``distributed.mesh_round_gather``:
the child rows, their mask or compacted counts, and the meta words).
Replicated state (the replicated ring, the strict heap, heads and tails,
sizes and hints, the trace plane) is held whole on every rank and
advanced by the same kernels over the gathered grid; sharded state (the
sharded rings, the relaxed heaps) is this rank's ring or heap alone,
which the ring waves address by ``ring=`` and a heap wave takes as a
grid of one heap.  The relaxed heaps' post-pop hints and sizes and,
with telemetry, every shard's popped-key extrema ride the exchange as
the reference's meta block.  Every rank
calls ``run`` with the same arguments and gets the same result: the
accumulators and the sharded planes are gathered once at the end
(``distributed.gather_rows``).  The rounds are issued from the host
over either backend, each after one readback of the loop's replicated
condition (``EngineCore._run_chunk``).  Spans need the replicated ring
there, and the legacy trace recorder needs one card.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.distqueue import (DistHeapState, DistQueueState,
                              DistShardedQueueState, _compact_grid,
                              _compact_rows, dist_heap_init, dist_queue_init,
                              dist_sharded_queue_init)
from ..distributed.collectives import gather_rows, mesh_round_gather
from ..kernels._build import resolve_device
from ..kernels.compact import (compact_scratch, compact_scratch_words,
                               compact_width)
from ..kernels.heap_batch import KEY_INF as HEAP_KEY_INF, heap_apply_grid
from ..kernels.ring_slots import (claim_schedule, enq_planes,
                                  priority_claim_schedule, ring_dequeue_wave,
                                  ring_enqueue_wave)
from ..obs.spans import Spans
from ..obs.trace import SyncPoint, Telemetry, masked_min_max
from .enginecore import (EngineCore, ObsWave, _sds, register_engine,
                         tree_map, tree_to)
from .fusedrounds import IDX_BOT, PriorityStepFn, StepFn

__all__ = ["MeshHeapEngine", "MeshRingEngine", "MeshRoundRunner",
           "PriorityMeshRoundRunner", "ShardedMeshRingEngine"]


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


class _MeshBase(EngineCore):
    """Scaffolding of every mesh engine: the constructor's fields, the
    per-shard step, the child rows' compaction on a kept scratch, the
    acc's broadcast and combine, and the legacy loop."""

    def __init__(self, step_fn, *, mesh, axis: str = "data",
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
        # this process's shard on a group-bound mesh (one shard a rank)
        self.rank = mesh.rank
        if self.rank is not None and mesh.size != self.shards:
            raise ValueError(
                f"a group-bound mesh runs one shard a rank: axis {axis!r} "
                f"has {self.shards} shards but the group {mesh.size} ranks")
        self.capacity_log2 = capacity_log2
        self.capacity = 1 << capacity_log2
        self.batch = batch
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

    def _initial_acc(self, acc):
        """``acc`` on the engine's device, one copy a shard (stacked), or
        this rank's one copy on a group-bound mesh."""
        if self.rank is not None:
            return tree_map(torch.clone, tree_to(acc, self.device))
        return tree_map(lambda x: x.expand((self.shards,) + x.shape).clone(),
                        tree_to(acc, self.device))

    def _finish(self, acc):
        """The run's accumulators, stacked (every rank's gathered once on
        a group-bound mesh), then ``combine``d."""
        if self.rank is not None:
            acc = gather_rows(acc, self.mesh)
        return acc if self.combine is None else self.combine(acc)

    def _exchange(self, blocks):
        """The round's one collective on a group-bound mesh: this rank's
        (W_i,) blocks to (S, W_i) gathered blocks."""
        return mesh_round_gather(blocks, self.mesh)

    def _pop_meta(self, keys, valid):
        """With telemetry, this rank's claim extrema as a (2,) meta block
        for the exchange (the reference's ``pop_meta``), else ()."""
        if self.telemetry is None:
            return ()
        return (torch.stack(masked_min_max(keys, valid)),)

    def _extrema_wave(self, ext, pops, pushes, occs):
        """The trace record's wave from the gathered claim extrema ``ext``
        (S, 2): each shard's (min, max) as two lanes, valid where it
        claimed, so the record's extrema are the whole grid's."""
        keys = ext.reshape(-1).contiguous()
        valid = (ext[:, 0] <= ext[:, 1]).repeat_interleave(2)
        return ObsWave(keys, valid, keys, None, shards=self.shards,
                       pops=pops, pushes=pushes, occs=occs)

    def _step(self, acc, *rows):
        """``step_fn`` once per shard, in shard order, on its row of the
        stacked acc and of each claim row in ``rows`` ((S, batch) each).
        The step returns ``(acc, *child planes, child mask)``.  Returns
        the stacked acc, the (S, n) child planes (int32) and the (S, n)
        bool mask (broadcast to the first plane's shape).  On a
        group-bound mesh the step runs once, on this rank's acc and (batch,)
        rows, and the planes and mask are its (n,) row."""
        if self.rank is not None:
            out = self.step_fn(acc, *rows)
            children = out[1:-1]
            cm = torch.broadcast_to(out[-1].bool(), children[0].shape)
            return (out[0], tuple(c.reshape(-1).to(torch.int32)
                                  for c in children), cm.reshape(-1))
        accs, planes, cms = [], [], []
        for s in range(self.shards):
            out = self.step_fn(tree_map(lambda x: x[s], acc),
                               *(r[s] for r in rows))
            accs.append(out[0])
            children = out[1:-1]
            cms.append(torch.broadcast_to(out[-1].bool(),
                                          children[0].shape).reshape(-1))
            planes.append([c.reshape(-1).to(torch.int32) for c in children])
        return (_stack(accs), tuple(torch.stack(p) for p in zip(*planes)),
                torch.stack(cms))

    def _scratch(self, n):
        """The engine's look-back scratch for ``wave_compact`` on rows of
        ``n`` lanes (the card; None on the CPU), kept across rounds."""
        if self.device.type != "cuda":
            return None
        scratch = self._compact_scratch
        if scratch is None or scratch.numel() < compact_scratch_words(n):
            scratch = self._compact_scratch = compact_scratch(n, self.device)
        return scratch

    def _legacy(self, q, acc, occ0: int, what: str, max_rounds: int,
                round_fn):
        """The legacy loop, the reference's ``_legacy_loop``:
        ``round_fn(q, acc, live)`` (returning ``(q, acc, k, total,
        over)``) issued from the host while the occupancy is positive and
        fewer than ``max_rounds`` rounds ran, ONE readback after each
        round and none where no round runs (``host_syncs == rounds``; an
        empty run logs no sync point).  Returns the final ``(q, acc)``;
        raises the engine's overflow and truncation errors."""
        live = torch.ones((), dtype=torch.bool, device=self.device)
        rounds = processed = spawned = 0
        occ = max_occ = occ0
        overflow = False
        while occ > 0 and rounds < max_rounds:
            q, acc, k, total, over = round_fn(q, acc, live)
            occ, k, total, over = torch.stack(
                [self._occ_of(q).to(torch.int32), k.to(torch.int32),
                 total.to(torch.int32), over.to(torch.int32)]).tolist()
            rounds += 1
            processed += k
            spawned += total
            max_occ = max(max_occ, occ)
            self.sync_log.append(SyncPoint(rounds=rounds, occupancy=occ,
                                           wall_time=time.time(),
                                           host_syncs=rounds))
            if over:
                overflow = True
                break
        self.stats = {"rounds": rounds, "processed": processed,
                      "spawned": spawned, "max_occupancy": max_occ,
                      "drained": int(occ == 0), "host_syncs": rounds,
                      "fused": 0}
        if overflow:
            raise RuntimeError(
                f"{what} overflow: occupancy {occ} + spawned children "
                f"exceed capacity {self.capacity} at round {rounds} (raise "
                f"capacity_log2 or lower the fanout)")
        if occ > 0:
            raise RuntimeError(
                f"{what} round loop truncated at max_rounds={max_rounds} "
                f"with occupancy {occ}: not quiescent "
                f"(stats['drained']=0)")
        return q, acc


class _MeshFifoBase(_MeshBase):
    """The FIFO mesh's constructor check and its publish wave."""

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
        self.nslots_log2 = capacity_log2 + 1
        if batch * self.shards > self.capacity:
            raise ValueError(
                f"mesh batch {batch} x {self.shards} shards exceeds ring "
                f"capacity {self.capacity}")
        self._reset()

    def _wave(self, cv, cm):
        """The publish's children: the ballot over the flat rows, or (the
        dense-wave rule, rows wider than the ring) each row compacted by
        ``wave_compact``, on the engine's kept scratch on the card, with
        its true count."""
        wdth = compact_width(cv.shape[1], self.capacity, self.compact)
        if wdth is None:
            return cv.reshape(-1), dict(mask=cm.reshape(-1))
        dense, counts = _compact_rows(cv, cm, wdth,
                                      self._scratch(cv.shape[1]))
        return dense, dict(counts=counts)

    def _wave_group(self, cv, cm, meta=()):
        """``_wave`` on a group-bound mesh: this rank's (n,) child row (or
        its ``wave_compact`` compaction and true count) and the ``meta``
        blocks, gathered in the round's one collective.  Returns the
        wave's (values, mode) and the gathered meta (S, W) or None."""
        n = cv.shape[0]
        wdth = compact_width(n, self.capacity, self.compact)
        if wdth is None:
            g = self._exchange((cv, cm.to(torch.int32)) + meta)
            wave = dict(mask=g[1].reshape(-1) > 0)
            values = g[0].reshape(-1)
        else:
            dense, count = _compact_rows(cv[None], cm[None], wdth,
                                         self._scratch(n))
            g = self._exchange((dense[0], count) + meta)
            wave = dict(counts=g[1].reshape(-1).contiguous())
            values = g[0].contiguous()
        return values, wave, (g[2] if meta else None)


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
        if self.rank is None:
            acc, (cv,), cm = self._step(acc, vals, ok)
            values, wave = self._wave(cv, cm)
        else:                   # the grid is replicated: step this row
            acc, (cv,), cm = self._step(acc, vals[self.rank],
                                        ok[self.rank])
            values, wave, _ = self._wave_group(cv, cm)
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
        S); on a group-bound mesh this rank installs its own ring's seeds
        and every rank advances every tail."""
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
            tails[s] += c
            if self.rank is not None and s != self.rank:
                continue
            row = s if self.rank is None else 0
            cyc, saf, enq, idx, ok = enq_planes(
                *(r[row] for r in rows),
                torch.as_tensor(_tickets(int(tails[s]) - c, c), device=dev),
                torch.as_tensor(vals, device=dev), st.heads[s],
                nslots_log2=self.lslots_log2, idx_bot=IDX_BOT,
                active=torch.ones(c, dtype=torch.bool, device=dev))
            assert bool(ok.all()), "exact tickets cannot miss"
            for r, new in zip(rows, (cyc, saf, enq, idx)):
                r[row] = new
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
        kw = dict(nslots_log2=self.lslots_log2, idx_bot=IDX_BOT,
                  ring=self.rank)
        vals, ok, k, pops = ring_dequeue_wave(cyc, saf, enq, idx, heads,
                                              tails, live, batch=self.batch,
                                              **kw)
        if self.rank is None:
            acc, (cv,), cm = self._step(acc, vals, ok)
            # a round spawning more than the global capacity overflows
            # some ring, where both waves install nothing
            values, wave = self._wave(cv, cm)
        else:                   # this rank's ring: its (1, batch) row
            acc, (cv,), cm = self._step(acc, vals[0], ok[0])
            values, wave, ext = self._wave_group(
                cv, cm, self._pop_meta(vals[0], ok[0]))
        total, over, assigned = ring_enqueue_wave(
            cyc, saf, enq, idx, heads, tails, values, live,
            capacity=self.local_capacity, **wave, **kw)
        obs = None
        if self._observed and self.rank is not None:
            obs = self._extrema_wave(ext, pops, assigned, tails - heads)
        elif self._observed:
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
                                                device=self.device,
                                                rank=self.rank),
                        initial)
        q, acc = self._run_chunks(st, self._initial_acc(acc), len(initial),
                                  "sharded mesh ring", max_rounds)
        if self.rank is not None:     # every rank's ring, gathered once
            q = q._replace(**{f: p.reshape(self.shards, -1) for f, p in zip(
                q._fields[:4], gather_rows(tuple(q[:4]), self.mesh))})
        return self._finish(acc), q


class MeshRoundRunner(_MeshFifoBase):
    """Mesh twin of ``RoundRunner``: ``fused=True`` (default) delegates
    to ``MeshRingEngine`` (``ShardedMeshRingEngine`` with
    ``sharded=True``); ``fused=False`` keeps the legacy loop: the
    replicated engine's round issued from the host with one readback
    after it (``host_syncs == rounds``; an empty run reads nothing back,
    as the reference's legacy loop).  Fused and legacy are bit-identical
    on the replicated ring."""

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
        q, acc = self._legacy(q, self._initial_acc(acc), len(initial),
                              "mesh ring", max_rounds,
                              lambda q, acc, live: self._round(
                                  q, acc, live)[:5])
        return self._finish(acc), DistQueueState(
            q.cycles, q.safes, q.enqs, q.idxs, tail=int(q.tail),
            head=int(q.head))


class _PriorityMeshBase(_MeshBase):
    """The priority mesh's seeding and one-round bodies.  ``relaxed=True``
    keeps one heap a shard with hint-ordered claim rebalancing;
    ``relaxed=False`` one heap popped in exact global min-key order."""

    def __init__(self, step_fn: PriorityStepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 arity_log2: int = 2, relaxed: bool = True,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 split: bool = False, device="cuda") -> None:
        if split and spans is not None:
            raise ValueError(
                "split payloads ride the heap's rider plane, which spans "
                "already uses for birth stamps: spans and split are "
                "mutually exclusive")
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         device=device)
        if spans is not None and self.rank is not None:
            raise ValueError(
                "span planes of a priority mesh across processes are not "
                "gathered: spans on a group-bound mesh need the replicated "
                "FIFO ring")
        self.arity_log2 = arity_log2
        self.relaxed = relaxed
        self.split = split
        if relaxed and batch > self.capacity:
            raise ValueError(
                f"batch {batch} exceeds per-shard heap capacity "
                f"{self.capacity}")
        if not relaxed and batch * self.shards > self.capacity:
            raise ValueError(
                f"mesh batch {batch} x {self.shards} shards exceeds heap "
                f"capacity {self.capacity}")
        self.hints = None                # the relaxed run's final hints
        self._reset()

    def _heap(self, planes, sizes, rider=None, **wave):
        """One ``heap_apply_grid`` wave on stacked ``planes`` (keys, vals)
        and ``sizes``, in place.  A relaxed mesh on a group-bound mesh
        holds this rank's heap beside all S sizes: the wave is a grid of
        one heap on the views of this rank's size word and count, its
        ``dest`` remapped to 0 for this rank's lanes and -1 elsewhere."""
        me = self.rank
        if self.relaxed and me is not None:
            sizes = sizes[me:me + 1]
            if wave.get("counts") is not None:
                wave["counts"] = wave["counts"][me:me + 1]
            else:
                d = wave["dest"]
                wave["dest"] = torch.where(d == me, 0, -1).to(d.dtype)
        return heap_apply_grid(*planes, sizes, cap_log2=self.capacity_log2,
                               arity_log2=self.arity_log2, rider=rider,
                               **wave)

    # -- seeding --------------------------------------------------------------

    def _seed(self, ik: np.ndarray, iv: np.ndarray, ia=None):
        """Install the seed (key, val) pairs in one insert wave.  Relaxed
        mode sprays them by seed rank (``rank % shards``) into the
        per-shard heaps and returns ``(keys (S, cap), vals (S, cap), sizes
        (S,), hints (S,))``, each hint its heap's least key; strict mode
        fills the one heap and returns ``(keys, vals, size)``.  In split
        mode ``ia`` carries per-seed aux words, installed through the
        rider plane, which trails the tuple."""
        k, s, dev = len(ik), self.shards, self.device
        if not self.relaxed:
            if k > self.capacity:
                raise RuntimeError(
                    f"mesh heap overflow: {k} seed values exceed capacity "
                    f"{self.capacity} (raise capacity_log2)")
            dest, heaps = np.zeros(k, np.int32), 1
        else:
            worst = -(-k // s)
            if worst > self.capacity:
                raise RuntimeError(
                    f"mesh heap overflow: {worst} seed values land on one "
                    f"shard, exceeding per-shard capacity {self.capacity} "
                    f"(raise capacity_log2)")
            dest, heaps = (np.arange(k) % s).astype(np.int32), s
        group = self.relaxed and self.rank is not None
        st = dist_heap_init(self.capacity, shards=1 if group else heaps,
                            device=dev)
        if group:                # this rank's heap beside all S sizes
            st = st._replace(size=torch.zeros(s, dtype=torch.int32,
                                              device=dev))
        aux = torch.zeros_like(st.keys) if self.split else None
        if k:
            t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
            self._heap(st[:2], st.size, aux, opkeys=t(ik), opvals=t(iv),
                       dest=t(dest), oprider=None if ia is None else t(ia))
        if group:
            # every heap's size and least key, from the seeds every rank
            # holds
            hints = np.full(s, HEAP_KEY_INF, np.int64)
            np.minimum.at(hints, dest, ik)
            st.size.copy_(torch.as_tensor(np.bincount(dest, minlength=s)))
            q = (*st, torch.as_tensor(hints.astype(np.int32), device=dev))
        elif self.relaxed:
            # a heap's least key is its root (empty slots hold KEY_INF)
            q = (*st, st.keys[:, 0].clone())
        else:
            q = (st.keys[0], st.vals[0], st.size[0])
            aux = None if aux is None else aux[0]
        return q + (() if aux is None else (aux,))

    def _occ_of(self, q):
        return q[2].sum(dtype=torch.int32) if self.relaxed else q[2]

    def _round(self, q, acc, live, sp=None, births=None, trace=False):
        """One round (``EngineCore``'s contract).  ``trace=True`` (the
        legacy recorder) appends the round's pops ``(keys, vals, ok)``
        (S, batch) and gathered pushes ``(keys, vals, active)``."""
        body = self._round_relaxed if self.relaxed else self._round_strict
        out = body(q, acc, live, sp, births)
        return out if trace else out[:6]

    def _publish(self, ck, cv, ca, cm, bound):
        """The gathered children of ``dist_priority_publish_round`` (or of
        its compact form under the dense-wave rule for ``bound`` installs a
        round) without its meta block: on one card the hints and sizes it
        would carry are the engine's own.  The child planes (keys,
        payloads[, aux]) flattened shard-major with their ranks (the
        exclusive prefix of the mask) and total, or each row compacted by
        ``wave_compact`` with the ranks rebuilt from the true counts.
        Returns ``(gk, gv, gaux, active, ranks, total, width)``."""
        planes = (ck, cv) + (() if ca is None else (ca,))
        wdth = compact_width(ck.shape[1], bound, self.compact)
        if wdth is None:
            gm = (cm > 0).reshape(-1).to(torch.int32)
            active, total = gm > 0, gm.sum(dtype=torch.int32)
            ranks = torch.cumsum(gm, 0, dtype=torch.int32) - gm
        else:
            planes, counts = _compact_rows(planes, cm, wdth,
                                           self._scratch(ck.shape[1]))
            active, ranks = _compact_grid(counts, wdth)
            ranks, total = ranks.to(torch.int32), counts.sum(dtype=torch.int32)
        g = [p.reshape(-1).to(torch.int32) for p in planes] + [None]
        return g[0], g[1], g[2], active, ranks, total, wdth

    def _spray_children(self, gk, gactive, ranks, total, wdth, sizes,
                        hints):
        """The relaxed publish's spray of child rank r to heap ``r % S``
        over the gathered children, given every heap's post-pop
        ``sizes`` and least key ``hints``: (each heap's children, the
        round's overflow flag (any heap past capacity), the new hints,
        each lane's heap, -1 where it installs nowhere)."""
        s = self.shards
        shard_of = torch.where(gactive, ranks % s, s)
        if wdth is None:
            assigned = torch.zeros(s + 1, dtype=torch.int32,
                                   device=gk.device).scatter_add_(
                0, shard_of.long(), torch.ones_like(shard_of))[:s]
        else:
            # the ranks are the prefix 0 .. total - 1: the closed form of
            # the scatter, exact from the true total even where a row's
            # lanes were clamped (only when over)
            s_ix = torch.arange(s, dtype=torch.int32, device=gk.device)
            assigned = total // s + (s_ix < total % s).int()
        over = (sizes + assigned > self.capacity).any()
        ckmin = torch.full((s + 1,), HEAP_KEY_INF, dtype=torch.int32,
                           device=gk.device).scatter_reduce_(
            0, shard_of.long(), torch.where(gactive, gk, HEAP_KEY_INF),
            "amin")[:s]
        new_hints = torch.where(over, hints, torch.minimum(hints, ckmin))
        dest = torch.where(gactive & ~over, shard_of, -1).int()
        return assigned, over, new_hints, dest

    def _publish_group(self, children, cm, bound, meta):
        """``_publish`` on a group-bound mesh, with the reference's meta
        block: this rank's (n,) child planes under ``cm`` (or their
        ``wave_compact`` compaction, the true count inserted as the meta
        block's third word) and its ``meta`` words, gathered in the
        round's one collective.  Returns ``(gk, gv, gaux, active, ranks,
        total, width, gmeta (S, W))``."""
        planes = children[:3 if self.split else 2]
        n = planes[0].shape[0]
        meta = list(meta)
        wdth = compact_width(n, bound, self.compact)
        if wdth is None:
            mask = (cm > 0).to(torch.int32)
            g = self._exchange(planes + (mask,) + (
                (torch.stack(meta),) if meta else ()))
            gm = g[len(planes)].reshape(-1)
            active, total = gm > 0, gm.sum(dtype=torch.int32)
            ranks = torch.cumsum(gm, 0, dtype=torch.int32) - gm
            gp = g[:len(planes)]
        else:
            dense, count = _compact_rows(tuple(p[None] for p in planes),
                                         cm[None], wdth, self._scratch(n))
            meta.insert(min(2, len(meta)), count[0])
            g = self._exchange(tuple(d[0] for d in dense)
                               + (torch.stack(meta),))
            counts = g[-1][:, min(2, len(meta) - 1)]
            active, ranks = _compact_grid(counts, wdth)
            ranks, total = ranks.to(torch.int32), counts.sum(dtype=torch.int32)
            gp = g[:-1]
        gp = [p.reshape(-1) for p in gp] + [None]
        return gp[0], gp[1], gp[2], active, ranks, total, wdth, g[-1]

    def _round_relaxed_group(self, q, acc, live):
        """``_round_relaxed`` on a group-bound mesh: the claim schedule
        over the replicated sizes and hints → the pop wave on this rank's
        heap → its step → the exchange of its children with its post-pop
        (hint, size) and, with telemetry, its claim extrema → the spray
        and overflow test over the gathered grid → the insert wave of
        this rank's children; the sizes and hints advance on every rank
        alike."""
        s, batch, me = self.shards, self.batch, self.rank
        keys, vals, sizes, hints = q[:4]
        aux = q[4] if self.split else None
        counts = torch.where(live, priority_claim_schedule(
            sizes.sum(dtype=torch.int32), s, batch, hints, sizes), 0)
        pop = self._heap((keys, vals), sizes, aux, counts=counts,
                         batch=batch)
        outk, outv, ok = (x[0] for x in pop[3:6])
        rows = (outk, outv) + ((pop[7][0],) if self.split else ()) + (ok,)
        acc, children, cm = self._step(acc, *rows)
        cm = cm & live
        meta = [keys[0, 0], sizes[me]] + list(
            self._pop_meta(outk, ok)[0] if self.telemetry is not None
            else ())
        gk, gv, gaux, gactive, ranks, total, wdth, gmeta = (
            self._publish_group(children, cm, s * self.capacity, meta))
        sizes_pop = gmeta[:, 1]
        assigned, over, new_hints, dest = self._spray_children(
            gk, gactive, ranks, total, wdth, sizes_pop, gmeta[:, 0])
        self._heap((keys, vals), sizes, aux, opkeys=gk, opvals=gv,
                   dest=dest, oprider=gaux if self.split else None)
        pushes = torch.where(over, 0, assigned)
        sizes.copy_(sizes_pop + pushes)
        obs = None
        if self._observed:
            obs = self._extrema_wave(gmeta[:, -2:], counts, pushes, sizes)
        q = (keys, vals, sizes, new_hints) + q[4:]
        return (q, acc, counts.sum(dtype=torch.int32),
                torch.where(over, 0, total), over, obs, None)

    def _round_relaxed(self, q, acc, live, sp, births):
        """claim (the hint-ordered schedule over the carried sizes and
        hints) → pop wave on every shard's heap (one launch) → the shards'
        steps → publish → the spray of child rank r to heap ``r % S``,
        suppressed whole when any heap would overflow → insert wave (one
        launch).  The sizes advance in place; the new hints are returned.
        With spans the births plane rides the heaps as their rider (split
        mode: the aux plane)."""
        s, batch = self.shards, self.batch
        keys, vals, sizes, hints = q[:4]
        aux = q[4] if self.split else None
        rider = aux if self.split else births
        if self.rank is not None:
            return self._round_relaxed_group(q, acc, live)
        counts = torch.where(live, priority_claim_schedule(
            sizes.sum(dtype=torch.int32), s, batch, hints, sizes), 0)
        pop = self._heap((keys, vals), sizes, rider, counts=counts,
                         batch=batch)
        outk, outv, ok = pop[3:6]
        bout = None if rider is None else pop[7]
        rows = (outk, outv) + ((bout,) if self.split else ()) + (ok,)
        acc, children, cm = self._step(acc, *rows)
        cm = cm & live
        gk, gv, gaux, gactive, ranks, total, wdth = self._publish(
            children[0], children[1], children[2] if self.split else None,
            cm, s * self.capacity)
        # each heap's root after the pops
        assigned, over, new_hints, dest = self._spray_children(
            gk, gactive, ranks, total, wdth, sizes, keys[:, 0])
        self._heap((keys, vals), sizes, rider, opkeys=gk, opvals=gv,
                   dest=dest, oprider=gaux if self.split else (
                       None if sp is None else sp.round[0]))
        pushes = torch.where(over, 0, assigned)
        obs = None
        if self._observed:
            obs = ObsWave(outk.reshape(-1), ok.reshape(-1), outv.reshape(-1),
                          None if sp is None else bout.reshape(-1),
                          shards=s, pops=counts, pushes=pushes, occs=sizes,
                          cls=self._shard_of)
        q = (keys, vals, sizes, new_hints) + q[4:]
        return (q, acc, counts.sum(dtype=torch.int32),
                torch.where(over, 0, total), over, obs,
                (outk, outv, ok, gk, gv, gactive))

    def _round_strict(self, q, acc, live, sp, births):
        """pop ``min(size, S * batch)`` roots of the one heap (one launch)
        → shard s steps its ``claim_schedule`` slice → publish → every
        child installed unless the heap would overflow (one launch).  With
        spans every shard records only its own slice of the pops."""
        s, batch = self.shards, self.batch
        keys, vals, size = q[:3]
        aux = q[3] if self.split else None
        rider = aux if self.split else births
        rows1 = lambda t: None if t is None else t.view(1, -1)  # noqa: E731
        planes, size1 = (rows1(keys), rows1(vals)), size.view(1)
        k = torch.where(live, torch.clamp(size, max=s * batch), 0)
        pop = self._heap(planes, size1, rows1(rider), counts=k.view(1),
                         batch=s * batch)
        active, ranks = claim_schedule(k, s, batch)
        act = active.view(s, batch)
        ix = ranks.view(s, batch)
        outk = torch.where(act, pop[3][0][ix], HEAP_KEY_INF)
        outv = torch.where(act, pop[4][0][ix], -1)
        outb = None if rider is None else torch.where(act, pop[7][0][ix], 0)
        rows = (outk, outv) + ((outb,) if self.split else ()) + (act,)
        if self.rank is None:
            acc, children, cm = self._step(acc, *rows)
            cm = cm & live
            gk, gv, gaux, gactive, _, total, _ = self._publish(
                children[0], children[1],
                children[2] if self.split else None, cm, self.capacity)
        else:                   # the pop is replicated: step this row
            acc, children, cm = self._step(acc,
                                           *(r[self.rank] for r in rows))
            gk, gv, gaux, gactive, _, total, _, _ = self._publish_group(
                children, cm & live, self.capacity, [])
        over = size + total > self.capacity
        ins = gactive & ~over
        self._heap(planes, size1, rows1(rider), opkeys=gk, opvals=gv,
                   dest=torch.where(ins, 0, -1).int(),
                   oprider=gaux if self.split else (
                       None if sp is None else sp.round[0]))
        obs = None
        if self._observed:
            obs = ObsWave(outk.reshape(-1), act.reshape(-1), outv.reshape(-1),
                          None if sp is None else outb.reshape(-1),
                          shards=s, pops=act.sum(1, dtype=torch.int32),
                          pushes=ins.view(s, -1).sum(1, dtype=torch.int32),
                          occs=size.view(1).repeat(s), cls=self._shard_of)
        return (q, acc, k, torch.where(over, 0, total), over, obs,
                (outk, outv, act, gk, gv, gactive))

    # -- run ------------------------------------------------------------------

    def _start(self, initial_keys, initial_vals, initial_aux):
        """The seeded queue state and its occupancy."""
        ik = np.asarray(initial_keys, np.int32).reshape(-1)
        iv = np.asarray(initial_vals, np.int32).reshape(-1)
        if ik.shape != iv.shape:
            raise ValueError("initial_keys and initial_vals must have one "
                             "shape")
        ia = None
        if self.split:
            ia = (np.zeros_like(ik) if initial_aux is None
                  else np.asarray(initial_aux, np.int32).reshape(-1))
            if ia.shape != ik.shape:
                raise ValueError("initial_aux must have the keys' shape")
        return self._seed(ik, iv, ia), len(ik)

    def _final(self, q, acc):
        self.hints = q[3] if self.relaxed else None
        keys, vals = q[0], q[1]
        if self.relaxed and self.rank is not None:  # every rank's heap
            keys, vals = (p.reshape(self.shards, -1) for p in gather_rows(
                (keys, vals), self.mesh))
        return self._finish(acc), DistHeapState(keys, vals, q[2])


class MeshHeapEngine(_PriorityMeshBase):
    """The priority mesh round engine: rounds of claim → pop → step →
    push on the core's device loop, the heap planes (``(S, cap)`` relaxed,
    one ``(cap,)`` heap strict) carried on the card; one readback a chunk
    (``sync_every`` rounds, or the whole run).  ``run`` returns ``(acc,
    final DistHeapState)``, acc stacked ``(S, ...)`` unless ``combine``
    reduces it.  Runs on ``device`` ("cuda" by default; "cpu" runs the
    kernels' plain versions)."""

    def __init__(self, step_fn: PriorityStepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 arity_log2: int = 2, relaxed: bool = True,
                 sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 split: bool = False, device="cuda") -> None:
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         arity_log2=arity_log2, relaxed=relaxed,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         split=split, device=device)
        cap, s, reg = self.capacity, self.shards, self.registry
        # the births plane (spans) and the aux plane (split) ride their
        # heap: one a shard (sharded) relaxed, one strict
        plane = (s, cap) if relaxed else (cap,)
        if relaxed:
            reg.register("heap", (_sds(plane),) * 2, sharded=True)
            reg.register("sched", (_sds((s,)),) * 2)
        else:
            reg.register("heap", (_sds(plane),) * 2 + (_sds(()),))
        self._register_obs_planes(s, stacked=True, births_shape=plane,
                                  births_sharded=relaxed)
        if split:
            reg.register("births", _sds(plane), sharded=relaxed)

    def run(self, initial_keys: np.ndarray, initial_vals: np.ndarray,
            acc: Any = None, max_rounds: int = 10_000,
            initial_aux: np.ndarray = None) -> Tuple[Any, DistHeapState]:
        """Seed the heaps (relaxed: by seed rank, ``rank % S``; strict: one
        heap) and run rounds to quiescence, one readback a chunk.
        Bit-identical to the reference's engine and to the legacy loop:
        acc, planes, sizes, hints and stats.  Raises ``RuntimeError`` on
        heap overflow or truncation.  In split mode ``initial_aux`` seeds
        the per-item aux words (zeros when None)."""
        self._reset()
        q, n = self._start(initial_keys, initial_vals, initial_aux)
        q, acc = self._run_chunks(q, self._initial_acc(acc), n, "mesh heap",
                                  max_rounds)
        return self._final(q, acc)


class PriorityMeshRoundRunner(_PriorityMeshBase):
    """Mesh twin of ``PriorityRoundRunner``: ``fused=True`` (default)
    delegates to ``MeshHeapEngine``; ``fused=False`` is the legacy loop,
    the same round issued from the host with one readback after it, and
    with ``trace=True`` it records each round's pops (keys, vals, ok: (S,
    batch) each) and gathered pushes (keys, vals, active) in
    ``self.trace``, the material of ``check_p_linearizable``.  Both are
    bit-identical: acc, planes, sizes, hints and stats."""

    def __init__(self, step_fn: PriorityStepFn, *, mesh, axis: str = "data",
                 capacity_log2: int = 10, batch: int = 64,
                 arity_log2: int = 2, relaxed: bool = True,
                 fused: bool = True, sync_every: int = 0,
                 combine: Callable[[Any], Any] = None,
                 trace: bool = False,
                 telemetry: Optional[Telemetry] = None,
                 spans: Optional[Spans] = None, compact=None,
                 split: bool = False, device="cuda") -> None:
        super().__init__(step_fn, mesh=mesh, axis=axis,
                         capacity_log2=capacity_log2, batch=batch,
                         arity_log2=arity_log2, relaxed=relaxed,
                         sync_every=sync_every, combine=combine,
                         telemetry=telemetry, spans=spans, compact=compact,
                         split=split, device=device)
        self.fused = fused
        if trace and fused:
            raise ValueError("trace recording needs the per-round host "
                             "boundary: use fused=False")
        if trace and self.rank is not None:
            raise ValueError("trace recording keeps every shard's pops: it "
                             "needs the mesh on one card (no group)")
        if spans is not None and not fused:
            raise ValueError(
                "span planes are in-loop state: spans needs the fused "
                "engine (fused=True)")
        self.trace_enabled = trace
        self.trace = []
        self._engine = None
        if fused:
            self._engine = MeshHeapEngine(
                step_fn, mesh=mesh, axis=axis, capacity_log2=capacity_log2,
                batch=batch, arity_log2=arity_log2, relaxed=relaxed,
                sync_every=sync_every, combine=combine, telemetry=telemetry,
                spans=spans, compact=compact, split=split,
                device=self.device)

    def loop_carry_bytes(self, shards: int = None) -> int:
        if self._engine is not None:
            return self._engine.loop_carry_bytes(shards)
        return super().loop_carry_bytes(shards)

    def run(self, initial_keys: np.ndarray, initial_vals: np.ndarray,
            acc: Any = None, max_rounds: int = 10_000,
            initial_aux: np.ndarray = None) -> Tuple[Any, DistHeapState]:
        """Run to quiescence on the selected engine: ``fused=True`` as
        ``MeshHeapEngine.run`` (one readback a chunk), ``fused=False`` one
        readback a round, appending to ``self.trace`` with ``trace=True``.
        Both bit-deterministic; both raise on overflow or truncation."""
        if self._engine is not None:
            try:
                return self._engine.run(initial_keys, initial_vals, acc,
                                        max_rounds, initial_aux=initial_aux)
            finally:
                self.stats = dict(self._engine.stats, fused=1)
                self.sync_log = self._engine.sync_log
                self.hints = self._engine.hints
        self._reset()
        self.trace = []
        q, n = self._start(initial_keys, initial_vals, initial_aux)

        def round_fn(q, acc, live):
            out = self._round(q, acc, live, trace=True)
            if self.trace_enabled:
                outk, outv, ok, gk, gv, gactive = (
                    x.cpu().numpy() for x in out[6])
                self.trace.append({"pops": (outk, outv, ok),
                                   "pushes": (gk, gv, gactive)})
            return out[:5]

        q, acc = self._legacy(q, self._initial_acc(acc), n, "mesh heap",
                              max_rounds, round_fn)
        return self._final(q, acc)


# engine-matrix rows
register_engine("mesh", MeshRoundRunner, priority=False, mesh=True)
register_engine("mesh-sharded", MeshRoundRunner, priority=False, mesh=True,
                kwargs={"sharded": True}, spans_ok=False)
register_engine("pmesh-relaxed", PriorityMeshRoundRunner, priority=True,
                mesh=True, kwargs={"relaxed": True})
register_engine("pmesh-strict", PriorityMeshRoundRunner, priority=True,
                mesh=True, kwargs={"relaxed": False})
