"""Round-based deterministic task loops on the G-LFQ ring and the G-PQ
heap — the PyTorch twins of ``RoundRunner`` and ``PriorityRoundRunner``
in ``repro/runtime/rounds.py``.

One round dequeues a batch of task values from the ring, runs the user's
step function on the batch, and enqueues the children it emits in
row-major order; every queue operation is ordered by ticket, so the run
is deterministic.  Two engines share this contract:

* **fused** (default) — ``fusedrounds.RingEngine``: the whole round runs
  on the device with head/tail as device tensors, its queue side two
  launches (``ring_dequeue_wave``, and ``ring_enqueue_wave`` whose ballot
  is the child-ticket source); the host reads back once per chunk of
  rounds.
* **legacy** (``fused=False``) — one host-driven round per iteration:
  head/tail as host ints, ``np.arange`` tickets, one kernel launch per
  wave and a readback after each.  Slower, but each round is a separate,
  inspectable step.

Both are bit-identical (acc, planes, head/tail, stats other than
``host_syncs``) and raise ``RuntimeError`` on ring overflow and on
``max_rounds`` truncation.  ``telemetry=`` and ``spans=``
(``repro_torch.obs``) go to the fused engine; their planes are in-round
state, so the legacy loop refuses them with the reference's
``ValueError``.  ``PriorityRoundRunner`` has the same two
modes over ``fusedrounds.HeapEngine`` and the ``heap_apply`` kernel.
``mesh_task_round`` is one mesh-scope task round over the replicated
ring of ``core.distqueue``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.distqueue import dist_dequeue_round, dist_enqueue_round
from ..kernels._build import resolve_device
from ..kernels.heap_batch import KEY_INF as HEAP_KEY_INF
from ..kernels.heap_batch import heap_apply
from ..kernels.ring_slots import ring_dequeue, ring_enqueue
from .enginecore import register_engine, tree_to
from .fusedrounds import (IDX_BOT, HeapEngine, HeapState, PriorityStepFn,
                          RingEngine, RingState, StepFn, heap_init, ring_init)

__all__ = ["HeapState", "IDX_BOT", "PriorityRoundRunner", "PriorityStepFn",
           "RingState", "RoundRunner", "StepFn", "heap_init",
           "mesh_task_round", "ring_init"]


def _legacy_obs(fused: bool, telemetry, spans) -> None:
    """The legacy loop has no in-round planes: refuse the collectors, as
    the reference does."""
    if telemetry is not None and not fused:
        raise ValueError("trace planes are in-loop state: telemetry "
                         "needs the fused engine (fused=True)")
    if spans is not None and not fused:
        raise ValueError("span planes are in-loop state: spans needs "
                         "the fused engine (fused=True)")


class RoundRunner:
    """Drives ``step_fn`` to quiescence through the G-LFQ ring on
    ``device`` ("cuda" by default; "cpu" runs the kernels' plain
    versions).

    ``fused=True`` (default) delegates to the device-resident
    ``RingEngine``; ``fused=False`` keeps the legacy host-driven loop.
    Both fill ``stats`` with rounds / processed / spawned / max_occupancy
    / drained / host_syncs / fused and raise on overflow or truncation."""

    def __init__(self, step_fn: StepFn, *, capacity_log2: int = 10,
                 batch: int = 64, fused: bool = True, sync_every: int = 0,
                 telemetry=None, spans=None, compact=None,
                 device="cuda") -> None:
        self.step_fn = step_fn
        self.capacity_log2 = capacity_log2
        self.nslots_log2 = capacity_log2 + 1
        self.capacity = 1 << capacity_log2
        self.batch = batch
        self.fused = fused
        self.telemetry = telemetry
        self.spans = spans
        self.device = resolve_device(device)
        self.stats: Dict[str, int] = {}
        self.sync_log: List = []
        _legacy_obs(fused, telemetry, spans)
        if fused:
            self._engine = RingEngine(
                step_fn, capacity_log2=capacity_log2, batch=batch,
                sync_every=sync_every, telemetry=telemetry, spans=spans,
                compact=compact, device=self.device)
        else:
            self._engine = None
            # legacy-path op buffers, reused across rounds (safe because
            # torch.tensor copies them onto the device)
            self._enq_t = np.empty(batch, np.int32)
            self._enq_v = np.empty(batch, np.int32)
            self._deq_t = np.empty(batch, np.int32)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _enq_chunk(self, st: RingState, vals: np.ndarray) -> RingState:
        k = len(vals)
        assert k <= self.batch
        if st.occupancy + k > self.capacity:
            raise RuntimeError(
                f"ring overflow: occupancy {st.occupancy} + {k} children "
                f"exceeds capacity {self.capacity} (raise capacity_log2 or "
                f"lower the fanout)")
        self._enq_t.fill(-1)
        self._enq_t[:k] = st.tail + np.arange(k, dtype=np.int32)
        self._enq_v.fill(-1)
        self._enq_v[:k] = vals
        cyc, saf, enq, idx, ok = ring_enqueue(
            st.cycles, st.safes, st.enqs, st.idxs,
            self._on_device(self._enq_t), self._on_device(self._enq_v),
            st.head, nslots_log2=self.nslots_log2, idx_bot=IDX_BOT)
        self._host_syncs += 1
        assert bool(ok[:k].all()), "exact tickets cannot miss"
        return RingState(cyc, saf, enq, idx, st.head, st.tail + k)

    def run(self, initial: np.ndarray, acc: Any = None,
            max_rounds: int = 10_000) -> Tuple[Any, RingState]:
        """Seed the ring with ``initial`` task values, run rounds until the
        ring drains.  Returns (acc, final ring state with int head/tail);
        raises RuntimeError if ``max_rounds`` is hit before quiescence."""
        if self._engine is not None:
            try:
                return self._engine.run(initial, acc, max_rounds)
            finally:
                self.stats = dict(self._engine.stats, fused=1)
                self.sync_log = self._engine.sync_log
        self.stats = {}
        self.sync_log = []
        self._host_syncs = 0
        st = ring_init(self.capacity_log2, self.device)
        initial = np.asarray(initial, np.int32)
        for i in range(0, len(initial), self.batch):
            st = self._enq_chunk(st, initial[i:i + self.batch])
        acc = tree_to(acc, self.device)
        rounds = processed = spawned = 0
        max_occ = st.occupancy
        while st.occupancy > 0 and rounds < max_rounds:
            k = min(self.batch, st.occupancy)
            self._deq_t.fill(-1)
            self._deq_t[:k] = st.head + np.arange(k, dtype=np.int32)
            cyc, saf, enq, idx, vals, ok = ring_dequeue(
                st.cycles, st.safes, st.enqs, st.idxs,
                self._on_device(self._deq_t), nslots_log2=self.nslots_log2,
                idx_bot=IDX_BOT)
            self._host_syncs += 1
            assert bool(ok[:k].all()), "exact tickets cannot miss"
            st = RingState(cyc, saf, enq, idx, st.head + k, st.tail)
            acc, cvals, cmask = self.step_fn(acc, vals, ok)
            cv = cvals.reshape(-1).cpu().numpy()
            cm = np.broadcast_to(cmask.bool().cpu().numpy(),
                                 tuple(cvals.shape)).reshape(-1)
            self._host_syncs += 1
            children = cv[cm]                      # row-major ⇒ deterministic
            for i in range(0, len(children), self.batch):
                st = self._enq_chunk(st, children[i:i + self.batch])
            rounds += 1
            processed += k
            spawned += len(children)
            max_occ = max(max_occ, st.occupancy)
        self.stats = {"rounds": rounds, "processed": processed,
                      "spawned": spawned, "max_occupancy": max_occ,
                      "drained": int(st.occupancy == 0),
                      "host_syncs": self._host_syncs, "fused": 0}
        if st.occupancy > 0:
            raise RuntimeError(
                f"round loop truncated at max_rounds={max_rounds} with "
                f"occupancy {st.occupancy}: not quiescent "
                f"(stats['drained']=0)")
        return acc, st


# ---------------------------------------------------------------------------
# Priority rounds on the heap kernel
# ---------------------------------------------------------------------------


class PriorityRoundRunner:
    """``RoundRunner``'s priority twin: drives ``step_fn`` to quiescence
    through the heap kernel on ``device`` ("cuda" by default; "cpu" runs
    the plain version).  One round pops the ``batch`` smallest (key, val)
    pairs, runs the step, and inserts the children it emits in row-major
    order; every batch is applied in batch-index order, so the run is
    bit-deterministic like the FIFO rounds.  ``fused=True`` (default)
    runs ``HeapEngine``; ``fused=False`` keeps the legacy host-driven
    loop, which reads the size back after every batch."""

    def __init__(self, step_fn: PriorityStepFn, *, capacity_log2: int = 10,
                 batch: int = 64, arity_log2: int = 2, fused: bool = True,
                 sync_every: int = 0, telemetry=None, spans=None,
                 compact=None, device="cuda") -> None:
        self.step_fn = step_fn
        self.capacity_log2 = capacity_log2
        self.capacity = 1 << capacity_log2
        self.batch = batch
        self.arity_log2 = arity_log2
        self.fused = fused
        self.telemetry = telemetry
        self.spans = spans
        self.device = resolve_device(device)
        self.stats: Dict[str, int] = {}
        self.sync_log: List = []
        _legacy_obs(fused, telemetry, spans)
        if fused:
            self._engine = HeapEngine(
                step_fn, capacity_log2=capacity_log2, batch=batch,
                arity_log2=arity_log2, sync_every=sync_every,
                telemetry=telemetry, spans=spans, compact=compact,
                device=self.device)
        else:
            self._engine = None
            # legacy-path op buffers, reused across rounds (safe because
            # torch.tensor copies them onto the device)
            self._ins_ops = np.empty(batch, np.int32)
            self._ins_k = np.empty(batch, np.int32)
            self._ins_v = np.empty(batch, np.int32)
            self._pop_ops = np.empty(batch, np.int32)
            self._pad = torch.full((batch,), HEAP_KEY_INF, dtype=torch.int32,
                                   device=self.device)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _apply(self, st: HeapState, ops, keys, vals):
        k, v, size, outk, outv, ok = heap_apply(
            st.keys, st.vals, st.size, ops, keys, vals,
            cap_log2=self.capacity_log2, arity_log2=self.arity_log2)
        self._host_syncs += 1
        return HeapState(k, v, int(size)), outk, outv, ok

    def _ins_chunk(self, st: HeapState, ckeys: np.ndarray,
                   cvals: np.ndarray) -> HeapState:
        n = len(ckeys)
        assert n <= self.batch
        if st.size + n > self.capacity:
            raise RuntimeError(
                f"heap overflow: size {st.size} + {n} children exceeds "
                f"capacity {self.capacity} (raise capacity_log2 or lower "
                f"the fanout)")
        self._ins_ops.fill(-1)
        self._ins_ops[:n] = 0
        self._ins_k.fill(HEAP_KEY_INF)
        self._ins_k[:n] = ckeys
        self._ins_v.fill(-1)
        self._ins_v[:n] = cvals
        st, _, _, ok = self._apply(st, self._on_device(self._ins_ops),
                                   self._on_device(self._ins_k),
                                   self._on_device(self._ins_v))
        assert bool(ok[:n].all()), "capacity was checked: inserts cannot miss"
        return st

    def run(self, initial_keys: np.ndarray, initial_vals: np.ndarray,
            acc: Any = None, max_rounds: int = 10_000
            ) -> Tuple[Any, HeapState]:
        """Seed the heap with (key, val) pairs and run rounds until it
        drains.  Returns (acc, final ``HeapState`` with an int size);
        raises RuntimeError on heap overflow or if ``max_rounds`` is hit
        before quiescence."""
        if self._engine is not None:
            try:
                return self._engine.run(initial_keys, initial_vals, acc,
                                        max_rounds)
            finally:
                self.stats = dict(self._engine.stats, fused=1)
                self.sync_log = self._engine.sync_log
        self.stats = {}
        self.sync_log = []
        self._host_syncs = 0
        st = heap_init(self.capacity_log2, self.device)
        ik = np.asarray(initial_keys, np.int32)
        iv = np.asarray(initial_vals, np.int32)
        if ik.shape != iv.shape:
            raise ValueError("initial_keys and initial_vals must have one "
                             "shape")
        for i in range(0, len(ik), self.batch):
            st = self._ins_chunk(st, ik[i:i + self.batch],
                                 iv[i:i + self.batch])
        acc = tree_to(acc, self.device)
        rounds = processed = spawned = 0
        max_occ = st.size
        while st.size > 0 and rounds < max_rounds:
            k = min(self.batch, st.size)
            self._pop_ops.fill(-1)
            self._pop_ops[:k] = 1
            st, outk, outv, ok = self._apply(
                st, self._on_device(self._pop_ops), self._pad, self._pad)
            assert bool(ok[:k].all()), "size was checked: pops cannot miss"
            acc, ckeys, cvals, cmask = self.step_fn(acc, outk, outv, ok)
            ck = ckeys.reshape(-1).cpu().numpy()
            cv = cvals.reshape(-1).cpu().numpy()
            cm = np.broadcast_to(cmask.bool().cpu().numpy(),
                                 tuple(ckeys.shape)).reshape(-1)
            self._host_syncs += 1
            children_k, children_v = ck[cm], cv[cm]   # row-major order
            for i in range(0, len(children_k), self.batch):
                st = self._ins_chunk(st, children_k[i:i + self.batch],
                                     children_v[i:i + self.batch])
            rounds += 1
            processed += k
            spawned += len(children_k)
            max_occ = max(max_occ, st.size)
        self.stats = {"rounds": rounds, "processed": processed,
                      "spawned": spawned, "max_occupancy": max_occ,
                      "drained": int(st.size == 0),
                      "host_syncs": self._host_syncs, "fused": 0}
        if st.size > 0:
            raise RuntimeError(
                f"priority round loop truncated at max_rounds={max_rounds} "
                f"with size {st.size}: not quiescent (stats['drained']=0)")
        return acc, st


def mesh_task_round(state, spawn_vals: torch.Tensor, spawn_mask: torch.Tensor,
                    claim_mask: torch.Tensor, *, mesh=None):
    """One mesh-scope task round: publish every shard's spawned tasks, then
    claim up to ``claim_mask.sum()`` tasks for the shards to execute.
    ``spawn_vals``, ``spawn_mask`` and ``claim_mask`` are ``(S, B)``, shard
    i's requests in row i (the reference's per-chip rows under
    ``shard_map``, stacked; no ``axis``).  Returns (state, granted,
    claimed_vals, claimed_ok), each output ``(S, B)``.  With ``mesh``
    bound to a process group they are this rank's ``(B,)`` rows, as the
    reference's inside ``shard_map``, and the round makes the reference's
    two collectives; the replicated ``state`` stays equal on every rank.

    Composes ``dist_enqueue_round`` + ``dist_dequeue_round``: on the card
    their waves are the ring waves' masked instances, on the device of
    ``state``."""
    state, granted = dist_enqueue_round(state, spawn_vals, spawn_mask,
                                        mesh=mesh)
    state, vals, ok = dist_dequeue_round(state, claim_mask, mesh=mesh)
    return state, granted, vals, ok


# engine-matrix rows
register_engine("rounds", RoundRunner, priority=False, mesh=False)
register_engine("prounds", PriorityRoundRunner, priority=True, mesh=False)
