"""Chip-local fused round engines — ``repro/runtime/fusedrounds.py`` as
two configurations of the engine core: ``RingEngine`` (FIFO) and
``HeapEngine`` (priority).

One FIFO round runs entirely on the device:

    dequeue wave (``ring_dequeue_wave``) → the user's step →
    [``wave_compact`` when the child wave is wider than the ring] →
    enqueue wave (``ring_enqueue_wave``: the ballot's tickets, the
    overflow test and the installs)

with head/tail as 0-d device tensors that the two waves advance in
place: on the card the round's queue work is these two launches (three
with compaction).  The host reads back once per chunk of rounds
(``enginecore``: a drained run is one chunk, on the card one CUDA graph
launch whose WHILE node replays the round), not once per round.  Within
a round the engine issues exactly the reference's tickets (ballot ranks
= row-major child order, Lemma III.1) through the same plane updates, so
acc, planes, head/tail and the stats counters are bit-identical to the
reference engine and to the legacy per-round loop.

Every round is predicated on a ``live`` flag: a round that is not live
dequeues nothing (``k = 0``) and spawns nothing (the enqueue wave counts
none of the step's children), so it leaves the ring as it was.  The core
runs a round only while its loop condition holds, so it passes a true
flag.

``HeapEngine`` is the priority configuration: a pop batch of
``heap_apply`` (the ``min(batch, size)`` smallest keys), the user's
step, and one insert batch of the children in row-major order (or of the
dense wave of ``wave_compact`` when the child wave is wider than the
heap), with the heap size as a 0-d device tensor.  A round that is not
live pops nothing (``k = 0``) and turns every insert lane into
``OP_NOP``.

With ``telemetry=`` / ``spans=`` (``repro_torch.obs``) the round hands
the core its claim wave for the record.  With spans on, the ring runs
the packed waves (the birth stamp ``(round << 1) | 1`` in the enq-flag
plane, ``run`` returns the flags stripped back to ``enq & 1``) and the
heap runs ``heap_apply``'s rider instance with a births plane; the
sojourn is ``round - birth`` (reference ``fusedrounds.py:168-183,
333-369``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels._build import resolve_device
from ..kernels.compact import (compact_scratch, compact_scratch_words,
                               compact_width, wave_compact)
from ..kernels.heap_batch import (KEY_INF as HEAP_KEY_INF, OP_DELMIN,
                                  OP_INSERT, OP_NOP, heap_apply)
from ..kernels.ring_slots import (ring_dequeue_wave, ring_enqueue,
                                  ring_enqueue_wave)
from .enginecore import EngineCore, ObsWave, _sds, tree_to

IDX_BOT = 2 ** 31 - 1           # ⊥ (⊥_c = IDX_BOT - 1); payloads must be smaller


class RingState(NamedTuple):
    """Field planes of the 2n-slot ring plus head/tail tickets (ints on
    the host side, 0-d int32 tensors inside the engine)."""
    cycles: torch.Tensor
    safes: torch.Tensor
    enqs: torch.Tensor
    idxs: torch.Tensor
    head: Any
    tail: Any

    @property
    def occupancy(self):
        return self.tail - self.head


def ring_init(capacity_log2: int, device="cuda") -> RingState:
    """Ring with logical capacity 2^capacity_log2 (2n physical slots).
    Head = Tail = 2n, so first tickets carry cycle 1 over cycle-0 slots."""
    dev = resolve_device(device)
    nslots = 2 << capacity_log2
    i32 = dict(dtype=torch.int32, device=dev)
    return RingState(
        cycles=torch.zeros(nslots, **i32),
        safes=torch.ones(nslots, **i32),
        enqs=torch.zeros(nslots, **i32),
        idxs=torch.full((nslots,), IDX_BOT, **i32),
        head=nslots, tail=nslots,
    )


class HeapState(NamedTuple):
    """Field planes of the device heap plus its size (an int on the host
    side, a 0-d int32 tensor inside the engine)."""
    keys: torch.Tensor
    vals: torch.Tensor
    size: Any

    @property
    def occupancy(self):
        return self.size


def heap_init(capacity_log2: int, device="cuda") -> HeapState:
    """Empty heap of 2^capacity_log2 slots (keys ``KEY_INF``, vals -1)."""
    dev = resolve_device(device)
    cap = 1 << capacity_log2
    return HeapState(
        keys=torch.full((cap,), HEAP_KEY_INF, dtype=torch.int32, device=dev),
        vals=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        size=0,
    )


# StepFn: (acc, vals (B,) int32, valid (B,) bool)
#      -> (acc, child_vals (B,F), child_mask (B,F) or (B,1))
# The step must be functional: it returns a new acc and modifies none of
# its arguments in place (the engine keeps the old acc for no-op rounds).
StepFn = Callable[[Any, torch.Tensor, torch.Tensor],
                  Tuple[Any, torch.Tensor, torch.Tensor]]

# PriorityStepFn: (acc, keys (B,), vals (B,), valid (B,))
#   -> (acc, child_keys (B,F), child_vals (B,F), child_mask (B,F) or (B,1))
# Functional, as StepFn.
PriorityStepFn = Callable[
    [Any, torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]


def _compact(engine, mask, planes, width):
    """``wave_compact`` on the engine's own look-back scratch, allocated at
    its first compacting round (the kernel leaves it zero every call)."""
    scratch = engine._compact_scratch
    if scratch is None or scratch.numel() < compact_scratch_words(
            mask.shape[0]):
        scratch = engine._compact_scratch = compact_scratch(mask.shape[0],
                                                            mask.device)
    return wave_compact(mask, planes, width=width, scratch=scratch)


class RingEngine(EngineCore):
    """The FIFO megaround configuration: ring planes + device head/tail
    under the core's chunks of rounds.  Same contract as the legacy
    ``RoundRunner.run`` (exact tickets, row-major child order,
    quiescence).  Runs on ``device`` ("cuda" by default; "cpu" runs the
    kernels' plain versions)."""

    def __init__(self, step_fn: StepFn, *, capacity_log2: int = 10,
                 batch: int = 64, sync_every: int = 0, telemetry=None,
                 spans=None, compact=None, device="cuda") -> None:
        self.step_fn = step_fn
        self.capacity_log2 = capacity_log2
        self.nslots_log2 = capacity_log2 + 1
        self.capacity = 1 << capacity_log2
        self.batch = batch
        if batch > self.capacity:
            raise ValueError(f"batch {batch} exceeds ring capacity "
                             f"{self.capacity}")
        self.sync_every = sync_every
        self.telemetry = telemetry
        self.spans = spans
        self.compact = compact
        self.device = resolve_device(device)
        self._compact_scratch = None
        self._reset()
        nslots = 2 << capacity_log2
        self.registry.register("ring", (_sds((nslots,)),) * 4
                               + (_sds(()), _sds(())))    # planes + head/tail
        # no births plane: the FIFO stamps pack into the enq-flag plane
        self._register_obs_planes()

    @staticmethod
    def _occ_of(q):
        return q.tail - q.head

    def _round(self, st, acc, live, sp=None, births=None):
        cyc, saf, enq, idx, head, tail = st
        kw = dict(nslots_log2=self.nslots_log2, idx_bot=IDX_BOT)
        # head and tail advance in place, so the state returned is ``st``;
        # with spans the waves carry packed birth stamps
        deq = ring_dequeue_wave(cyc, saf, enq, idx, head, tail, live,
                                batch=self.batch, birth_packed=sp is not None,
                                **kw)
        vals, ok, k = deq[0][0], deq[1][0], deq[2]     # the one shard's row
        acc, cvals, cmask = self.step_fn(acc, vals, ok)
        cm = torch.broadcast_to(cmask.bool(), cvals.shape).reshape(-1)
        cv = cvals.reshape(-1).to(torch.int32)
        # dense-wave rule: compact the sparse child wave down to the
        # capacity bound before installing (a static decision per shape);
        # the dense wave IS the children in ballot rank order
        wdth = compact_width(cv.shape[0], self.capacity, self.compact)
        if wdth is None:
            wave = dict(mask=cm)
        else:
            (cv,), n_child = _compact(self, cm, (cv,), wdth)
            cv, wave = cv.reshape(1, -1), dict(counts=n_child.reshape(1))
        total, over, _ = ring_enqueue_wave(
            cyc, saf, enq, idx, head, tail, cv, live, capacity=self.capacity,
            birth_round=None if sp is None else sp.round, **wave, **kw)
        obs = None
        if self._observed:               # FIFO: payload extrema and refs
            obs = ObsWave(vals, ok, vals, deq[4][0] if sp is not None else None)
        return st, acc, k, total, over, obs

    def _seed(self, st: RingState, initial: np.ndarray) -> RingState:
        n = len(initial)
        if n > self.capacity:
            raise RuntimeError(
                f"ring overflow: {n} seed values exceed capacity "
                f"{self.capacity} (raise capacity_log2)")
        if n == 0:
            return st
        tickets = torch.as_tensor(
            (st.tail + np.arange(n, dtype=np.int64)).astype(np.int32),
            device=self.device)
        cyc, saf, enq, idx, ok = ring_enqueue(
            st.cycles, st.safes, st.enqs, st.idxs, tickets,
            torch.as_tensor(initial, device=self.device), st.head,
            nslots_log2=self.nslots_log2, idx_bot=IDX_BOT)
        assert bool(ok.all()), "exact tickets cannot miss"
        return RingState(cyc, saf, enq, idx, st.head, st.tail + n)

    def run(self, initial: np.ndarray, acc: Any = None,
            max_rounds: int = 10_000) -> Tuple[Any, RingState]:
        """Seed the ring and run rounds to quiescence.  The host reads
        back once per chunk (``sync_every`` rounds, or the whole run with
        ``sync_every=0``, as in the reference); ``stats`` and ``sync_log``
        are filled at each readback.  The stats (``host_syncs`` too), the
        sync log, acc, the planes and head/tail are bit-identical to the
        reference.  Raises ``RuntimeError`` on ring overflow or
        ``max_rounds`` truncation at the readback after the flagged
        round.  Returns ``(acc, final RingState)`` with int head/tail."""
        self._reset()
        st = self._seed(ring_init(self.capacity_log2, self.device),
                        np.asarray(initial, np.int32).reshape(-1))
        i32 = dict(dtype=torch.int32, device=self.device)
        q = RingState(st.cycles, st.safes, st.enqs, st.idxs,
                      torch.tensor(st.head, **i32),
                      torch.tensor(st.tail, **i32))
        q, acc = self._run_chunks(q, tree_to(acc, self.device),
                                  st.tail - st.head, "ring", max_rounds)
        # with spans the flags carry packed stamps: strip them to the
        # unspanned plane
        enqs = q.enqs if self.spans is None else q.enqs & 1
        return acc, RingState(q.cycles, q.safes, enqs, q.idxs,
                              int(q.head), int(q.tail))


class HeapEngine(EngineCore):
    """``RingEngine``'s priority configuration: ``heap_apply`` pop and
    insert batches under the core's chunks of rounds, with the heap size
    as a device tensor.  Children insert as one masked batch in row-major
    order — the same heap evolution as the legacy chunked inserts, so
    acc, planes, size and the stats counters are bit-identical to the
    reference engine and to the legacy loop.  Runs on ``device`` ("cuda"
    by default; "cpu" runs the kernels' plain versions)."""

    def __init__(self, step_fn: PriorityStepFn, *, capacity_log2: int = 10,
                 batch: int = 64, arity_log2: int = 2, sync_every: int = 0,
                 telemetry=None, spans=None, compact=None,
                 device="cuda") -> None:
        self.step_fn = step_fn
        self.capacity_log2 = capacity_log2
        self.capacity = 1 << capacity_log2
        self.batch = batch
        if batch > self.capacity:
            raise ValueError(f"batch {batch} exceeds heap capacity "
                             f"{self.capacity}")
        self.arity_log2 = arity_log2
        self.sync_every = sync_every
        self.telemetry = telemetry
        self.spans = spans
        self.compact = compact
        self.device = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=self.device)
        self._lane = torch.arange(batch, **i32)
        self._compact_scratch = None
        self._pad = torch.full((batch,), HEAP_KEY_INF, **i32)
        self._reset()
        cap = self.capacity
        self.registry.register("heap", (_sds((cap,)), _sds((cap,)),
                                        _sds(())))       # keys/vals + size
        self._register_obs_planes(births_shape=(cap,))

    @staticmethod
    def _occ_of(q):
        return q.size

    def _heap(self, keys, vals, size, ops, okeys, ovals, **rider):
        return heap_apply(keys, vals, size, ops, okeys, ovals,
                          cap_log2=self.capacity_log2,
                          arity_log2=self.arity_log2, **rider)

    def _round(self, st, acc, live, sp=None, births=None):
        capacity = self.capacity
        keys, vals, size = st
        # with spans the births plane rides every sift and inserts stamp
        # the round (pops install nothing, so they take the same word)
        rider = {} if sp is None else dict(rider=births, oprider=sp.round)
        k = torch.where(live, torch.clamp(size, max=self.batch), 0)
        pop_ops = torch.where(self._lane < k, OP_DELMIN, OP_NOP).int()
        popped = self._heap(keys, vals, size, pop_ops, self._pad, self._pad,
                            **rider)
        keys, vals, size, outk, outv, ok = popped[:6]
        acc, ckeys, cvals, cmask = self.step_fn(acc, outk, outv, ok)
        cm = (torch.broadcast_to(cmask.bool(), ckeys.shape).reshape(-1)
              & live)
        ckf = ckeys.reshape(-1).to(torch.int32)
        cvf = cvals.reshape(-1).to(torch.int32)
        # dense-wave rule: compact before the insert batch — the dense
        # wave keeps row-major lane order, so the insert sequence (hence
        # the heap evolution) is the sparse one's
        wdth = compact_width(ckf.shape[0], capacity, self.compact)
        if wdth is None:
            n_child = cm.sum(dtype=torch.int32)
            over = size + n_child > capacity
            ins_ops = torch.where(cm & ~over, OP_INSERT, OP_NOP).int()
        else:
            (ckf, cvf), n_child = _compact(self, cm, (ckf, cvf), wdth)
            over = size + n_child > capacity
            lane_w = torch.arange(wdth, dtype=torch.int32,
                                  device=ckf.device)
            ins_ops = torch.where((lane_w < n_child) & ~over, OP_INSERT,
                                  OP_NOP).int()
        keys, vals, size = self._heap(keys, vals, size, ins_ops, ckf, cvf,
                                      **rider)[:3]
        total = torch.where(over, 0, n_child)
        obs = None
        if self._observed:               # priority: popped-key extrema
            obs = ObsWave(outk, ok, outv,
                          popped[7] if sp is not None else None)
        return HeapState(keys, vals, size), acc, k, total, over, obs

    def _seed(self, st: HeapState, ik: np.ndarray,
              iv: np.ndarray) -> HeapState:
        n = len(ik)
        if st.size + n > self.capacity:
            raise RuntimeError(
                f"heap overflow: {n} seed values exceed capacity "
                f"{self.capacity} (raise capacity_log2)")
        if n == 0:
            return st
        ops = torch.full((n,), OP_INSERT, dtype=torch.int32,
                         device=self.device)
        keys, vals, size, _, _, ok = self._heap(
            st.keys, st.vals, st.size, ops,
            torch.as_tensor(ik, device=self.device),
            torch.as_tensor(iv, device=self.device))
        assert bool(ok.all()), "capacity was checked: inserts cannot miss"
        return HeapState(keys, vals, st.size + n)

    def run(self, initial_keys: np.ndarray, initial_vals: np.ndarray,
            acc: Any = None, max_rounds: int = 10_000
            ) -> Tuple[Any, HeapState]:
        """Seed the heap and run priority rounds to quiescence,
        with pops in exact min-key order within each round.  Same
        readback and error contract as ``RingEngine.run`` (one readback
        per chunk; ``RuntimeError`` on heap overflow or ``max_rounds``
        truncation).  Returns ``(acc, HeapState)`` with an int size."""
        self._reset()
        ik = np.asarray(initial_keys, np.int32).reshape(-1)
        iv = np.asarray(initial_vals, np.int32).reshape(-1)
        if ik.shape != iv.shape:
            raise ValueError("initial_keys and initial_vals must have one "
                             "shape")
        st = self._seed(heap_init(self.capacity_log2, self.device), ik, iv)
        q = HeapState(st.keys, st.vals,
                      torch.tensor(st.size, dtype=torch.int32,
                                   device=self.device))
        q, acc = self._run_chunks(q, tree_to(acc, self.device), st.size,
                                  "heap", max_rounds)
        return acc, HeapState(q.keys, q.vals, int(q.size))
