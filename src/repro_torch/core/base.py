"""Common queue-algorithm interface for the simulated-concurrency layer.

A copy of ``repro/core/base.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Every queue exposes generator methods (driven by `repro_torch.core.sim.Scheduler`):

* ``enqueue(ctx, tid, value)`` — yields atomic instructions; returns ``True``
  on success, ``False`` if the bounded queue rejected the operation (full).
* ``dequeue(ctx, tid)`` — returns ``(True, value)`` or ``(False, None)`` for
  EMPTY.

Values must fit ``VAL_BITS`` (31 bits here) so they always fit the packed
Index field and never collide with ⊥ / ⊥_c.

The inner rings carry the payload directly in the Index field.  The paper's
outer indirection layer ("moves indices rather than payloads") exists because
real payloads exceed a word; our benchmark payloads are word-sized, so the
payload *is* the index.  `IndexedQueue` reproduces the two-ring indirection
(free-index ring + allocated ring + data array) for completeness and is used
by the application layer.
"""

from __future__ import annotations

from typing import Generator, Optional, Tuple

from .atomics import AtomicMemory
from .sim import Ctx, ENQ, DEQ

VAL_BITS = 31
VAL_MASK = (1 << VAL_BITS) - 1


class QueueAlgorithm:
    """Base class; subclasses allocate arrays in ``init`` and implement the
    generator protocol."""

    name: str = "abstract"

    def __init__(self, capacity: int, num_threads: int) -> None:
        self.capacity = capacity
        self.num_threads = num_threads
        self.mem: Optional[AtomicMemory] = None

    def init(self, mem: AtomicMemory) -> None:
        raise NotImplementedError

    def enqueue(self, ctx: Ctx, tid: int, value: int) -> Generator:
        raise NotImplementedError

    def dequeue(self, ctx: Ctx, tid: int) -> Generator:
        raise NotImplementedError

    # -- benchmark worker bodies (paper § V-A) -------------------------------

    def worker_balanced(self, ctx: Ctx, tid: int, ops: int, val_base: int):
        """Balanced kernel: each thread alternates one enqueue, one dequeue."""
        for k in range(ops):
            v = (val_base + k) & VAL_MASK
            yield from ctx.op_begin(ENQ, v)
            ok = yield from self.enqueue(ctx, tid, v)
            yield from ctx.op_end(ok, ok)
            yield from ctx.op_begin(DEQ, None)
            ok, out = yield from self.dequeue(ctx, tid)
            yield from ctx.op_end(out if ok else None, ok)

    def worker_producer(self, ctx: Ctx, tid: int, ops: int, val_base: int):
        for k in range(ops):
            v = (val_base + k) & VAL_MASK
            yield from ctx.op_begin(ENQ, v)
            ok = yield from self.enqueue(ctx, tid, v)
            yield from ctx.op_end(ok, ok)

    def worker_consumer(self, ctx: Ctx, tid: int, ops: int):
        for _ in range(ops):
            yield from ctx.op_begin(DEQ, None)
            ok, out = yield from self.dequeue(ctx, tid)
            yield from ctx.op_end(out if ok else None, ok)


class IndexedQueue:
    """The paper's outer indirection layer: a data array plus two inner rings
    (free-index ring ``fq`` pre-filled with all indices, allocated ring
    ``aq``).  Enqueue: idx ← fq.deq; data[idx] = v; aq.enq(idx).
    Dequeue: idx ← aq.deq; v = data[idx]; fq.enq(idx)."""

    def __init__(self, ring_cls, capacity: int, num_threads: int, **kw) -> None:
        self.capacity = capacity
        self.aq = ring_cls(capacity, num_threads, tag="aq", **kw)
        self.fq = ring_cls(capacity, num_threads, tag="fq", prefill=capacity, **kw)
        self.data_name = "iq_data"

    def init(self, mem: AtomicMemory) -> None:
        self.mem = mem
        self.aq.init(mem)
        self.fq.init(mem)
        mem.alloc(self.data_name, self.capacity)

    def enqueue(self, ctx: Ctx, tid: int, value: int) -> Generator:
        ok, idx = yield from self.fq.dequeue(ctx, tid)
        if not ok:
            return False  # no free index == queue full
        yield from ctx.store(self.data_name, idx, value)
        ok2 = yield from self.aq.enqueue(ctx, tid, idx)
        assert ok2, "aq can hold every index fq handed out"
        return True

    def dequeue(self, ctx: Ctx, tid: int) -> Generator:
        ok, idx = yield from self.aq.dequeue(ctx, tid)
        if not ok:
            return (False, None)
        v = yield from ctx.load(self.data_name, idx)
        ok2 = yield from self.fq.enqueue(ctx, tid, idx)
        assert ok2
        return (True, v)
