"""The free-page ring of the serving engine — ``HostRing`` of
``repro/data/pipeline.py``, copied (the port imports nothing of the JAX
package).  ``DataPipeline`` and ``synth_batch`` come with training.

A bounded ring with the G-LFQ discipline on the host: tickets from a
monotone counter, slots matched by cycle, a mutex per operation standing
in for the 64-bit atomics.  The serving engine keeps its free KV pages in
one and claims them by ticket, as the paper's index indirection does.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class HostRing:
    """Bounded MPMC ring (host port of the G-LFQ discipline: tickets from a
    monotone counter, slots matched by cycle; mutex-per-op stands in for the
    64-bit atomics)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._slots = [None] * capacity
        self._cycle = [0] * capacity
        self._tail = 0
        self._head = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self.closed = False

    def enqueue(self, item, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            deadline = None if timeout is None else time.time() + timeout
            while self._tail - self._head >= self.capacity and not self.closed:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            if self.closed:
                return False
            t = self._tail
            self._tail += 1
            self._slots[t % self.capacity] = item
            self._cycle[t % self.capacity] = t // self.capacity + 1
            self._not_empty.notify()
            return True

    def dequeue(self, timeout: Optional[float] = None):
        with self._not_empty:
            deadline = None if timeout is None else time.time() + timeout
            while self._tail <= self._head and not self.closed:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            if self._tail <= self._head:
                return None  # closed and drained
            h = self._head
            self._head += 1
            item = self._slots[h % self.capacity]
            self._slots[h % self.capacity] = None
            self._not_full.notify()
            return item

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def empty(self) -> bool:
        with self._lock:
            return self._tail <= self._head
