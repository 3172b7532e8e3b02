"""Host-thread twin of G-PQ: a bounded, thread-safe deadline/priority pool
(DESIGN.md § 5.5) — a copy of ``repro/sched/hostpq.py``, which the port
does not import.

``HostPriorityPool`` is to ``GPQ`` what ``HostRing`` is to G-LFQ — the same
scheduling semantics for real host threads, with a mutex standing in for
the latch and a binary heap for the applied d-ary heap.  Keys are integers,
smaller = more urgent; ties break by admission sequence (FIFO within a
key), so EDF admission is deterministic.  The serving engine's EDF
admission path (§ 3) uses it as the request queue: page-stalled requests
re-enter with their *original* deadline, so they age toward urgency as new
arrivals take later deadlines.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Optional


class HostPriorityPool:
    """Bounded blocking min-priority pool: ``enqueue(item, key=, timeout=)``,
    ``dequeue(timeout=)``, ``peek_key()``, ``empty()``, ``close()``."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self.closed = False
        self.metrics = {"enqueues": 0, "dequeues": 0, "rejects": 0}

    def enqueue(self, item, key: int = 0,
                timeout: Optional[float] = None) -> bool:
        with self._not_full:
            deadline = None if timeout is None else time.time() + timeout
            while len(self._heap) >= self.capacity and not self.closed:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    self.metrics["rejects"] += 1
                    return False
                self._not_full.wait(remaining)
            if self.closed:
                return False
            heapq.heappush(self._heap, (key, next(self._seq), item))
            self.metrics["enqueues"] += 1
            self._not_empty.notify()
            return True

    def dequeue(self, timeout: Optional[float] = None):
        with self._not_empty:
            deadline = None if timeout is None else time.time() + timeout
            while not self._heap and not self.closed:
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            if not self._heap:
                return None  # closed and drained
            _, _, item = heapq.heappop(self._heap)
            self.metrics["dequeues"] += 1
            self._not_full.notify()
            return item

    def peek_key(self) -> Optional[int]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def empty(self) -> bool:
        with self._lock:
            return not self._heap

    def close(self) -> None:
        with self._lock:
            self.closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()
