"""Queue-fed data pipeline — ``repro/data/pipeline.py``, copied (the port
imports nothing of the JAX package): host producers feed the training
loop through a G-LFQ-style bounded ring.

``HostRing`` is a bounded ring with the G-LFQ discipline on the host:
tickets from a monotone counter, slots matched by cycle, a mutex per
operation standing in for the 64-bit atomics.  The serving engine keeps
its free KV pages in one and claims them by ticket, as the paper's index
indirection does; ``DataPipeline``'s producer threads enqueue ready
batches into one and the training loop dequeues them in step order.

``synth_batch`` draws its tokens with numpy from
``default_rng((seed << 20) ^ step)``, as the reference does, so its
batches are bit-identical to the reference's and a restart resumes the
same stream from its step.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig


@dataclass
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    prefetch: int = 4
    num_producer_threads: int = 2


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


def synth_batch(cfg: ArchConfig, dcfg: DataConfig,
                step: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch for (cfg, step): numpy arrays, as the
    reference's."""
    rng = np.random.default_rng((dcfg.seed << 20) ^ step)
    b, s = dcfg.global_batch, dcfg.seq_len
    out: Dict[str, np.ndarray] = {}
    if cfg.audio_frontend:
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["img"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


class DataPipeline:
    """Producer threads -> HostRing -> iterator of ready batches, in step
    order."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig,
                 num_steps: int) -> None:
        self.cfg, self.dcfg = cfg, dcfg
        self.num_steps = num_steps
        self.ring = HostRing(dcfg.prefetch)
        self._threads = []
        self._next = 0
        self._produced = threading.Lock()

    def _producer(self, worker: int) -> None:
        while True:
            with self._produced:
                step = self._next
                if step >= self.num_steps:
                    break
                self._next += 1
            batch = synth_batch(self.cfg, self.dcfg, step)
            if not self.ring.enqueue((step, batch)):
                break
        # last worker out closes the ring
        if all(not t.is_alive() or t is threading.current_thread()
               for t in self._threads):
            self.ring.close()

    def start(self) -> "DataPipeline":
        for i in range(self.dcfg.num_producer_threads):
            t = threading.Thread(target=self._producer, args=(i,),
                                 daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def __iter__(self) -> Iterator:
        got = 0
        pending = {}
        expect = 0
        while got < self.num_steps:
            item = self.ring.dequeue(timeout=30.0)
            if item is None:
                break
            step, batch = item
            pending[step] = batch
            # deliver in order (producers may race)
            while expect in pending:
                yield expect, pending.pop(expect)
                expect += 1
                got += 1
        self.ring.close()
