"""History harness: run queue workloads under the scheduler, collect
histories, and run the paper's § IV device-side FIFO conformance check.

A copy of ``repro/core/histories.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Token scheme (§ IV-b): each producer thread emits ``tok = (tid << 16) |
(seq+1)`` (the paper uses a 32-bit shift; our packed value field is 31 bits,
so producers get 15 bits of id and 16 bits of sequence — same structure).
The checker verifies (i) exactly-once delivery, (ii) no out-of-thin-air
tokens, (iii) per-producer monotone sequence at each consumer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .atomics import AtomicMemory
from .base import QueueAlgorithm
from .sim import Ctx, DEQ, ENQ, HistoryEvent, Scheduler

TOK_SEQ_BITS = 16


def make_token(tid: int, seq: int) -> int:
    return ((tid & 0x7FFF) << TOK_SEQ_BITS) | ((seq + 1) & 0xFFFF)


def token_fields(tok: int) -> Tuple[int, int]:
    return (tok >> TOK_SEQ_BITS) & 0x7FFF, (tok & 0xFFFF) - 1


@dataclass
class FifoReport:
    ok: bool
    reason: str = ""
    produced: int = 0
    consumed: int = 0


def producer_body(queue: QueueAlgorithm, ops: int):
    def body(ctx: Ctx, tid: int):
        sent = 0
        while sent < ops:
            tok = make_token(tid, sent)
            yield from ctx.op_begin(ENQ, tok)
            ok = yield from queue.enqueue(ctx, tid, tok)
            yield from ctx.op_end(ok, ok)
            if ok:
                sent += 1
            else:
                yield from ctx.step()
    return body


def consumer_body(queue: QueueAlgorithm, done_flag: Dict[str, bool],
                  sink: List[Tuple[int, int]]):
    """Dequeue until the producers are done AND the queue is drained."""
    def body(ctx: Ctx, tid: int):
        empties_after_done = 0
        while True:
            yield from ctx.op_begin(DEQ, None)
            ok, v = yield from queue.dequeue(ctx, tid)
            yield from ctx.op_end(v if ok else None, ok)
            if ok:
                sink.append((tid, v))
                empties_after_done = 0
            else:
                if done_flag["done"]:
                    empties_after_done += 1
                    if empties_after_done >= 3:
                        return
                yield from ctx.step()
    return body


def run_producer_consumer(queue: QueueAlgorithm, *, producers: int,
                          consumers: int, ops_per_producer: int,
                          policy: str = "random", seed: int = 0,
                          wave_size: int = 8,
                          max_steps: int = 5_000_000) -> Tuple[Scheduler, List[Tuple[int, int]], FifoReport]:
    """Producers enqueue unique tokens; consumers drain.  Returns the
    scheduler (for history/metrics), the consumption log, and the FIFO
    conformance report."""
    mem = AtomicMemory()
    queue.init(mem)
    sched = Scheduler(mem, wave_size=wave_size, policy=policy, seed=seed)
    done = {"done": False}
    sink: List[Tuple[int, int]] = []

    prod_threads = []
    for _ in range(producers):
        prod_threads.append(sched.spawn(producer_body(queue, ops_per_producer)))
    for _ in range(consumers):
        sched.spawn(consumer_body(queue, done, sink))

    # run until producers finish, then mark done and drain
    while sched.step_count < max_steps:
        if all(t.done for t in prod_threads):
            done["done"] = True
        live = sched.runnable()
        if not live:
            break
        th = sched._pick()
        sched._exec(th)
    report = fifo_conformance(sink, producers, ops_per_producer)
    if not all(t.done for t in sched.threads):
        report = FifoReport(False, "run did not complete within step budget",
                            report.produced, report.consumed)
    return sched, sink, report


def fifo_conformance(sink: List[Tuple[int, int]], producers: int,
                     ops_per_producer: int) -> FifoReport:
    """§ IV-b: exactly-once, no out-of-bounds tokens, per-producer monotone
    sequence at each consumer."""
    counts: Dict[int, int] = {}
    per_consumer_last: Dict[Tuple[int, int], int] = {}
    for consumer, tok in sink:
        pid, seq = token_fields(tok)
        if pid >= producers or not (0 <= seq < ops_per_producer):
            return FifoReport(False, f"out-of-thin-air token {tok:#x}",
                              producers * ops_per_producer, len(sink))
        counts[tok] = counts.get(tok, 0) + 1
        if counts[tok] > 1:
            return FifoReport(False, f"token {tok:#x} delivered twice",
                              producers * ops_per_producer, len(sink))
        key = (consumer, pid)
        last = per_consumer_last.get(key, -1)
        if seq <= last:
            return FifoReport(
                False,
                f"consumer {consumer} saw producer {pid} seq {seq} after {last}",
                producers * ops_per_producer, len(sink))
        per_consumer_last[key] = seq
    expect = producers * ops_per_producer
    if len(sink) != expect:
        return FifoReport(False, f"{len(sink)}/{expect} tokens delivered",
                          expect, len(sink))
    return FifoReport(True, "exactly-once, in-order", expect, len(sink))


def run_balanced(queue: QueueAlgorithm, *, threads: int, ops: int,
                 policy: str = "gang", seed: int = 0, wave_size: int = 8,
                 max_steps: int = 5_000_000) -> Scheduler:
    """Paper's balanced kernel: every thread alternates enq/deq."""
    mem = AtomicMemory()
    queue.init(mem)
    sched = Scheduler(mem, wave_size=wave_size, policy=policy, seed=seed)
    for i in range(threads):
        sched.spawn(queue.worker_balanced, ops, (i << 16))
    sched.run(max_steps)
    return sched
