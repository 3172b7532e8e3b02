"""SFQ — the Scogland–Feng ticketed ring queue (ICPE'15), the paper's GPU
baseline.

A copy of ``repro/core/sfq.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Enqueue side: FAA ticket into a fixed ring; each slot carries a *turn*
counter; the producer spins until the slot's turn reaches its cycle (the
blocking interface of the original paper).  A size pre-check provides the
separate non-waiting interface ("for cases where waiting is undesirable").

Dequeue side: CAS-claim on the shared head — deliberately the more
*serialized* side, matching § VI-C-d ("per-operation cost is dominated by the
serialization of its dequeue side"), which is what makes SFQ collapse under
split producer/consumer loads.

Slot word layout: [ turn : 32 | value : 32 ].
"""

from __future__ import annotations

from .base import QueueAlgorithm, VAL_MASK
from .sim import Ctx


def _pack(turn: int, value: int) -> int:
    return ((turn & 0xFFFFFFFF) << 32) | (value & 0xFFFFFFFF)


def _turn(word: int) -> int:
    return (word >> 32) & 0xFFFFFFFF


def _value(word: int) -> int:
    return word & 0xFFFFFFFF


class SFQ(QueueAlgorithm):
    name = "sfq"

    def __init__(self, capacity: int, num_threads: int, tag: str = "sfq",
                 prefill: int = 0, max_spin: int = 4096) -> None:
        super().__init__(capacity, num_threads)
        self.tag = tag
        self.prefill = prefill
        self.max_spin = max_spin
        self.s_tail = f"{tag}_tail"
        self.s_head = f"{tag}_head"
        self.s_slots = f"{tag}_slots"

    def init(self, mem) -> None:
        self.mem = mem
        n = self.capacity
        mem.alloc(self.s_tail, 1, fill=self.prefill)
        mem.alloc(self.s_head, 1, fill=0)
        mem.alloc(self.s_slots, n)
        slots = mem.array(self.s_slots)
        for j in range(n):
            if j < self.prefill:
                slots[j] = _pack(1, j)       # pre-filled with index j
            else:
                slots[j] = _pack(0, 0)       # turn 0 == empty, cycle 0

    # turn protocol: slot j is writable for ticket t (j = t % n) when
    # turn == 2*(t//n); after the write turn becomes 2*(t//n)+1 (readable);
    # after consumption turn becomes 2*(t//n)+2 == writable for next cycle.

    def enqueue(self, ctx: Ctx, tid: int, value: int):
        n = self.capacity
        # Non-waiting interface: reject when full (head read first: head only
        # grows, so tail - head over-approximates the occupancy).
        h = yield from ctx.load(self.s_head, 0)
        t_now = yield from ctx.load(self.s_tail, 0)
        if t_now - h >= n:
            return False
        t = yield from ctx.faa(self.s_tail, 0, 1)
        j = t % n
        want = 2 * (t // n)
        spins = 0
        while True:
            w = yield from ctx.load(self.s_slots, j)
            if _turn(w) == want:
                yield from ctx.store(self.s_slots, j, _pack(want + 1, value & VAL_MASK))
                return True
            # Blocking interface: the ticket cannot be abandoned — spin.
            spins += 1
            yield from ctx.step()
            if spins > self.max_spin:
                # pathological backpressure; keep spinning but let the
                # scheduler's step budget end fixed-duration runs.
                spins = 0

    def dequeue(self, ctx: Ctx, tid: int):
        n = self.capacity
        while True:
            h = yield from ctx.load(self.s_head, 0)
            t = yield from ctx.load(self.s_tail, 0)
            if t <= h:
                return (False, None)  # observed empty (head monotone ⇒ sound)
            j = h % n
            want = 2 * (h // n) + 1
            w = yield from ctx.load(self.s_slots, j)
            turn = _turn(w)
            if turn == want - 1:
                # The head producer holds ticket h but has not published its
                # store yet.  Returning EMPTY here is NOT linearizable when
                # later slots already hold completed enqueues (FIFO blocks
                # them behind h), so the blocking interface spins — this
                # head-of-line wait is exactly the serialization that makes
                # SFQ collapse under asymmetric loads (§ VI-C-d).
                yield from ctx.step()
                continue
            if turn != want:
                continue  # stale head snapshot; retry
            # CAS-claim the head (serialized dequeue side).
            ok = yield from ctx.cas(self.s_head, 0, h, h + 1)
            if not ok:
                continue
            value = _value(w)
            # release the slot for the next cycle
            yield from ctx.store(self.s_slots, j, _pack(want + 1, 0))
            return (True, value)
