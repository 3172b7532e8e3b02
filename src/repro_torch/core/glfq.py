"""G-LFQ — the paper's bounded lock-free GPU queue (§ III-B, Algorithm 1).

A copy of ``repro/core/glfq.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

An sCQ-style bounded ring (2n physical slots, logical capacity n, threshold
empty-test) with the paper's two changes:

1. **Wave-batched ticket reservation** (WAVEFAA, Fig. 1 / Lemma III.1): hot
   Head/Tail counters receive one batched FAA per converged wave instead of
   one per thread.  In the simulator this is the ``ctx.wavefaa`` instruction;
   the scheduler forms the active mask exactly as a ballot would.
2. **Single 64-bit packed slot words** ``(Cycle, Safe, Enq, Index)`` with
   reduced-width cycle tags (Lemma III.2).

Notation follows Algorithm 1.  One deliberate reading of the paper's
line 18 condition ``(E.Safe ∨ Head < t)``: we implement the sCQ original
``Head ≤ t`` (the paper's strict ``<`` appears to be a transcription slip —
with ``<`` an enqueuer would refuse a slot whose matching dequeuer has not
been issued yet when ``Head == t``, needlessly failing; both are safe, only
``≤`` is live.  Flagged here per reproduction policy.)

Initialization follows sCQ: ``Head = Tail = 2n`` so the first tickets carry
cycle 1 while all slots start at cycle 0 (making ``E.Cycle < c`` hold).
"""

from __future__ import annotations

from .atomics import AtomicMemory
from .base import QueueAlgorithm, VAL_MASK
from .packed import EntryFormat
from .sim import Ctx

RETRY = "retry"
SUCCESS = "success"
EMPTY = "empty"

NEG1 = (1 << 64) - 1  # two's-complement -1 for FAA decrements


class GLFQ(QueueAlgorithm):
    name = "glfq"

    def __init__(self, capacity: int, num_threads: int, tag: str = "glfq",
                 prefill: int = 0, cycle_bits: int = 30,
                 max_attempts: int = 0) -> None:
        super().__init__(capacity, num_threads)
        self.tag = tag
        self.prefill = prefill
        self.fmt = EntryFormat(idx_bits=32, cycle_bits=cycle_bits)
        self.nslots = 2 * capacity           # ring of size 2n
        # 0 = unbounded retries (lock-free; termination relies on workload)
        self.max_attempts = max_attempts
        self.s_tail = f"{tag}_tail"
        self.s_head = f"{tag}_head"
        self.s_thresh = f"{tag}_thresh"
        self.s_entries = f"{tag}_entries"

    # -- geometry -------------------------------------------------------------

    def slot(self, t: int) -> int:
        return t % self.nslots

    def cycle(self, t: int) -> int:
        return (t // self.nslots) & self.fmt.cycle_mask

    @property
    def threshold_full(self) -> int:
        return 3 * self.capacity - 1  # sCQ: 3n - 1 for the 2n ring

    def init(self, mem: AtomicMemory) -> None:
        self.mem = mem
        f = self.fmt
        mem.alloc(self.s_tail, 1, fill=self.nslots)   # = 2n
        mem.alloc(self.s_head, 1, fill=self.nslots)
        mem.alloc(self.s_thresh, 1, fill=AtomicMemory.from_signed(-1))
        mem.alloc(self.s_entries, self.nslots, fill=f.pack(0, 1, 0, f.idx_bot))
        if self.prefill:
            assert self.prefill <= self.capacity
            entries = mem.array(self.s_entries)
            for i in range(self.prefill):
                t = self.nslots + i          # tickets 2n .. 2n+prefill-1
                entries[self.slot(t)] = f.pack(self.cycle(t), 1, 1, i)
            mem.array(self.s_tail)[0] = self.nslots + self.prefill
            mem.array(self.s_thresh)[0] = AtomicMemory.from_signed(self.threshold_full)

    # -- Algorithm 1: TRYENQ ----------------------------------------------------

    def _tryenq(self, ctx: Ctx, tid: int, value: int):
        f = self.fmt
        t = yield from ctx.wavefaa(self.s_tail, 0)
        j, c = self.slot(t), self.cycle(t)
        while True:  # sCQ re-reads the entry when its CAS loses a race
            e = yield from ctx.load(self.s_entries, j)
            if not (f.cycle_lt(f.cycle(e), c) and f.is_empty_idx(e)):
                return RETRY
            h = yield from ctx.load(self.s_head, 0)
            if not (f.safe(e) or h <= t):
                return RETRY
            new = f.pack(c, 1, 1, value)
            ok = yield from ctx.cas(self.s_entries, j, e, new)
            if ok:
                # reset Threshold to 3n-1 (Alg. 1 line 20)
                yield from ctx.store(
                    self.s_thresh, 0,
                    AtomicMemory.from_signed(self.threshold_full))
                return SUCCESS
            # CAS lost a race — re-examine the slot with the same ticket

    # -- Algorithm 1: TRYDEQ ------------------------------------------------------

    def _catchup(self, ctx: Ctx, target: int):
        """Catch Tail up to at least ``target`` (Alg. 1 line 43)."""
        while True:
            t = yield from ctx.load(self.s_tail, 0)
            if t >= target:
                return
            ok = yield from ctx.cas(self.s_tail, 0, t, target)
            if ok:
                return

    def _trydeq(self, ctx: Ctx, tid: int):
        f = self.fmt
        thr = yield from ctx.load(self.s_thresh, 0)
        if AtomicMemory.to_signed(thr) < 0:
            return (EMPTY, None)
        h = yield from ctx.wavefaa(self.s_head, 0)
        j, c = self.slot(h), self.cycle(h)
        while True:  # sCQ re-reads on a lost neutralize race: the concurrent
            # change may be the matching install, which we must then consume.
            e = yield from ctx.load(self.s_entries, j)
            if f.cycle_eq(f.cycle(e), c) and not f.is_empty_idx(e) and f.enq(e):
                old = yield from ctx.consume(self.s_entries, j, f)
                return (SUCCESS, f.idx(old))
            # Non-matching slot: neutralize so the matching enqueuer cannot
            # install late (Alg. 1 lines 36-40).
            if f.cycle_lt(f.cycle(e), c):
                if f.is_empty_idx(e):
                    # advance the cycle, keep Safe, leave ⊥
                    new = f.pack(c, f.safe(e), 0, f.idx_bot)
                else:
                    # stale live value: mark unsafe, preserve everything else
                    new = f.pack(f.cycle(e), 0, f.enq(e), f.idx(e))
                ok = yield from ctx.cas(self.s_entries, j, e, new)
                if not ok:
                    continue
            break
        # Empty detection (Alg. 1 lines 42-48).
        t = yield from ctx.load(self.s_tail, 0)
        if t <= h + 1:
            yield from self._catchup(ctx, h + 1)
            yield from ctx.faa(self.s_thresh, 0, NEG1)
            return (EMPTY, None)
        old_thr = yield from ctx.faa(self.s_thresh, 0, NEG1)
        if AtomicMemory.to_signed(old_thr) <= 0:
            return (EMPTY, None)
        return (RETRY, None)

    # -- public ops -----------------------------------------------------------------

    def enqueue(self, ctx: Ctx, tid: int, value: int):
        assert 0 <= value <= VAL_MASK
        attempts = 0
        while True:
            # Bounded-queue full pre-check (logical capacity n).  The check
            # is racy, but over-admission is safe: live slots are never
            # overwritten (install requires an empty index), and with the
            # paper's proof configuration k ≤ n the transient occupancy
            # n + k never exceeds the 2n physical slots.
            t = yield from ctx.load(self.s_tail, 0)
            h = yield from ctx.load(self.s_head, 0)
            if t - h >= self.capacity:
                return False
            r = yield from self._tryenq(ctx, tid, value)
            if r == SUCCESS:
                return True
            attempts += 1
            if self.max_attempts and attempts >= self.max_attempts:
                return False

    def dequeue(self, ctx: Ctx, tid: int):
        attempts = 0
        while True:
            r, v = yield from self._trydeq(ctx, tid)
            if r == SUCCESS:
                return (True, v)
            if r == EMPTY:
                return (False, None)
            attempts += 1
            if self.max_attempts and attempts >= self.max_attempts:
                return (False, None)
