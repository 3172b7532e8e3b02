"""G-PQ — wave-batched bounded concurrent priority queue (DESIGN.md § 5.1).

A copy of ``repro/sched/gpq.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

The FIFO family reserves *slots* with one WAVEFAA per converged wave; a
priority queue cannot pre-assign slots (the position of a key is data-
dependent), so G-PQ batches at a different point: inserts reserve a ticket
in a bounded **announce ring** with one WAVEFAA per converged wave and
publish a packed 64-bit ``(epoch, valid, key, idx)`` node word into their
ticket's slot — single-writer per (slot, epoch) by Lemma III.1 ticket
uniqueness, exactly the ring-slot discipline of the FIFO queues.  The
**applied heap** (a d-ary min-heap over the same packed node words) is
advanced by whichever consumer holds the heap latch: before popping it
*drains* the announce ring in ticket order, applying the whole batch of
announced inserts under one latch acquisition — flat combining, the
consumer-side analogue of wave batching.

Linearization points:

* ``insert`` — the WAVEFAA ticket reservation (the announce install is
  completed before the operation returns, so every insert that returned is
  visible to any later drain);
* ``delete_min`` — the drain's read of the announce tail under the latch:
  the pop returns the minimum over every insert ticketed before that read
  minus those already popped, i.e. a minimal pending key (0-relaxed);
* ``delete_min → EMPTY`` — the same tail read, at which point the applied
  heap was empty and every announced ticket was drained.

A ``lazy`` parameter weakens the drain: backlogs of at most ``lazy``
announced-but-unapplied inserts may be skipped before a pop, so a returned
key may ignore up to ``lazy`` smaller pending inserts — the per-ring
relaxation used by ``relaxed.RelaxedGPQ`` (strict G-PQ is ``lazy=0``).

A per-queue **min-hint** word publishes a lower-bound estimate of the
current minimum key: inserts CAS-min it down before returning; a pop
raises it (single CAS attempt; losing the race leaves the hint stale-low,
which is always safe — consumers use hints only to order scans, never to
skip correctness work).  ``PriorityFabric`` orders shard scans by hint, so
work stealing takes the highest-priority shard first.

Histories are bracketed with ``op_begin``/``op_end`` using the § IV event
format extended to priority semantics: op 0 = INS with ``arg=(key, ident)``,
op 1 = DELMIN with ``ret=(key, ident)`` (or None for EMPTY); see
``sched.plinearizability`` for the checker.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.atomics import AtomicMemory
from ..core.sim import Ctx

# History op codes (aliases of the § IV ENQ/DEQ slots: 0 = insert,
# 1 = delete-min).
INS, DELMIN = 0, 1

NEG1 = (1 << 64) - 1  # two's-complement -1 for FAA decrements
MASK64 = NEG1


@dataclass(frozen=True)
class NodeFormat:
    """Packed 64-bit heap/announce node word (Lemma III.2 style):

        [ epoch : EPOCH_BITS | valid : 1 | key : KEY_BITS | idx : IDX_BITS ]

    ``epoch`` versions an announce slot across ring wrap-arounds (the
    reduced-width cycle tag of the FIFO rings, applied to the announce
    ring); ``valid`` flags an installed-but-undrained announce; ``key`` is
    the priority (smaller = more urgent); ``idx`` the payload index."""

    epoch_bits: int = 12
    key_bits: int = 27
    idx_bits: int = 24

    @property
    def epoch_mask(self) -> int:
        return (1 << self.epoch_bits) - 1

    @property
    def key_mask(self) -> int:
        return (1 << self.key_bits) - 1

    @property
    def idx_mask(self) -> int:
        return (1 << self.idx_bits) - 1

    @property
    def key_inf(self) -> int:
        """Hint value for "no pending key" (an unreachable key)."""
        return self.key_mask

    @property
    def valid_shift(self) -> int:
        return self.key_bits + self.idx_bits

    @property
    def epoch_shift(self) -> int:
        return self.valid_shift + 1

    def pack(self, epoch: int, valid: int, key: int, idx: int) -> int:
        assert 0 <= key <= self.key_mask and 0 <= idx <= self.idx_mask
        return (((epoch & self.epoch_mask) << self.epoch_shift)
                | ((valid & 1) << self.valid_shift)
                | ((key & self.key_mask) << self.idx_bits)
                | (idx & self.idx_mask)) & MASK64

    def epoch(self, word: int) -> int:
        return (word >> self.epoch_shift) & self.epoch_mask

    def valid(self, word: int) -> int:
        return (word >> self.valid_shift) & 1

    def key(self, word: int) -> int:
        return (word >> self.idx_bits) & self.key_mask

    def idx(self, word: int) -> int:
        return word & self.idx_mask


NODE = NodeFormat()


class GPQ:
    """Bounded concurrent min-priority queue: wave-batched announce ring +
    latch-combined d-ary applied heap.

    Public generator API (driven by ``core.sim.Scheduler``):

    * ``insert(ctx, tid, key, idx)`` → bool (False = full),
    * ``delete_min(ctx, tid)`` → (True, (key, idx)) or (False, None) EMPTY,
    * ``peek_hint(ctx, tid)`` → current min-key hint (scan ordering only).

    The unbracketed internals (``reserve``/``announce_install``/
    ``pop_once``) are reused by ``RelaxedGPQ``, which does its own history
    bracketing across rings.
    """

    name = "gpq"

    def __init__(self, capacity: int, num_threads: int, tag: str = "gpq",
                 *, arity: int = 4, lazy: int = 0,
                 fmt: NodeFormat = NODE) -> None:
        assert arity >= 2
        self.capacity = capacity
        self.num_threads = num_threads
        self.tag = tag
        self.arity = arity
        self.lazy = lazy
        self.fmt = fmt
        # Announce ring sized so a full queue of live-but-undrained inserts
        # can never wrap onto an unconsumed slot (insert would otherwise
        # have to block on a drain that might never come).
        self.announce_slots = capacity + num_threads
        # Heap headroom for the transient count overshoot of concurrent
        # reservations (each backs off, but holds a slot meanwhile).
        self.heap_slots = capacity + num_threads
        self.mem: AtomicMemory | None = None
        self.s_lock = f"{tag}_lock"
        self.s_atail = f"{tag}_atail"
        self.s_ahead = f"{tag}_ahead"
        self.s_ann = f"{tag}_ann"
        self.s_heap = f"{tag}_heap"
        self.s_size = f"{tag}_size"
        self.s_count = f"{tag}_count"
        self.s_hint = f"{tag}_hint"

    def init(self, mem: AtomicMemory) -> None:
        self.mem = mem
        f = self.fmt
        mem.alloc(self.s_lock, 1, fill=0)
        mem.alloc(self.s_atail, 1, fill=0)
        mem.alloc(self.s_ahead, 1, fill=0)
        mem.alloc(self.s_ann, self.announce_slots, fill=f.pack(0, 0, 0, 0))
        mem.alloc(self.s_heap, self.heap_slots, fill=0)
        mem.alloc(self.s_size, 1, fill=0)
        mem.alloc(self.s_count, 1, fill=0)
        mem.alloc(self.s_hint, 1, fill=f.key_inf)

    # -- unbracketed internals (shared with RelaxedGPQ) ----------------------

    def reserve(self, ctx: Ctx, tid: int):
        """Capacity reservation on the pending-element counter.  Returns
        True if a slot was reserved (must be paid back by a pop or an
        unreserve on failure)."""
        old = yield from ctx.faa(self.s_count, 0, 1)
        if old >= self.capacity:
            yield from ctx.faa(self.s_count, 0, NEG1)
            return False
        return True

    def announce_install(self, ctx: Ctx, tid: int, key: int, idx: int):
        """WAVEFAA ticket + packed node install + hint publication.  The
        caller must hold a successful ``reserve``."""
        f = self.fmt
        t = yield from ctx.wavefaa(self.s_atail, 0)
        j = t % self.announce_slots
        e = (t // self.announce_slots + 1) & f.epoch_mask
        prev_e = (e - 1) & f.epoch_mask
        while True:
            w = yield from ctx.load(self.s_ann, j)
            if f.valid(w) == 0 and f.epoch(w) == prev_e:
                break
            yield from ctx.step()      # previous epoch not yet drained
        yield from ctx.store(self.s_ann, j, f.pack(e, 1, key, idx))
        # Publish a min-key lower bound before returning: every *completed*
        # insert is hinted, so hint-ordered scans see it.
        while True:
            h = yield from ctx.load(self.s_hint, 0)
            if key >= h:
                break
            ok = yield from ctx.cas(self.s_hint, 0, h, key)
            if ok:
                break
        return t

    def _heap_sift_up(self, ctx: Ctx, pos: int, word: int):
        f, d = self.fmt, self.arity
        key = f.key(word)
        j = pos
        while j > 0:
            p = (j - 1) // d
            pw = yield from ctx.load(self.s_heap, p)
            if f.key(pw) <= key:
                break
            yield from ctx.store(self.s_heap, j, pw)
            j = p
        yield from ctx.store(self.s_heap, j, word)

    def _heap_sift_down(self, ctx: Ctx, size: int, word: int):
        f, d = self.fmt, self.arity
        key = f.key(word)
        j = 0
        while True:
            base = j * d + 1
            if base >= size:
                break
            best_k, best_j, best_w = None, -1, 0
            for c in range(base, min(base + d, size)):
                cw = yield from ctx.load(self.s_heap, c)
                ck = f.key(cw)
                if best_k is None or ck < best_k:
                    best_k, best_j, best_w = ck, c, cw
            if best_k is None or best_k >= key:
                break
            yield from ctx.store(self.s_heap, j, best_w)
            j = best_j
        yield from ctx.store(self.s_heap, j, word)

    def _drain(self, ctx: Ctx, *, force: bool):
        """Apply announced inserts to the heap in ticket order (latch held).
        With ``lazy > 0`` and ``force=False``, backlogs of at most ``lazy``
        are deferred."""
        f = self.fmt
        tail = yield from ctx.load(self.s_atail, 0)
        head = yield from ctx.load(self.s_ahead, 0)
        if tail == head:
            return head, 0, tail
        if not force and (tail - head) <= self.lazy:
            return head, tail - head, tail
        size = yield from ctx.load(self.s_size, 0)
        for h in range(head, tail):
            j = h % self.announce_slots
            e = (h // self.announce_slots + 1) & f.epoch_mask
            while True:
                w = yield from ctx.load(self.s_ann, j)
                if f.valid(w) and f.epoch(w) == e:
                    break
                yield from ctx.step()  # ticket reserved, install in flight
            yield from ctx.store(self.s_ann, j, f.pack(e, 0, 0, 0))
            yield from self._heap_sift_up(ctx, size, w)
            size += 1
        yield from ctx.store(self.s_size, 0, size)
        yield from ctx.store(self.s_ahead, 0, tail)
        return tail, 0, tail

    def pop_once(self, ctx: Ctx, tid: int):
        """One latch acquisition: drain, then pop the applied minimum.
        Returns (key, idx) or None (nothing applied and nothing announced).
        Does NOT touch the pending counter or the history."""
        f = self.fmt
        while True:
            ok = yield from ctx.cas(self.s_lock, 0, 0, 1)
            if ok:
                break
            yield from ctx.step()
        size = yield from ctx.load(self.s_size, 0)
        force = size == 0          # never report EMPTY past undrained work
        head, backlog, tail_seen = yield from self._drain(ctx, force=force)
        size = yield from ctx.load(self.s_size, 0)
        if size == 0:
            # Fully drained and empty: publish the EMPTY hint — after
            # re-scanning tickets announced since the drain's tail read,
            # so the raise cannot erase a fresh insert's publication.
            new_hint = f.key_inf
            tail_now = yield from ctx.load(self.s_atail, 0)
            for t in range(tail_seen, tail_now):
                j = t % self.announce_slots
                e = (t // self.announce_slots + 1) & f.epoch_mask
                w = yield from ctx.load(self.s_ann, j)
                if f.valid(w) and f.epoch(w) == e:
                    new_hint = min(new_hint, f.key(w))
            h = yield from ctx.load(self.s_hint, 0)
            if h != new_hint:
                yield from ctx.cas(self.s_hint, 0, h, new_hint)
            yield from ctx.store(self.s_lock, 0, 0)
            return None
        root = yield from ctx.load(self.s_heap, 0)
        last = yield from ctx.load(self.s_heap, size - 1)
        size -= 1
        yield from ctx.store(self.s_size, 0, size)
        if size > 0:
            yield from self._heap_sift_down(ctx, size, last)
        # Recompute the ring's min-key estimate: the applied root, min'd
        # with every announced key the drain did not apply — the (≤ lazy)
        # skipped backlog plus any announce ticketed after the drain's
        # tail read (whose publication this raise could otherwise erase).
        # Published with a single CAS: if a racing insert's lower CAS-min
        # lands between our load and CAS, our CAS fails and the lower
        # value sticks.  A mid-install slot (ticket reserved, word not yet
        # stored) can still slip a narrow window — its key is unreadable
        # here and its own CAS-min may load our pre-raise value — so the
        # hint is a *scan-ordering heuristic*, never a correctness input:
        # consumers scan every shard/ring regardless, pops always drain
        # before popping or declaring EMPTY, and the relaxed envelope
        # (relaxed.py) already charges sibling-ring publication races.
        new_hint = f.key_inf
        if size > 0:
            nw = yield from ctx.load(self.s_heap, 0)
            new_hint = f.key(nw)
        tail_now = yield from ctx.load(self.s_atail, 0)
        for t in list(range(head, head + backlog)) + list(range(tail_seen,
                                                                tail_now)):
            j = t % self.announce_slots
            e = (t // self.announce_slots + 1) & f.epoch_mask
            w = yield from ctx.load(self.s_ann, j)
            if f.valid(w) and f.epoch(w) == e:
                new_hint = min(new_hint, f.key(w))
        h = yield from ctx.load(self.s_hint, 0)
        yield from ctx.cas(self.s_hint, 0, h, new_hint)
        yield from ctx.store(self.s_lock, 0, 0)
        return (f.key(root), f.idx(root))

    def unreserve(self, ctx: Ctx, tid: int):
        yield from ctx.faa(self.s_count, 0, NEG1)

    # -- bracketed public operations -----------------------------------------

    def insert(self, ctx: Ctx, tid: int, key: int, idx: int):
        assert 0 <= key < self.fmt.key_inf, "key out of NodeFormat range"
        assert 0 <= idx <= self.fmt.idx_mask
        yield from ctx.op_begin(INS, (key, idx))
        ok = yield from self.reserve(ctx, tid)
        if not ok:
            yield from ctx.op_end(False, False)
            return False
        yield from self.announce_install(ctx, tid, key, idx)
        yield from ctx.op_end(True, True)
        return True

    def delete_min(self, ctx: Ctx, tid: int):
        yield from ctx.op_begin(DELMIN, None)
        c = yield from ctx.load(self.s_count, 0)
        if c == 0:
            yield from ctx.op_end(None, True)
            return (False, None)
        got = yield from self.pop_once(ctx, tid)
        if got is None:
            # Nothing announced at the drain's tail read: every element in
            # ``count`` was an insert that had not completed — EMPTY is a
            # valid linearization at that read.
            yield from ctx.op_end(None, True)
            return (False, None)
        yield from ctx.faa(self.s_count, 0, NEG1)
        yield from ctx.op_end(got, True)
        return (True, got)

    def peek_hint(self, ctx: Ctx, tid: int):
        h = yield from ctx.load(self.s_hint, 0)
        return h
