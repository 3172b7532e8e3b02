"""G-WFQ-YMC — GPU adaptation of Yang & Mellor-Crummey's wait-free queue
(§ III-A), used by the paper as the reference wait-free design.

A copy of ``repro/core/ymc.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Structure follows YMC: an FAA-based fast path over an (logically unbounded)
cell sequence, per-thread request records, and cooperative helping for both
enqueue and dequeue; every thread checks one peer record every HELP_DELAY own
operations.  Per the paper's GPU adaptation, the dynamically-grown linked
segments are replaced by a **pre-allocated segment pool** with arithmetic
lookup — ``cell(t) = pool[t // SEG][t % SEG]`` — flattened here to one array.
As the paper notes (§ III-A-c), this does not make the design bounded-memory
in the wCQ sense; the pool must be sized for the run.

Cell-word states (single 64-bit word per cell):

* ``BOT``          — empty (never written),
* value ``v+1``    — deposited payload,
* ``TOP``          — invalidated (a dequeuer passed an empty cell),
* ``TOPC``         — consumed,
* ``RESERVED(o,s)``— reserved for enqueue request (o, s) by a helper,
* ``TAKEN(v,o,s)`` — value v committed to dequeue request (o, s); carries the
                     value so any thread can finish the delivery (the
                     single-word substitute for YMC's pointer-based helping).

Exactly-once helping commits:
* slow enqueue — the CAS on the owner's *claim word* picks the single cell
  that will carry the value; helper-reserved cells that lose become ``TOP``;
* slow dequeue — helpers cooperate on one announced candidate cell; the CAS
  ``value → TAKEN(v,o,s)`` is the unique take, and the result word is filled
  from the marker.
"""

from __future__ import annotations

from .atomics import AtomicMemory
from .base import QueueAlgorithm, VAL_MASK
from .packed import MASK64, RequestFormat, ResultFormat
from .sim import Ctx

RQ = RequestFormat()
RS = ResultFormat()

BOT = 0
TOP = MASK64
TOPC = MASK64 - 1

_TAKEN_BIT = 1 << 63
_RES_BIT = 1 << 62


def _val_word(v: int) -> int:
    return v + 1  # 1..2^31 — disjoint from markers and BOT


def _is_val(w: int) -> bool:
    return 0 < w <= (VAL_MASK + 1)


def _reserved(owner: int, seq: int) -> int:
    return _RES_BIT | ((owner & 0xFFFF) << 16) | (seq & 0xFFFF)


def _is_reserved(w: int) -> bool:
    return bool(w & _RES_BIT) and not (w & _TAKEN_BIT)


def _res_owner(w: int):
    return (w >> 16) & 0xFFFF, w & 0xFFFF


def _taken(v: int, owner: int, seq: int) -> int:
    return _TAKEN_BIT | ((v & 0x7FFFFFFF) << 32) | ((owner & 0xFFFF) << 16) | (seq & 0xFFFF)


def _is_taken(w: int) -> bool:
    return bool(w & _TAKEN_BIT) and w not in (TOP, TOPC)


def _taken_fields(w: int):
    return (w >> 32) & 0x7FFFFFFF, (w >> 16) & 0xFFFF, w & 0xFFFF


# claim word: [cell:45 | seq:16 | claimed:1]
def _claim_pack(cell: int, seq: int, claimed: int) -> int:
    return ((cell & ((1 << 45) - 1)) << 17) | ((seq & 0xFFFF) << 1) | (claimed & 1)


def _claim_fields(w: int):
    return (w >> 17) & ((1 << 45) - 1), (w >> 1) & 0xFFFF, w & 1


# dequeue request word: [cand:45 | seq:16 | pending:1 | pad:1]
def _dreq_pack(cand: int, seq: int, pending: int) -> int:
    return ((cand & ((1 << 45) - 1)) << 18) | ((seq & 0xFFFF) << 2) | ((pending & 1) << 1)


def _dreq_fields(w: int):
    return (w >> 18) & ((1 << 45) - 1), (w >> 2) & 0xFFFF, (w >> 1) & 1


class YMC(QueueAlgorithm):
    name = "gwfq-ymc"

    def __init__(self, capacity: int, num_threads: int, tag: str = "ymc",
                 prefill: int = 0, pool_factor: int = 64, seg_size: int = 256,
                 patience: int = 8, help_delay: int = 64,
                 spin_before_invalidate: int = 4) -> None:
        super().__init__(capacity, num_threads)
        self.tag = tag
        self.prefill = prefill
        self.seg_size = seg_size
        # capacity here bounds nothing (YMC is not bounded-memory); the pool
        # is sized by expected total operations.
        self.pool = capacity * pool_factor
        self.patience = patience
        self.help_delay = help_delay
        self.spin = spin_before_invalidate
        t = tag
        self.s_cells = f"{t}_cells"
        self.s_tail, self.s_head = f"{t}_tail", f"{t}_head"
        self.s_ereq, self.s_eclaim = f"{t}_ereq", f"{t}_eclaim"
        self.s_dreq, self.s_dres = f"{t}_dreq", f"{t}_dres"
        self._seq = [0] * num_threads
        self._opct = [0] * num_threads
        self._peer = [(i + 1) % max(num_threads, 1) for i in range(num_threads)]

    def init(self, mem: AtomicMemory) -> None:
        self.mem = mem
        mem.alloc(self.s_cells, self.pool, fill=BOT)
        mem.alloc(self.s_tail, 1, fill=self.prefill)
        mem.alloc(self.s_head, 1, fill=0)
        mem.alloc(self.s_ereq, self.num_threads)
        mem.alloc(self.s_eclaim, self.num_threads)
        mem.alloc(self.s_dreq, self.num_threads)
        mem.alloc(self.s_dres, self.num_threads)
        if self.prefill:
            cells = mem.array(self.s_cells)
            for i in range(self.prefill):
                cells[i] = _val_word(i)

    # -- shared cell resolution helpers ---------------------------------------

    def _resolve_reserved(self, ctx: Ctx, i: int, w: int):
        """A RESERVED(o,s) cell: install the value if the claim names this
        cell, otherwise invalidate."""
        o, s = _res_owner(w)
        cl = yield from ctx.load(self.s_eclaim, o)
        cell, cseq, claimed = _claim_fields(cl)
        rq = yield from ctx.load(self.s_ereq, o)
        if cseq == s and claimed and cell == i and RQ.seq(rq) == s:
            yield from ctx.cas(self.s_cells, i, w, _val_word(RQ.value(rq)))
        elif cseq == s and not claimed:
            # claim undecided: decide it in this cell's favor
            won = yield from ctx.cas(self.s_eclaim, o, cl, _claim_pack(i, s, 1))
            if won:
                yield from ctx.cas(self.s_cells, i, w, _val_word(RQ.value(rq)))
            # else: re-read on the caller's next iteration
        else:
            # claim went to another cell (or a different request): release
            yield from ctx.cas(self.s_cells, i, w, TOP)

    def _finish_taken(self, ctx: Ctx, i: int, w: int):
        """A TAKEN(v,o,s) cell: complete the delivery and clean up."""
        v, o, s = _taken_fields(w)
        r = yield from ctx.load(self.s_dres, o)
        if RS.seq(r) == s and not RS.done(r):
            yield from ctx.cas(self.s_dres, o, r, RS.pack(v, s, 1, 0))
        yield from ctx.cas(self.s_cells, i, w, TOPC)

    # -- helping ------------------------------------------------------------------

    def _maybe_help(self, ctx: Ctx, tid: int):
        self._opct[tid] += 1
        if self.num_threads <= 1 or self._opct[tid] % self.help_delay:
            return
        p = self._peer[tid]
        self._peer[tid] = (p + 1) % self.num_threads
        if p == tid:
            return
        erq = yield from ctx.load(self.s_ereq, p)
        if RQ.pending(erq):
            yield from self._help_enq(ctx, p, RQ.seq(erq), RQ.value(erq), budget=8)
        drq = yield from ctx.load(self.s_dreq, p)
        _, ds, dp = _dreq_fields(drq)
        if dp:
            yield from self._help_deq(ctx, p, ds, budget=16)

    def _help_enq(self, ctx: Ctx, o: int, s: int, v: int, budget: int):
        for _ in range(budget):
            rq = yield from ctx.load(self.s_ereq, o)
            if RQ.seq(rq) != s or not RQ.pending(rq):
                return True
            cl = yield from ctx.load(self.s_eclaim, o)
            cell, cseq, claimed = _claim_fields(cl)
            if cseq == s and claimed:
                w = yield from ctx.load(self.s_cells, cell)
                if _is_reserved(w) and _res_owner(w) == (o, s):
                    yield from ctx.cas(self.s_cells, cell, w, _val_word(v))
                return True  # installed (or already a value/consumed)
            # reserve a fresh cell on the owner's behalf
            t = yield from ctx.faa(self.s_tail, 0, 1)
            if t >= self.pool:
                return True  # pool exhausted; the owner resolves
            won = yield from ctx.cas(self.s_cells, t, BOT, _reserved(o, s))
            if not won:
                continue
            claimed_now = yield from ctx.cas(self.s_eclaim, o, cl, _claim_pack(t, s, 1))
            if claimed_now:
                yield from ctx.cas(self.s_cells, t, _reserved(o, s), _val_word(v))
                return True
            yield from ctx.cas(self.s_cells, t, _reserved(o, s), TOP)
        return False

    def _help_deq(self, ctx: Ctx, o: int, s: int, budget: int):
        for _ in range(budget):
            r = yield from ctx.load(self.s_dres, o)
            if RS.seq(r) != s or RS.done(r):
                return True
            drq = yield from ctx.load(self.s_dreq, o)
            cand, dseq, pending = _dreq_fields(drq)
            if dseq != s or not pending:
                return True
            t_now = yield from ctx.load(self.s_tail, 0)
            if cand >= min(t_now, self.pool):
                # all candidate cells dead & none beyond tail: EMPTY
                yield from ctx.cas(self.s_dres, o, r, RS.pack(0, s, 1, 1))
                return True
            w = yield from ctx.load(self.s_cells, cand)
            if _is_val(w):
                # unique commit: value → TAKEN(v, o, s)
                yield from ctx.cas(self.s_cells, cand, w, _taken(w - 1, o, s))
                w2 = yield from ctx.load(self.s_cells, cand)
                if _is_taken(w2):
                    yield from self._finish_taken(ctx, cand, w2)
                continue
            if _is_taken(w):
                yield from self._finish_taken(ctx, cand, w)
                continue
            if _is_reserved(w):
                yield from self._resolve_reserved(ctx, cand, w)
                continue
            if w == BOT:
                yield from ctx.cas(self.s_cells, cand, BOT, TOP)
                continue
            # dead cell (TOP/TOPC): advance the shared candidate
            yield from ctx.cas(self.s_dreq, o, drq, _dreq_pack(cand + 1, s, 1))
        return False

    # -- public operations -------------------------------------------------------

    def enqueue(self, ctx: Ctx, tid: int, value: int):
        assert 0 <= value <= VAL_MASK
        yield from self._maybe_help(ctx, tid)
        for _ in range(self.patience):
            t = yield from ctx.faa(self.s_tail, 0, 1)
            if t >= self.pool:
                return False  # segment pool exhausted (unbounded design)
            ok = yield from ctx.cas(self.s_cells, t, BOT, _val_word(value))
            if ok:
                return True
        # slow path: publish request, then drive/help it to completion
        self._seq[tid] = (self._seq[tid] + 1) & 0xFFFF
        s = self._seq[tid]
        yield from ctx.store(self.s_eclaim, tid, _claim_pack(0, s, 0))
        yield from ctx.store(self.s_ereq, tid, RQ.pack(value, s, 1, 1))
        while True:
            done = yield from self._help_enq(ctx, tid, s, value, budget=64)
            cl = yield from ctx.load(self.s_eclaim, tid)
            cell, cseq, claimed = _claim_fields(cl)
            if cseq == s and claimed:
                # ensure the value is actually installed before retiring
                w = yield from ctx.load(self.s_cells, cell)
                if _is_reserved(w) and _res_owner(w) == (tid, s):
                    yield from ctx.cas(self.s_cells, cell, w, _val_word(value))
                yield from ctx.store(self.s_ereq, tid, RQ.pack(value, s, 0, 1))
                return True
            t_now = yield from ctx.load(self.s_tail, 0)
            if t_now >= self.pool and not claimed:
                yield from ctx.store(self.s_ereq, tid, RQ.pack(value, s, 0, 1))
                return False
            if done:
                yield from ctx.step()

    def dequeue(self, ctx: Ctx, tid: int):
        yield from self._maybe_help(ctx, tid)
        for _ in range(self.patience):
            h = yield from ctx.faa(self.s_head, 0, 1)
            if h >= self.pool:
                return (False, None)
            t_now = yield from ctx.load(self.s_tail, 0)
            if h >= t_now:
                # overshot: invalidate so a late enqueue cannot strand a value
                ok = yield from ctx.cas(self.s_cells, h, BOT, TOP)
                if ok:
                    return (False, None)  # EMPTY (linearizes at the tail load)
                # a value (or reservation) landed meanwhile — fall through
            spins = 0
            while True:
                w = yield from ctx.load(self.s_cells, h)
                if _is_val(w):
                    ok = yield from ctx.cas(self.s_cells, h, w, TOPC)
                    if ok:
                        return (True, w - 1)
                    continue
                if _is_taken(w):
                    yield from self._finish_taken(ctx, h, w)
                    continue
                if _is_reserved(w):
                    yield from self._resolve_reserved(ctx, h, w)
                    continue
                if w == BOT:
                    spins += 1
                    if spins <= self.spin:
                        yield from ctx.step()
                        continue
                    ok = yield from ctx.cas(self.s_cells, h, BOT, TOP)
                    if ok:
                        break  # cell dead; take a new ticket
                    continue
                break  # TOP/TOPC: dead ticket; retry
        # slow path
        self._seq[tid] = (self._seq[tid] + 1) & 0xFFFF
        s = self._seq[tid]
        h0 = yield from ctx.load(self.s_head, 0)
        yield from ctx.store(self.s_dres, tid, RS.pack(0, s, 0, 0))
        yield from ctx.store(self.s_dreq, tid, _dreq_pack(h0, s, 1))
        while True:
            yield from self._help_deq(ctx, tid, s, budget=256)
            r = yield from ctx.load(self.s_dres, tid)
            if RS.seq(r) == s and RS.done(r):
                yield from ctx.store(self.s_dreq, tid, _dreq_pack(0, s, 0))
                if RS.empty(r):
                    return (False, None)
                return (True, RS.value(r))
            yield from ctx.step()
