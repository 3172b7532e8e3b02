"""G-WFQ — the paper's bounded wait-free GPU queue (§ III-C, Algorithm 2).

A copy of ``repro/core/gwfq.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

Fast path = G-LFQ's wave-batched ring, bounded by compile-time *patience*
constants.  After patience is exhausted, the operation publishes a fixed
per-thread request record and enters the cooperative slow path, where peers
help it to completion.  Every ``HELP_DELAY`` (= the paper's D) own operations
each thread inspects one peer record and drives whatever request it finds —
helper identity/kind is immaterial (see ``_maybe_help``).

Single-word shared state (Lemma III.5)
--------------------------------------
* global Head/Tail words pack ``(cnt, ThrIdx)`` (Fig. 3),
* per-thread local head/tail words pack ``(lcnt, seq, INC, FIN)``,
* request/result/note words are seq-tagged so stale helpers always fail
  their CASes (§ III-C-c publication discipline),
* ring entries pack ``(Cycle, Safe, Enq, Index)`` (Fig. 2).

Where wCQ publishes a *pointer to the request record* in the ring slot via
CAS2, G-WFQ stores an **owner tag** in the Index field of a not-yet-visible
entry (``Enq = 0``): any thread that encounters the pending entry can look up
the owner's request record and finalize it.  The Enq-bit 0→1 update makes the
entry visible to fast-path dequeues and does not move the linearization point
(§ III-C-e).

Round protocol and its invariants (validated by the linearizability tests):

1. **One increment per round** (Lemma III.7).  Enqueue rounds obtain their
   ticket through SLOWFAA (Algorithm 2): helpers race the global CAS
   ``⟨c, NULL⟩ → ⟨c+1, h⟩``; the winner's phase-2 record names the owner,
   seq and ticket, and the ticket is recorded into the owner's local word by
   a seq/INC-guarded CAS — exactly one increment and one record per round.
   Dequeue rounds perform exactly one FAA each (see point 5).
2. **The entry word is the round's commit object.**  A slow enqueue round
   succeeds iff the entry at (slot, cycle) reaches the visible state
   ``(c, *, 1, v)`` (or its consumed successor), and fails iff the entry
   reaches a state from which that is unreachable (⊥ at cycle c, or a newer
   cycle).  Both verdict states are permanent, so helpers cannot disagree.
3. **done-before-visible**: whoever flips Enq 0→1 must first CAS the owner's
   result word to *done* — hence any consumed/recycled entry implies the
   request was completed, which is what lets a late helper distinguish
   "succeeded then recycled" from "never installed" (no duplicate installs).
4. **Stale-slot exclusion** (Lemma III.8): a round failure is noted in the
   owner's Note word (as the failed *ticket*); later helpers for the same
   request skip the ruled-out slot and proceed directly to the next round.
5. **Head tickets are never dropped.**  A cooperative-CAS increment of Head
   can orphan a ticket (the increment lands, but the request completes
   through an earlier round before the ticket is recorded).  An unexercised
   *tail* ticket is benign — its slot simply stays empty and the matching
   dequeuer neutralizes it — but an unexercised *head* ticket strands any
   value later installed at its slot (nobody else will ever visit it).
   wCQ closes this with CAS2 (counter and helper state move together);
   with single-width atomics we instead keep Algorithm 2's SLOWFAA for
   Tail, and give Head rounds a claim discipline: the request's local-head
   INC bit is the round claim, the claim winner performs exactly one FAA,
   exercises the ticket's slot to a terminal state itself, and is the only
   thread allowed to deliver into the result word — so every consumed value
   has exactly one recipient and the delivering CAS cannot fail.  This
   deviation from Algorithm 2 is recorded in DESIGN.md § 1.
"""

from __future__ import annotations

from .atomics import AtomicMemory
from .base import QueueAlgorithm, VAL_MASK
from .glfq import NEG1, RETRY, SUCCESS, EMPTY
from .packed import (EntryFormat, GlobalFormat, LocalFormat, NoteFormat,
                     RequestFormat, ResultFormat)
from .sim import Ctx

G = GlobalFormat()
L = LocalFormat()
RQ = RequestFormat()
RS = ResultFormat()
NT = NoteFormat()

OWNER_TAG_BIT = 1 << 31  # Index-field bit marking "pending entry, Index = owner tid"

DONE = "done"
ROUND_FAILED = "round_failed"
STALE = "stale"
WAITING = "waiting"


class GWFQ(QueueAlgorithm):
    name = "gwfq"

    def __init__(self, capacity: int, num_threads: int, tag: str = "gwfq",
                 prefill: int = 0, cycle_bits: int = 30,
                 patience: int = 8, help_delay: int = 64,
                 helper_round_budget: int = 64) -> None:
        super().__init__(capacity, num_threads)
        assert num_threads < G.null_tid
        self.tag = tag
        self.prefill = prefill
        self.fmt = EntryFormat(idx_bits=32, cycle_bits=cycle_bits)
        self.nslots = 2 * capacity
        self.patience = patience
        self.help_delay = help_delay
        self.helper_round_budget = helper_round_budget
        t = tag
        self.s_tail, self.s_head = f"{t}_tailG", f"{t}_headG"
        self.s_thresh, self.s_entries = f"{t}_thresh", f"{t}_entries"
        self.s_req, self.s_res = f"{t}_req", f"{t}_res"
        self.s_localT, self.s_localH = f"{t}_localT", f"{t}_localH"
        self.s_noteq = f"{t}_note"
        self.s_phase2 = f"{t}_phase2"
        # thread-local (not shared-memory) bookkeeping
        self._seq = [0] * num_threads
        self._opct = [0] * num_threads
        self._peer = [(i + 1) % max(num_threads, 1) for i in range(num_threads)]

    # -- geometry ---------------------------------------------------------------

    def slot(self, t: int) -> int:
        return t % self.nslots

    def cycle(self, t: int) -> int:
        return (t // self.nslots) & self.fmt.cycle_mask

    @property
    def threshold_full(self) -> int:
        return 3 * self.capacity - 1

    def init(self, mem: AtomicMemory) -> None:
        self.mem = mem
        f = self.fmt
        nt = self.num_threads
        mem.alloc(self.s_tail, 1, fill=G.pack(self.nslots, G.null_tid))
        mem.alloc(self.s_head, 1, fill=G.pack(self.nslots, G.null_tid))
        mem.alloc(self.s_thresh, 1, fill=AtomicMemory.from_signed(-1))
        mem.alloc(self.s_entries, self.nslots, fill=f.pack(0, 1, 0, f.idx_bot))
        mem.alloc(self.s_req, nt)
        mem.alloc(self.s_res, nt)
        mem.alloc(self.s_localT, nt)
        mem.alloc(self.s_localH, nt)
        mem.alloc(self.s_noteq, nt)
        mem.alloc(self.s_phase2, nt)
        if self.prefill:
            assert self.prefill <= self.capacity
            entries = mem.array(self.s_entries)
            for i in range(self.prefill):
                t = self.nslots + i
                entries[self.slot(t)] = f.pack(self.cycle(t), 1, 1, i)
            mem.array(self.s_tail)[0] = G.pack(self.nslots + self.prefill, G.null_tid)
            mem.array(self.s_thresh)[0] = AtomicMemory.from_signed(self.threshold_full)

    # -- phase-2 record: [ticket:31 | owner:12 | seq:16 | pad] -----------------

    @staticmethod
    def _p2_pack(ticket: int, owner: int, seq: int) -> int:
        return (((ticket & ((1 << 31) - 1)) << 28)
                | ((owner & 0xFFF) << 16) | (seq & 0xFFFF))

    @staticmethod
    def _p2_unpack(word: int):
        return (word >> 28) & ((1 << 31) - 1), (word >> 16) & 0xFFF, word & 0xFFFF

    # ==========================================================================
    # Fast path (identical structure to G-LFQ, over packed global words)
    # ==========================================================================

    def _gfaa(self, ctx: Ctx, name: str):
        """Wave-batched FAA of the counter field of a packed global word.
        The counter occupies the high bits, so adding (count << tid_bits)
        never perturbs ThrIdx."""
        w = yield from ctx.wavefaa(name, 0, 1 << G.tid_bits)
        return G.cnt(w)

    def _gcnt(self, ctx: Ctx, name: str):
        w = yield from ctx.load(name, 0)
        return G.cnt(w)

    def _tryenq_fast(self, ctx: Ctx, tid: int, value: int):
        f = self.fmt
        t = yield from self._gfaa(ctx, self.s_tail)
        j, c = self.slot(t), self.cycle(t)
        while True:  # re-read on lost CAS races (sCQ discipline)
            e = yield from ctx.load(self.s_entries, j)
            if not (f.cycle_lt(f.cycle(e), c) and f.is_empty_idx(e)):
                return RETRY
            h = yield from self._gcnt(ctx, self.s_head)
            if not (f.safe(e) or h <= t):
                return RETRY
            ok = yield from ctx.cas(self.s_entries, j, e, f.pack(c, 1, 1, value))
            if ok:
                yield from ctx.store(self.s_thresh, 0,
                                     AtomicMemory.from_signed(self.threshold_full))
                return SUCCESS

    def _trydeq_fast(self, ctx: Ctx, tid: int):
        f = self.fmt
        thr = yield from ctx.load(self.s_thresh, 0)
        if AtomicMemory.to_signed(thr) < 0:
            return (EMPTY, None)
        t_h = yield from self._gfaa(ctx, self.s_head)
        r, v = yield from self._exercise_head_ticket(ctx, t_h)
        return (r, v)

    def _exercise_head_ticket(self, ctx: Ctx, t_h: int):
        """Drive head ticket ``t_h``'s slot to a terminal state and return
        (SUCCESS, v) | (RETRY, None) | (EMPTY, None).  RETRY/EMPTY follow the
        fast-path accounting (threshold decrement / tail catch-up).  The
        caller owns the ticket exclusively (fast path: its own FAA; slow
        path: the request's round claim), so a consumed value always has a
        recipient."""
        f = self.fmt
        j, c = self.slot(t_h), self.cycle(t_h)
        while True:  # re-read on lost CAS races (sCQ discipline)
            e = yield from ctx.load(self.s_entries, j)
            if f.cycle_eq(f.cycle(e), c) and not f.is_empty_idx(e):
                if f.enq(e) == 0:
                    # pending slow enqueue: finalize it, then consume
                    yield from self._complete_pending(ctx, j, e)
                    continue
                old = yield from ctx.consume(self.s_entries, j, f)
                v = f.idx(old)
                if v == f.idx_botc:
                    continue  # lost a consume race; re-read
                return (SUCCESS, v)
            if f.cycle_lt(f.cycle(e), c):
                if f.is_empty_idx(e):
                    new = f.pack(c, f.safe(e), 0, f.idx_bot)
                else:
                    new = f.pack(f.cycle(e), 0, f.enq(e), f.idx(e))
                ok = yield from ctx.cas(self.s_entries, j, e, new)
                if not ok:
                    continue
            break
        t = yield from self._gcnt(ctx, self.s_tail)
        if t <= t_h + 1:
            yield from self._catchup(ctx, t_h + 1)
            yield from ctx.faa(self.s_thresh, 0, NEG1)
            return (EMPTY, None)
        old_thr = yield from ctx.faa(self.s_thresh, 0, NEG1)
        if AtomicMemory.to_signed(old_thr) <= 0:
            return (EMPTY, None)
        return (RETRY, None)

    def _catchup(self, ctx: Ctx, target: int):
        while True:
            g = yield from ctx.load(self.s_tail, 0)
            if G.cnt(g) >= target:
                return
            ok = yield from ctx.cas(self.s_tail, 0, g, G.pack(target, G.thridx(g)))
            if ok:
                return

    # ==========================================================================
    # Pending-entry finalization (owner-tagged invisible entries)
    # ==========================================================================

    def _complete_pending(self, ctx: Ctx, j: int, e: int):
        """Finalize a pending (Enq=0, owner-tagged) entry: ensure the owner's
        result word is *done* first, then flip Enq (done-before-visible)."""
        f = self.fmt
        tag = f.idx(e)
        if not (tag & OWNER_TAG_BIT):
            return
        o = tag & 0xFFFF
        rq = yield from ctx.load(self.s_req, o)
        if not (RQ.pending(rq) and RQ.isenq(rq)):
            # request gone ⟹ this pending entry never delivered (a delivered
            # entry is flipped before its request retires) — roll it back so
            # dequeuers are not blocked by unreachable garbage.
            yield from ctx.cas(self.s_entries, j, e,
                               f.pack(f.cycle(e), f.safe(e), 0, f.idx_bot))
            return
        s, v = RQ.seq(rq), RQ.value(rq)
        r = yield from ctx.load(self.s_res, o)
        if RS.seq(r) != s:
            return  # torn republish window; caller re-reads
        if not RS.done(r):
            yield from ctx.cas(self.s_res, o, r, RS.pack(v, s, 1, 0))
        # Gate the visibility flip on a *re-read* of the result word: flip
        # only when this request's result is done-with-value (not FULL).
        r2 = yield from ctx.load(self.s_res, o)
        if RS.seq(r2) != s or not RS.done(r2):
            return
        if RS.empty(r2):
            # zombie pending entry of a FULL-resolved request: roll back
            yield from ctx.cas(self.s_entries, j, e,
                               f.pack(f.cycle(e), f.safe(e), 0, f.idx_bot))
            return
        # flip Enq 0→1, substituting the real value for the owner tag
        yield from ctx.cas(self.s_entries, j, e, f.pack(f.cycle(e), f.safe(e), 1, v))
        # the flip commits a delivery: reset Threshold exactly as the fast
        # path does after its install CAS (Alg. 1 line 20) — without this a
        # slow enqueue can leave the threshold negative and strand its value
        yield from ctx.store(self.s_thresh, 0,
                             AtomicMemory.from_signed(self.threshold_full))

    # ==========================================================================
    # SLOWFAA (Algorithm 2) — cooperative Tail increment, one per round
    # ==========================================================================

    def _slowfaa_tail(self, ctx: Ctx, helper: int, o: int, s: int):
        """Advance the owner's enqueue round: returns ('ticket', t) once the
        round's ticket is recorded in the owner's local-tail word, or
        ('fin'|'stale', _).  A ticket whose record CAS loses (the round
        already resolved) is dropped — benign for Tail (see point 5)."""
        while True:
            lw = yield from ctx.load(self.s_localT, o)
            if L.seq(lw) != s:
                return (STALE, None)
            if L.fin(lw):
                return (DONE, None)
            if L.inc(lw):
                # INC set ⟺ a round is live with ticket lcnt.  Rounds are
                # strictly serialized: records require INC == 0, and INC is
                # cleared only after the round's permanent-verdict failure.
                return ("ticket", L.lcnt(lw))
            g = yield from ctx.load(self.s_tail, 0)
            c, u = G.cnt(g), G.thridx(g)
            if u != G.null_tid:
                # phase-2 in flight: helper u's record names owner, seq, ticket
                p2 = yield from ctx.load(self.s_phase2, u)
                t0, o2, s2 = self._p2_unpack(p2)
                lw2 = yield from ctx.load(self.s_localT, o2)
                if (L.seq(lw2) == s2 and not L.fin(lw2) and not L.inc(lw2)
                        and L.lcnt(lw2) < t0):
                    yield from ctx.cas(self.s_localT, o2, lw2,
                                       L.pack(t0, s2, 1, 0))
                yield from ctx.cas(self.s_tail, 0, g, G.pack(c, G.null_tid))
                continue
            # publish our phase-2 record, then race for the increment
            yield from ctx.store(self.s_phase2, helper, self._p2_pack(c, o, s))
            won = yield from ctx.cas(self.s_tail, 0, g, G.pack(c + 1, helper))
            if won:
                lw2 = yield from ctx.load(self.s_localT, o)
                if (L.seq(lw2) == s and not L.fin(lw2) and not L.inc(lw2)
                        and L.lcnt(lw2) < c):
                    yield from ctx.cas(self.s_localT, o, lw2, L.pack(c, s, 1, 0))
                # clear ThrIdx (loop: fast-path FAAs may bump the counter)
                while True:
                    g2 = yield from ctx.load(self.s_tail, 0)
                    if G.thridx(g2) != helper:
                        break
                    ok = yield from ctx.cas(self.s_tail, 0, g2,
                                            G.pack(G.cnt(g2), G.null_tid))
                    if ok:
                        break
            # loop: the top re-reads the local word

    # ==========================================================================
    # Slow-path round actions (TRYENQSLOW / TRYDEQSLOW, § III-C-d)
    # ==========================================================================

    def _note_failed(self, ctx: Ctx, o: int, s: int, ticket: int):
        """Advance Note to this round's failed ticket (Lemma III.8), then
        clear INC so the next round can start.  Permanence of the entry-word
        verdict guarantees no late install can revive the noted round, so the
        note→clear order is race-free."""
        while True:
            nw = yield from ctx.load(self.s_noteq, o)
            if NT.seq(nw) != s:
                return
            if NT.valid(nw) and NT.cycle(nw) >= ticket:
                break
            ok = yield from ctx.cas(self.s_noteq, o, nw, NT.pack(ticket, s, 1))
            if ok:
                break
        lw = yield from ctx.load(self.s_localT, o)
        if L.seq(lw) == s and L.inc(lw) and not L.fin(lw) and L.lcnt(lw) == ticket:
            yield from ctx.cas(self.s_localT, o, lw, L.pack(ticket, s, 0, 0))

    def _noted(self, ctx: Ctx, o: int, s: int, ticket: int):
        nw = yield from ctx.load(self.s_noteq, o)
        return NT.seq(nw) == s and NT.valid(nw) and NT.cycle(nw) >= ticket

    def _set_fin(self, ctx: Ctx, o: int, s: int, which_head: int):
        l_name = self.s_localH if which_head else self.s_localT
        while True:
            lw = yield from ctx.load(l_name, o)
            if L.seq(lw) != s or L.fin(lw):
                return
            ok = yield from ctx.cas(l_name, o, lw, L.pack(L.lcnt(lw), s, 0, 1))
            if ok:
                return

    def _try_res_done(self, ctx: Ctx, o: int, s: int, value: int, empty: int):
        r = yield from ctx.load(self.s_res, o)
        if RS.seq(r) == s and not RS.done(r):
            ok = yield from ctx.cas(self.s_res, o, r, RS.pack(value, s, 1, empty))
            return ok
        return False

    def _res_done(self, ctx: Ctx, o: int, s: int):
        r = yield from ctx.load(self.s_res, o)
        return (RS.seq(r) == s and RS.done(r), r)

    def _enq_round(self, ctx: Ctx, o: int, s: int, v: int, t: int):
        """One slow-enqueue round for ticket t.  Returns DONE, ROUND_FAILED,
        or WAITING (slot transiently undecided: stale live value)."""
        f = self.fmt
        j, c = self.slot(t), self.cycle(t)
        tag = OWNER_TAG_BIT | o
        while True:
            done, _ = yield from self._res_done(ctx, o, s)
            if done:
                yield from self._set_fin(ctx, o, s, 0)
                return DONE
            if (yield from self._noted(ctx, o, s, t)):
                yield from self._note_failed(ctx, o, s, t)  # ensure INC clear
                return ROUND_FAILED
            e = yield from ctx.load(self.s_entries, j)
            ec, ei = f.cycle(e), f.idx(e)
            if f.cycle_eq(ec, c):
                if ei == tag:
                    # ours, pending: done-before-visible, then flip
                    yield from self._complete_pending(ctx, j, e)
                    continue
                if ei == v and f.enq(e):
                    # ours, visible (flip already happened)
                    yield from self._try_res_done(ctx, o, s, v, 0)
                    yield from self._set_fin(ctx, o, s, 0)
                    yield from ctx.store(self.s_thresh, 0,
                                         AtomicMemory.from_signed(self.threshold_full))
                    return DONE
                if ei == f.idx_botc:
                    # ours, already consumed ⇒ done-before-visible implies the
                    # result word is (or is about to be) done — loop to top.
                    yield from ctx.step()
                    continue
                # ⊥ at our cycle (dequeuer neutralized the slot): permanent fail
                yield from self._note_failed(ctx, o, s, t)
                return ROUND_FAILED
            if f.cycle_lt(c, ec):
                # newer cycle: permanent fail (res-done already checked above)
                yield from self._note_failed(ctx, o, s, t)
                return ROUND_FAILED
            # older cycle
            if f.is_empty_idx(e):
                h = yield from self._gcnt(ctx, self.s_head)
                if f.safe(e) or h <= t:
                    # install invisible owner-tagged entry
                    yield from ctx.cas(self.s_entries, j, e, f.pack(c, 1, 0, tag))
                    continue
                # unreachable for us (unsafe ∧ matching dequeuer passed):
                # neutralize to our cycle so the verdict becomes permanent
                yield from ctx.cas(self.s_entries, j, e,
                                   f.pack(c, f.safe(e), 0, f.idx_bot))
                continue
            # stale live value: wait for its consumption (bounded by the
            # FULL accounting at the driver level)
            return WAITING

    # ==========================================================================
    # Slow-path drivers
    # ==========================================================================

    def _drive_enq(self, ctx: Ctx, helper: int, o: int, s: int, v: int,
                   budget: int):
        """Drive enqueue request (o, s) toward completion.  Returns True if
        resolved, False if budget exhausted."""
        for _ in range(budget):
            rq = yield from ctx.load(self.s_req, o)
            if RQ.seq(rq) != s or not RQ.pending(rq):
                return True  # request gone (completed & reclaimed)
            done, _ = yield from self._res_done(ctx, o, s)
            if done:
                yield from self._set_fin(ctx, o, s, 0)
                return True
            # FULL resolution (conservative: slow-path skew inflates Tail)
            tl = yield from self._gcnt(ctx, self.s_tail)
            hd = yield from self._gcnt(ctx, self.s_head)
            if tl - hd >= self.capacity + self.num_threads:
                yield from self._try_res_done(ctx, o, s, 0, 1)  # FULL
                yield from self._set_fin(ctx, o, s, 0)
                return True
            st, t = yield from self._slowfaa_tail(ctx, helper, o, s)
            if st in (STALE, DONE):
                return True
            r = yield from self._enq_round(ctx, o, s, v, t)
            if r == DONE:
                return True
            yield from ctx.step()
        return False

    def _drive_deq(self, ctx: Ctx, helper: int, o: int, s: int, budget: int):
        """Drive dequeue request (o, s).  Rounds are serialized through the
        request's local-head INC bit: the claim winner is the only thread
        that may FAA Head, exercise the ticket, and deliver — so every
        consumed value has exactly one recipient and the delivering res-CAS
        cannot fail.  Returns True when the request is resolved."""
        for _ in range(budget):
            rq = yield from ctx.load(self.s_req, o)
            if RQ.seq(rq) != s or not RQ.pending(rq):
                return True  # request gone (completed & reclaimed)
            done, _ = yield from self._res_done(ctx, o, s)
            if done:
                yield from self._set_fin(ctx, o, s, 1)
                return True
            lw = yield from ctx.load(self.s_localH, o)
            if L.seq(lw) != s or L.fin(lw):
                return True
            if L.inc(lw):
                # a round is in flight under another claimer — wait
                yield from ctx.step()
                continue
            won = yield from ctx.cas(self.s_localH, o, lw,
                                     L.pack(L.lcnt(lw), s, 1, 0))
            if not won:
                continue
            # we hold the round claim: resolve EMPTY or run one ticket
            thr = yield from ctx.load(self.s_thresh, 0)
            if AtomicMemory.to_signed(thr) < 0:
                yield from self._try_res_done(ctx, o, s, 0, 1)  # EMPTY
                yield from self._set_fin(ctx, o, s, 1)
                return True
            t_h = yield from self._gfaa(ctx, self.s_head)
            r, v = yield from self._exercise_head_ticket(ctx, t_h)
            if r == SUCCESS:
                yield from self._try_res_done(ctx, o, s, v, 0)
                yield from self._set_fin(ctx, o, s, 1)
                return True
            if r == EMPTY:
                yield from self._try_res_done(ctx, o, s, 0, 1)
                yield from self._set_fin(ctx, o, s, 1)
                return True
            # RETRY: release the round claim
            lw2 = yield from ctx.load(self.s_localH, o)
            if L.seq(lw2) == s and L.inc(lw2) and not L.fin(lw2):
                yield from ctx.cas(self.s_localH, o, lw2,
                                   L.pack(t_h, s, 0, 0))
            yield from ctx.step()
        return False

    def _maybe_help(self, ctx: Ctx, tid: int):
        """Every HELP_DELAY own-operations, inspect one peer record (the
        paper's help-delay D) and drive whichever request it holds.  Any
        thread may help either kind: dequeue delivery goes through the
        request's round claim and result word (never to the helper), and
        enqueue rounds commit on the entry word — helper identity is
        immaterial.  (A per-kind split with a shared counter silently
        starves one kind under alternating workloads — found by the
        starvation test, kept here as a warning.)"""
        self._opct[tid] += 1
        if self.num_threads <= 1 or self._opct[tid] % self.help_delay:
            return
        p = self._peer[tid]
        self._peer[tid] = (p + 1) % self.num_threads
        if p == tid:
            p = (p + 1) % self.num_threads
            self._peer[tid] = (p + 1) % self.num_threads
            if p == tid:
                return
        rq = yield from ctx.load(self.s_req, p)
        if RQ.pending(rq):
            if RQ.isenq(rq):
                yield from self._drive_enq(ctx, tid, p, RQ.seq(rq),
                                           RQ.value(rq),
                                           self.helper_round_budget)
            else:
                yield from self._drive_deq(ctx, tid, p, RQ.seq(rq),
                                           self.helper_round_budget)

    # ==========================================================================
    # Public operations
    # ==========================================================================

    def _publish(self, ctx: Ctx, tid: int, isenq: int, v: int):
        """Publication discipline (§ III-C-c): payload words first, request
        word (seq+pending) last."""
        self._seq[tid] = (self._seq[tid] + 1) & RQ.seq_mask
        s = self._seq[tid]
        yield from ctx.store(self.s_res, tid, RS.pack(0, s, 0, 0))
        yield from ctx.store(self.s_noteq, tid, NT.pack(0, s, 0))
        l_name = self.s_localT if isenq else self.s_localH
        yield from ctx.store(l_name, tid, L.pack(0, s, 0, 0))
        yield from ctx.store(self.s_req, tid, RQ.pack(v, s, 1, isenq))
        return s

    def _retire(self, ctx: Ctx, tid: int, s: int, isenq: int, v: int):
        yield from ctx.store(self.s_req, tid, RQ.pack(v, s, 0, isenq))

    def enqueue(self, ctx: Ctx, tid: int, value: int):
        assert 0 <= value <= VAL_MASK
        yield from self._maybe_help(ctx, tid)
        for _ in range(self.patience):
            t = yield from self._gcnt(ctx, self.s_tail)
            h = yield from self._gcnt(ctx, self.s_head)
            if t - h >= self.capacity:
                return False
            r = yield from self._tryenq_fast(ctx, tid, value)
            if r == SUCCESS:
                return True
        # slow path
        s = yield from self._publish(ctx, tid, 1, value)
        while True:
            resolved = yield from self._drive_enq(ctx, tid, tid, s, value, 1 << 30)
            if resolved:
                break
        _, r = yield from self._res_done(ctx, tid, s)
        yield from self._retire(ctx, tid, s, 1, value)
        return not RS.empty(r)

    def dequeue(self, ctx: Ctx, tid: int):
        yield from self._maybe_help(ctx, tid)
        for _ in range(self.patience):
            r, v = yield from self._trydeq_fast(ctx, tid)
            if r == SUCCESS:
                return (True, v)
            if r == EMPTY:
                return (False, None)
        s = yield from self._publish(ctx, tid, 0, 0)
        while True:
            resolved = yield from self._drive_deq(ctx, tid, tid, s, 1 << 30)
            if resolved:
                break
        _, r = yield from self._res_done(ctx, tid, s)
        yield from self._retire(ctx, tid, s, 0, 0)
        if RS.empty(r):
            return (False, None)
        return (True, RS.value(r))
