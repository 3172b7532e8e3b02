"""64-bit packed-word layouts for the GPU queue family (paper Figs. 2 & 3).

A copy of ``repro/core/packed.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

The paper's central architectural move (Lemma III.5) is packing every piece of
concurrently-mutated shared state into a single 64-bit word so that native
single-width atomics (FAA / CAS) suffice where wCQ needed CAS2.  This module
defines those layouts and pure bit-twiddling helpers.  All values are Python
ints masked to 64 bits; the simulated atomic memory stores them in numpy
uint64 arrays.

Layouts
-------
Entry word (Fig. 2)  — one per ring slot::

    [ cycle : CYCLE_BITS | safe : 1 | enq : 1 | index : IDX_BITS ]

  ``index`` is a payload index, ``IDX_BOT`` (empty) or ``IDX_BOTC`` (consumed).
  ``cycle`` is the reduced-width cycle tag of Lemmas III.2 / III.6; its width
  is configurable so the property tests can probe the soundness boundary
  (live skew < R/2).

Global Head/Tail word (Fig. 3)::

    [ cnt : CNT_BITS | thridx : TID_BITS ]

  ``thridx`` is the helper thread id of the in-flight SLOWFAA phase-2 round,
  or ``NULL_TID``.

Local head/tail word (Fig. 3, per-thread record)::

    [ lcnt : LCNT_BITS | seq : SEQ_BITS | inc : 1 | fin : 1 ]

Request / result / note words — per-thread slow-path records, all seq-tagged
so stale helpers fail their CASes (the publication discipline of § III-C-c).
"""

from __future__ import annotations

from dataclasses import dataclass

MASK64 = (1 << 64) - 1

# ---------------------------------------------------------------------------
# Entry word
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EntryFormat:
    """Bit layout for a ring-slot entry word."""

    idx_bits: int = 32
    cycle_bits: int = 30  # reduced-width cycle tag (Lemma III.2 / III.6)

    @property
    def idx_mask(self) -> int:
        return (1 << self.idx_bits) - 1

    @property
    def cycle_mask(self) -> int:
        return (1 << self.cycle_bits) - 1

    @property
    def cycle_range(self) -> int:
        """R = 2^{b_c}."""
        return 1 << self.cycle_bits

    # Field offsets:  [cycle | safe | enq | idx]
    @property
    def enq_shift(self) -> int:
        return self.idx_bits

    @property
    def safe_shift(self) -> int:
        return self.idx_bits + 1

    @property
    def cycle_shift(self) -> int:
        return self.idx_bits + 2

    @property
    def idx_bot(self) -> int:
        """⊥ — empty slot."""
        return self.idx_mask

    @property
    def idx_botc(self) -> int:
        """⊥_c — consumed slot."""
        return self.idx_mask - 1

    def pack(self, cycle: int, safe: int, enq: int, idx: int) -> int:
        assert 0 <= idx <= self.idx_mask
        return (
            ((cycle & self.cycle_mask) << self.cycle_shift)
            | ((safe & 1) << self.safe_shift)
            | ((enq & 1) << self.enq_shift)
            | idx
        ) & MASK64

    def cycle(self, word: int) -> int:
        return (word >> self.cycle_shift) & self.cycle_mask

    def safe(self, word: int) -> int:
        return (word >> self.safe_shift) & 1

    def enq(self, word: int) -> int:
        return (word >> self.enq_shift) & 1

    def idx(self, word: int) -> int:
        return word & self.idx_mask

    def is_empty_idx(self, word: int) -> bool:
        return self.idx(word) in (self.idx_bot, self.idx_botc)

    def with_idx(self, word: int, idx: int) -> int:
        """Replace the index field, preserving the other packed fields
        (the CONSUME primitive of § III-B-c builds on this)."""
        return ((word & ~self.idx_mask) | (idx & self.idx_mask)) & MASK64

    def cycle_lt(self, a: int, b: int) -> bool:
        """Modular ``a < b`` on reduced-width cycle tags (Lemma III.6):
        b is newer than a  iff  0 < (b - a) mod R < R/2."""
        d = (b - a) & self.cycle_mask
        return 0 < d < (self.cycle_range >> 1)

    def cycle_eq(self, a: int, b: int) -> bool:
        return (a & self.cycle_mask) == (b & self.cycle_mask)


# ---------------------------------------------------------------------------
# Global Head/Tail word  (cnt | thridx)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GlobalFormat:
    tid_bits: int = 16

    @property
    def tid_mask(self) -> int:
        return (1 << self.tid_bits) - 1

    @property
    def null_tid(self) -> int:
        return self.tid_mask

    @property
    def cnt_mask(self) -> int:
        return (1 << (64 - self.tid_bits)) - 1

    def pack(self, cnt: int, thridx: int) -> int:
        return (((cnt & self.cnt_mask) << self.tid_bits) | (thridx & self.tid_mask)) & MASK64

    def cnt(self, word: int) -> int:
        return (word >> self.tid_bits) & self.cnt_mask

    def thridx(self, word: int) -> int:
        return word & self.tid_mask


# ---------------------------------------------------------------------------
# Local head/tail word  (lcnt | seq | inc | fin)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LocalFormat:
    seq_bits: int = 16
    lcnt_bits: int = 46

    @property
    def seq_mask(self) -> int:
        return (1 << self.seq_bits) - 1

    @property
    def lcnt_mask(self) -> int:
        return (1 << self.lcnt_bits) - 1

    def pack(self, lcnt: int, seq: int, inc: int, fin: int) -> int:
        return (
            ((lcnt & self.lcnt_mask) << (self.seq_bits + 2))
            | ((seq & self.seq_mask) << 2)
            | ((inc & 1) << 1)
            | (fin & 1)
        ) & MASK64

    def lcnt(self, word: int) -> int:
        return (word >> (self.seq_bits + 2)) & self.lcnt_mask

    def seq(self, word: int) -> int:
        return (word >> 2) & self.seq_mask

    def inc(self, word: int) -> int:
        return (word >> 1) & 1

    def fin(self, word: int) -> int:
        return word & 1


# ---------------------------------------------------------------------------
# Request / result / note words (per-thread slow-path record)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestFormat:
    """Request word: [ value : 32 | seq : 16 | pending : 1 | isenq : 1 ]."""

    seq_bits: int = 16
    val_bits: int = 32

    @property
    def seq_mask(self) -> int:
        return (1 << self.seq_bits) - 1

    @property
    def val_mask(self) -> int:
        return (1 << self.val_bits) - 1

    def pack(self, value: int, seq: int, pending: int, isenq: int) -> int:
        return (
            ((value & self.val_mask) << (self.seq_bits + 2))
            | ((seq & self.seq_mask) << 2)
            | ((pending & 1) << 1)
            | (isenq & 1)
        ) & MASK64

    def value(self, word: int) -> int:
        return (word >> (self.seq_bits + 2)) & self.val_mask

    def seq(self, word: int) -> int:
        return (word >> 2) & self.seq_mask

    def pending(self, word: int) -> int:
        return (word >> 1) & 1

    def isenq(self, word: int) -> int:
        return word & 1


@dataclass(frozen=True)
class ResultFormat:
    """Result word: [ value : 32 | seq : 16 | done : 1 | empty : 1 ]."""

    seq_bits: int = 16
    val_bits: int = 32

    @property
    def seq_mask(self) -> int:
        return (1 << self.seq_bits) - 1

    @property
    def val_mask(self) -> int:
        return (1 << self.val_bits) - 1

    def pack(self, value: int, seq: int, done: int, empty: int) -> int:
        return (
            ((value & self.val_mask) << (self.seq_bits + 2))
            | ((seq & self.seq_mask) << 2)
            | ((done & 1) << 1)
            | (empty & 1)
        ) & MASK64

    def value(self, word: int) -> int:
        return (word >> (self.seq_bits + 2)) & self.val_mask

    def seq(self, word: int) -> int:
        return (word >> 2) & self.seq_mask

    def done(self, word: int) -> int:
        return (word >> 1) & 1

    def empty(self, word: int) -> int:
        return word & 1


@dataclass(frozen=True)
class NoteFormat:
    """Note word (Lemma III.8): [ cycle : 47 | seq : 16 | valid : 1 ].

    ``cycle`` here is the *unreduced* per-request round cycle: the note is
    private to one request record, so it does not need the reduced-width
    treatment of the shared entry words.
    """

    seq_bits: int = 16

    @property
    def seq_mask(self) -> int:
        return (1 << self.seq_bits) - 1

    def pack(self, cycle: int, seq: int, valid: int) -> int:
        return (((cycle & ((1 << 47) - 1)) << (self.seq_bits + 1))
                | ((seq & self.seq_mask) << 1) | (valid & 1)) & MASK64

    def cycle(self, word: int) -> int:
        return (word >> (self.seq_bits + 1)) & ((1 << 47) - 1)

    def seq(self, word: int) -> int:
        return (word >> 1) & self.seq_mask

    def valid(self, word: int) -> int:
        return word & 1


# Default singletons used across the queue family.
ENTRY = EntryFormat()
GLOBAL = GlobalFormat()
LOCAL = LocalFormat()
REQ = RequestFormat()
RES = ResultFormat()
NOTE = NoteFormat()
