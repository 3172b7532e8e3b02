"""Simulated 64-bit atomic shared memory.

A copy of ``repro/core/atomics.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

The queue algorithms in this package are written as per-thread state machines
that issue *atomic instructions* against this memory.  Each instruction is
executed indivisibly by the scheduler (`repro_torch.core.sim`), which models the
sequentially-consistent-at-atomic-granularity semantics the paper assumes for
GPU global memory with device-scope atomics.

Primitives match what the paper uses on CDNA2/3 hardware:

* ``load`` / ``store``      — 64-bit atomic load/store,
* ``faa``                   — fetch-and-add (returns the old value),
* ``cas``                   — single-width 64-bit compare-and-swap,
* ``consume``               — the paper's CONSUME: atomically set the entry
                              word's Index field to ⊥_c *without changing the
                              other packed fields* (§ III-B-c),
* ``fetch_or``/``fetch_and``— bit-set/clear RMWs (Enq-bit publication).

The memory also keeps per-array atomic-traffic counters so the benchmarks can
report how many *hot-word* atomics each design issues per successful
operation — the quantity wave-batching (Fig. 1) is designed to reduce.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

from .packed import MASK64, EntryFormat


class AtomicMemory:
    """Named uint64 arrays with atomic RMW primitives and traffic counters."""

    def __init__(self) -> None:
        self._arrays: Dict[str, np.ndarray] = {}
        self.op_counts: Dict[str, int] = defaultdict(int)       # by primitive
        self.word_traffic: Dict[str, int] = defaultdict(int)    # by array name
        self.rmw_traffic: Dict[str, int] = defaultdict(int)     # RMWs only

    # -- allocation --------------------------------------------------------

    def alloc(self, name: str, size: int, fill: int = 0) -> None:
        if name in self._arrays:
            raise ValueError(f"array {name!r} already allocated")
        self._arrays[name] = np.full(size, np.uint64(fill & MASK64), dtype=np.uint64)

    def free_all(self) -> None:
        self._arrays.clear()

    def array(self, name: str) -> np.ndarray:
        return self._arrays[name]

    # -- primitives ---------------------------------------------------------

    def _count(self, kind: str, name: str) -> None:
        self.op_counts[kind] += 1
        self.word_traffic[name] += 1
        if kind in ("faa", "cas"):
            self.rmw_traffic[name] += 1

    def load(self, name: str, i: int) -> int:
        self._count("load", name)
        return int(self._arrays[name][i])

    def store(self, name: str, i: int, v: int) -> None:
        self._count("store", name)
        self._arrays[name][i] = np.uint64(v & MASK64)

    def faa(self, name: str, i: int, delta: int) -> int:
        """Fetch-and-add; returns the pre-add value.  Wraps mod 2^64."""
        self._count("faa", name)
        a = self._arrays[name]
        old = int(a[i])
        a[i] = np.uint64((old + delta) & MASK64)
        return old

    def cas(self, name: str, i: int, expected: int, desired: int) -> bool:
        self._count("cas", name)
        a = self._arrays[name]
        if int(a[i]) == (expected & MASK64):
            a[i] = np.uint64(desired & MASK64)
            return True
        return False

    def fetch_or(self, name: str, i: int, mask: int) -> int:
        self._count("faa", name)  # counts as one RMW atomic
        a = self._arrays[name]
        old = int(a[i])
        a[i] = np.uint64((old | mask) & MASK64)
        return old

    def fetch_and(self, name: str, i: int, mask: int) -> int:
        self._count("faa", name)
        a = self._arrays[name]
        old = int(a[i])
        a[i] = np.uint64((old & mask) & MASK64)
        return old

    def consume(self, name: str, i: int, fmt: EntryFormat) -> int:
        """CONSUME (§ III-B-c): atomically mark the slot's Index field ⊥_c,
        preserving cycle/safe/enq.  Returns the *old* word (whose Index field
        is the dequeued payload index)."""
        self._count("cas", name)  # single RMW on the slot word
        a = self._arrays[name]
        old = int(a[i])
        a[i] = np.uint64(fmt.with_idx(old, fmt.idx_botc))
        return old

    # -- signed helpers (Threshold is a signed quantity in sCQ) -------------

    @staticmethod
    def to_signed(v: int) -> int:
        return v - (1 << 64) if v >= (1 << 63) else v

    @staticmethod
    def from_signed(v: int) -> int:
        return v & MASK64

    # -- metrics -------------------------------------------------------------

    def reset_counters(self) -> None:
        self.op_counts.clear()
        self.word_traffic.clear()
        self.rmw_traffic.clear()

    def total_atomics(self) -> int:
        return sum(self.op_counts.values())
