"""k-relaxed multi-ring G-PQ (DESIGN.md § 5.2).

A copy of ``repro/sched/relaxed.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

``RelaxedGPQ`` trades exact delete-min order for contention scaling, the
MultiQueue/k-LSM move mapped onto the G-PQ announce-ring idiom: ``R``
independent G-PQ rings, round-robin insert spray (a global WAVEFAA ticket
picks ``ring = ticket % R``, so a converged wave's batch spreads evenly),
and hint-ordered delete-min (read every ring's min-key hint, pop rings in
ascending-hint order, first success wins).

Quantitative relaxation bound
-----------------------------
``relaxation_bound() = lazy + 2 * (R - 1) * num_threads``.  Two regimes:

* ``R = 1`` — the bound ``k = lazy`` is *exact and worst-case*: the only
  elements a pop can ignore are the ≤ ``lazy`` announced-but-undrained
  inserts its drain skipped (everything else is in the applied heap the
  pop takes the minimum of).  Tests assert this tight bound directly.
* ``R > 1`` — hint-ordered selection is a MultiQueue: per-op rank error
  is *windowed interference*, not a structural constant.  A sibling ring
  can hide a smaller pending key from the winning pop only if that key's
  insert completed after the sweep probed the ring (tried it and found it
  EMPTY, or read its exact min-hint above the returned key) — i.e. inside
  the sweep's own window.  The envelope charges each concurrent thread
  two completed inserts per sibling ring per window; measured worst-case
  rank error across schedules/seeds sits near ``lazy + (R-1)·√T`` —
  ``tests/test_sched.py`` holds every history to the (much larger)
  declared envelope under all three schedules via the
  ``plinearizability`` checker, and to the exact ``lazy`` bound at
  ``R = 1``.

The strict ``GPQ`` is the ``R=1, lazy=0`` point of the family, checked at
``k = 0``.

EMPTY is *not* relaxed: delete-min reports EMPTY only after reading the
shared pending counter at zero — an instant at which no completed,
undeleted insert existed.  A sweep that drains every ring empty while the
counter is nonzero (the counted inserts are still in flight) retries with
backoff rather than guessing.

Mesh-window interference
------------------------
The priority *mesh* engine (``runtime/meshrounds.py``, DESIGN.md § 6) is
the same relaxation one level up: each shard of the mesh is a "ring" that
pops its local minimum, and the per-round claim/publish windows play the
role of the sweep window.  ``mesh_relaxation_bound`` extends the envelope
with that term; like the ``R > 1`` regime here it is a declared envelope
(validated by holding recorded round histories to it with the
``plinearizability`` checker), not a tight constant — and like ``R = 1``,
the strict replicated-heap mode collapses it back to the exact base bound.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.atomics import AtomicMemory
from ..core.sim import Ctx
from .gpq import DELMIN, GPQ, INS, NEG1, NODE, NodeFormat


def mesh_relaxation_bound(shards: int, batch: int, max_occupancy: int, *,
                          lazy: int = 0, rings: int = 1,
                          num_threads: int = 1) -> int:
    """Relaxation envelope ``k`` for the sharded priority mesh rounds
    (DESIGN.md § 6) — the mesh-window interference term stacked on the
    chip-level ``RelaxedGPQ`` envelope.

    Derivation.  A round pops each shard's *local* minima, so a pop from
    shard ``i`` can rank behind keys resident on sibling shards at its
    linearization window.  Same-round sibling pops are concurrent (their
    deletes are invoked inside the window, so no linearization is forced
    to keep them pending); what remains chargeable is each sibling's
    *unpopped* residue.  Round-robin rank spray balances per-shard
    arrivals to within one child per round and the hint-ordered
    even-split claim balances departures the same way, so a shard's
    residue stays within one batch of the even share — the envelope
    charges each of the ``shards − 1`` siblings
    ``ceil(max_occupancy / shards) + batch`` hidden keys.  At
    ``shards = 1`` (or the strict replicated-heap mode) the mesh term
    vanishes and the bound is the chip-level base, which is exact — pops
    leave the one heap in global min-key order.

    ``lazy``/``rings``/``num_threads`` fold in the chip-level envelope
    when each mesh shard is itself a relaxed G-PQ (the device engine uses
    an exact applied heap per shard, i.e. the ``lazy = 0, rings = 1``
    point).  Sound in the checker's sense: recorded mesh histories are
    held to this ``k`` by ``check_p_linearizable`` in the test suite."""
    base = lazy + 2 * (rings - 1) * num_threads
    if shards <= 1:
        return base
    resident = -(-int(max_occupancy) // int(shards)) + int(batch)
    return base + (shards - 1) * resident


class RelaxedGPQ:
    """R-ring k-relaxed bounded min-priority queue.

    One logical operation = one bracketed history event, regardless of how
    many rings it touches (the per-ring EMPTYs of a sweep are internal and
    never filed, so the history carries only the relaxed semantics the
    checker verifies)."""

    name = "rgpq"

    def __init__(self, capacity: int, num_threads: int, tag: str = "rgpq",
                 *, rings: int = 4, lazy: int = 2, arity: int = 4,
                 fmt: NodeFormat = NODE) -> None:
        assert rings >= 1
        self.capacity = capacity
        self.num_threads = num_threads
        self.tag = tag
        self.nrings = rings
        self.lazy = lazy
        self.fmt = fmt
        # Any single ring can transiently hold every live element (spray is
        # balanced over *tickets*, deletions are not), so each ring gets
        # full global headroom; reservations come off the shared counter.
        self.rings: List[GPQ] = [
            GPQ(capacity, num_threads, tag=f"{tag}_r{i}", arity=arity,
                lazy=lazy, fmt=fmt)
            for i in range(rings)
        ]
        self.s_spray = f"{tag}_spray"
        self.s_count = f"{tag}_count"
        self.empty_sweeps = 0    # sweeps retried against in-flight inserts

    def relaxation_bound(self) -> int:
        """Declared k: exact (= lazy) at R = 1, windowed-interference
        envelope otherwise — see the module docstring."""
        return self.lazy + 2 * (self.nrings - 1) * self.num_threads

    def init(self, mem: AtomicMemory) -> None:
        for r in self.rings:
            r.init(mem)
        mem.alloc(self.s_spray, 1, fill=0)
        mem.alloc(self.s_count, 1, fill=0)

    # -- operations ----------------------------------------------------------

    def insert(self, ctx: Ctx, tid: int, key: int, idx: int):
        assert 0 <= key < self.fmt.key_inf
        yield from ctx.op_begin(INS, (key, idx))
        old = yield from ctx.faa(self.s_count, 0, 1)
        if old >= self.capacity:
            yield from ctx.faa(self.s_count, 0, NEG1)
            yield from ctx.op_end(False, False)
            return False
        t = yield from ctx.wavefaa(self.s_spray, 0)
        ring = self.rings[t % self.nrings]
        yield from ring.announce_install(ctx, tid, key, idx)
        yield from ctx.op_end(True, True)
        return True

    def delete_min(self, ctx: Ctx, tid: int):
        """Returns (True, (key, idx)) or (False, None) — and (False, None)
        *always* means a linearizable EMPTY (certified by a zero read of
        the shared pending counter), never an abandoned attempt.  A sweep
        that finds every ring drained-and-empty while the counter is
        nonzero retries with backoff: the counted inserts are in flight
        and the fair scheduler will complete them, so the loop makes
        progress — conflating that state with EMPTY would hand callers a
        false quiescence signal."""
        yield from ctx.op_begin(DELMIN, None)
        backoff = 1
        while True:
            c = yield from ctx.load(self.s_count, 0)
            if c == 0:
                yield from ctx.op_end(None, True)
                return (False, None)
            hints = []
            for i, r in enumerate(self.rings):
                h = yield from ctx.load(r.s_hint, 0)
                hints.append((h, (i + tid) % self.nrings))
            hints.sort()
            for _, i in hints:
                got = yield from self.rings[i].pop_once(ctx, tid)
                if got is not None:
                    yield from ctx.faa(self.s_count, 0, NEG1)
                    yield from ctx.op_end(got, True)
                    return (True, got)
            # Every ring drained-and-empty during this sweep, yet count
            # was nonzero at its start: the pending inserts have not
            # completed.  Re-check the counter (a zero read certifies
            # EMPTY), else back off and retry.
            c = yield from ctx.load(self.s_count, 0)
            if c == 0:
                yield from ctx.op_end(None, True)
                return (False, None)
            self.empty_sweeps += 1
            for _ in range(backoff):
                yield from ctx.step()
            backoff = min(backoff * 2, 16)

    def peek_hint(self, ctx: Ctx, tid: int):
        best = self.fmt.key_inf
        for r in self.rings:
            h = yield from ctx.load(r.s_hint, 0)
            best = min(best, h)
        return best
