"""Priority-linearizability checking for concurrent histories (§ IV machinery
extended to priority semantics, DESIGN.md § 5.3).

A copy of ``repro/sched/plinearizability.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

History format: ``HistoryEvent`` rows as logged by the scheduler, with

* op 0 (INS)    — ``arg = (key, ident)``, ``ret = True`` on success
                  (failed/FULL inserts are dropped, like FULL enqueues);
* op 1 (DELMIN) — ``ret = (key, ident)``, ``None`` for EMPTY, or ``False``
                  for an abandoned attempt (dropped: it claims nothing).

``ident`` values are globally unique (the § IV-b differentiated-history
token scheme); keys may repeat.

``check_p_linearizable(history, k)`` — the production checker: a
**bad-pattern necessary-condition check** for k-relaxed priority
linearizability ("delete-min returns a key within the k+1 smallest pending
keys at some instant of its interval").  Patterns:

  Q1  an ident deleted but never inserted, inserted twice, or deleted
      twice; or a delete's key disagreeing with its insert's key;
  Q2  delmin(x) returns before ins(x) is invoked;
  Q3  rank violation: for some delmin returning key v, every instant of
      its interval has more than k *provably pending* elements with key
      strictly below v (provably pending at t: the insert returned before
      t and no delete of that ident was invoked by t);
  Q4  a delmin → EMPTY whose whole interval is covered by provably
      pending elements (the priority P5).

Provably-pending undercounts what any real linearization must keep
pending, so a Q3/Q4 hit refutes every linearization: the check is sound.
It is not complete (k-relaxed membership is a search problem — exact
checking generalizes Gibbons–Korach); ``check_p_linearizable_search`` is
the exact Wing–Gong oracle for small histories, and the test suite
cross-validates the two on positive and negative fixtures.

Q3/Q4 run in O(n log n): delmins sorted by returned key share one
min-coverage segment tree over compressed event times, elements entering
as the key threshold passes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.linearizability import CheckResult
from ..core.sim import HistoryEvent
from .gpq import DELMIN, INS

_INF = 1 << 62


class _MinSegTree:
    """Range-add / range-min with lazy propagation over m leaves."""

    def __init__(self, m: int) -> None:
        self.n = 1
        while self.n < max(m, 1):
            self.n *= 2
        self.mn = [0] * (2 * self.n)
        self.lz = [0] * (2 * self.n)

    def _push(self, x: int) -> None:
        if self.lz[x]:
            for c in (2 * x, 2 * x + 1):
                self.lz[c] += self.lz[x]
                self.mn[c] += self.lz[x]
            self.lz[x] = 0

    def add(self, lo: int, hi: int, v: int, x: int = 1, l: int = 0,
            r: Optional[int] = None) -> None:
        """Add v on [lo, hi] inclusive."""
        if r is None:
            r = self.n - 1
        if hi < l or r < lo or lo > hi:
            return
        if lo <= l and r <= hi:
            self.mn[x] += v
            self.lz[x] += v
            return
        self._push(x)
        mid = (l + r) // 2
        self.add(lo, hi, v, 2 * x, l, mid)
        self.add(lo, hi, v, 2 * x + 1, mid + 1, r)
        self.mn[x] = min(self.mn[2 * x], self.mn[2 * x + 1])

    def query(self, lo: int, hi: int, x: int = 1, l: int = 0,
              r: Optional[int] = None) -> int:
        if r is None:
            r = self.n - 1
        if hi < l or r < lo or lo > hi:
            return _INF
        if lo <= l and r <= hi:
            return self.mn[x]
        self._push(x)
        mid = (l + r) // 2
        return min(self.query(lo, hi, 2 * x, l, mid),
                   self.query(lo, hi, 2 * x + 1, mid + 1, r))


def _prepare(history: Sequence[HistoryEvent]) -> List[HistoryEvent]:
    ops = []
    for ev in history:
        if ev.op == INS and ev.ret is not True:
            continue                      # failed/FULL insert: no effect
        if ev.op == DELMIN and ev.ret is False:
            continue                      # abandoned attempt: claims nothing
        ops.append(ev)
    ops.sort(key=lambda e: (e.call, e.end))
    return ops


def check_p_linearizable(history: Sequence[HistoryEvent],
                         k: int = 0) -> CheckResult:
    ops = _prepare(history)
    ins: Dict[int, HistoryEvent] = {}
    dels: Dict[int, HistoryEvent] = {}
    keys: Dict[int, int] = {}
    empties: List[HistoryEvent] = []
    for ev in ops:
        if ev.op == INS:
            key, ident = ev.arg
            if ident in ins:
                return CheckResult(False, f"Q1: ident {ident} inserted twice")
            ins[ident] = ev
            keys[ident] = key
        else:
            if ev.ret is None:
                empties.append(ev)
                continue
            key, ident = ev.ret
            if ident in dels:
                return CheckResult(False, f"Q1: ident {ident} deleted twice")
            dels[ident] = ev
    for ident, d in dels.items():
        if ident not in ins:
            return CheckResult(
                False, f"Q1: ident {ident} deleted, never inserted")
        if keys[ident] != d.ret[0]:
            return CheckResult(
                False, f"Q1: ident {ident} deleted with key {d.ret[0]}, "
                       f"inserted with {keys[ident]}")
        if d.end < ins[ident].call:
            return CheckResult(
                False, f"Q2: delmin({ident}) returned before its insert began")

    # Q3/Q4 — min-coverage over provably-pending intervals.  An element is
    # provably pending on the open interval (ins.end, del.call) — or
    # (ins.end, ∞) if never deleted.  Compress all event times.
    coords = sorted({t for ev in ops for t in (ev.call, ev.end)} | {_INF})
    pos = {t: i for i, t in enumerate(coords)}
    tree = _MinSegTree(len(coords))

    elements = sorted(
        ((keys[ident], ident) for ident in ins), key=lambda p: p[0])
    queries = sorted(
        ((d.ret[0], d) for d in dels.values()), key=lambda p: p[0])

    def interval(ident: int) -> Tuple[int, int]:
        lo = ins[ident].end
        hi = dels[ident].call if ident in dels else _INF
        return lo, hi

    ei = 0
    for v, d in queries:
        while ei < len(elements) and elements[ei][0] < v:
            lo, hi = interval(elements[ei][1])
            # open interval (lo, hi) over discrete distinct event times:
            # covered leaves are those strictly inside.
            a, b = pos[lo] + 1, pos[hi] - 1
            tree.add(a, b, 1)
            ei += 1
        mn = tree.query(pos[d.call], pos[d.end])
        if mn > k:
            _, ident = d.ret
            return CheckResult(
                False,
                f"Q3: delmin returned key {v} (ident {ident}) but every "
                f"instant of [{d.call},{d.end}] has > {k} smaller pending "
                f"keys (min coverage {mn})")
    while ei < len(elements):
        lo, hi = interval(elements[ei][1])
        tree.add(pos[lo] + 1, pos[hi] - 1, 1)
        ei += 1
    for d in empties:
        mn = tree.query(pos[d.call], pos[d.end])
        if mn > 0:
            return CheckResult(
                False,
                f"Q4: EMPTY delmin by proc {d.proc} at [{d.call},{d.end}] "
                f"overlaps no empty instant (min coverage {mn})")
    return CheckResult(
        True, f"priority-linearizable up to relaxation {k} (pattern check)")


def mesh_trace_history(trace, seeds) -> List[HistoryEvent]:
    """Convert a ``PriorityMeshRoundRunner(trace=True)`` recording into a
    checkable history.  ``seeds`` is the run's initial ``[(key, ident)]``
    list; ``trace`` is the runner's per-round list of ``{"pops": (keys
    (S,B), vals (S,B), ok (S,B)), "pushes": (gkeys, gvals, active)}``.

    Timing reflects the engine's linearization structure: rounds are
    totally ordered by the collective schedule; within a round every
    shard's pops share ONE interval (they are concurrent — no
    linearization is forced to keep a same-round sibling pop pending),
    and the publish wave's inserts follow in a later interval of the same
    round.  ``ident`` = the payload word, so payloads must be unique
    across the run (use a spawn-tree workload, not a workload that can
    re-publish a payload).  Feed the result to ``check_p_linearizable``
    with ``k = relaxed.mesh_relaxation_bound(...)``."""
    h: List[HistoryEvent] = []
    for key, ident in seeds:
        h.append(HistoryEvent(proc=0, op=INS, arg=(int(key), int(ident)),
                              ret=True, call=0, end=1))
    for r, rec in enumerate(trace):
        t = 4 * r + 4
        pk, pv, ok = rec["pops"]
        for s in range(pk.shape[0]):
            for lane in range(pk.shape[1]):
                if ok[s, lane]:
                    h.append(HistoryEvent(
                        proc=s, op=DELMIN, arg=None,
                        ret=(int(pk[s, lane]), int(pv[s, lane])),
                        call=t, end=t + 1))
        gk, gv, ga = rec["pushes"]
        for i in range(len(gk)):
            if ga[i]:
                h.append(HistoryEvent(proc=0, op=INS,
                                      arg=(int(gk[i]), int(gv[i])),
                                      ret=True, call=t + 2, end=t + 3))
    return h


# ---------------------------------------------------------------------------
# Exact Wing–Gong search against the k-relaxed priority-queue spec
# (independent oracle for small histories)
# ---------------------------------------------------------------------------


def check_p_linearizable_search(history: Sequence[HistoryEvent], k: int = 0,
                                max_nodes: int = 500_000) -> CheckResult:
    ops = _prepare(history)
    n = len(ops)
    if n == 0:
        return CheckResult(True, "empty history")
    calls = [op.call for op in ops]
    ends = [op.end for op in ops]
    nodes = 0
    seen = set()
    stack: List[Tuple[int, frozenset]] = [(0, frozenset())]
    full_mask = (1 << n) - 1
    while stack:
        mask, pend = stack.pop()
        if mask == full_mask:
            return CheckResult(True, "p-linearizable (search)", nodes)
        key_state = (mask, pend)
        if key_state in seen:
            continue
        seen.add(key_state)
        nodes += 1
        if nodes > max_nodes:
            return CheckResult(False, f"search budget exceeded ({nodes})",
                               nodes)
        min_end = min(ends[i] for i in range(n) if not (mask >> i) & 1)
        for i in range(n):
            if (mask >> i) & 1 or calls[i] > min_end:
                continue
            op = ops[i]
            if op.op == INS:
                stack.append((mask | (1 << i), pend | {op.arg}))
            elif op.ret is None:
                if not pend:
                    stack.append((mask | (1 << i), pend))
            else:
                item = (op.ret[0], op.ret[1])
                if item in pend:
                    # k-relaxed: at most k pending keys strictly below
                    rank = sum(1 for (kk, _) in pend if kk < item[0])
                    if rank <= k:
                        stack.append((mask | (1 << i), pend - {item}))
    return CheckResult(False, "no valid k-relaxed linearization found", nodes)
