"""Linearizability checking for concurrent FIFO-queue histories (paper § IV).

A copy of ``repro/core/linearizability.py`` (the port imports nothing of the JAX
package); only the imports and the docstrings differ.

The paper logs device histories ``(proc, op, arg, ret, call, end)`` and checks
them with Porcupine's FIFO model.  Porcupine is a Go library; this module
provides the same check in Python, two ways:

* ``check_linearizable`` — the production checker: the **complete
  bad-pattern characterization** of queue linearizability for differentiated
  histories (all values distinct — guaranteed by the § IV-b token scheme),
  following Bouajjani–Emmi–Enea–Hamza.  A history is linearizable w.r.t. the
  FIFO queue iff none of the following patterns occur:

    P1  a value is dequeued but never enqueued, or dequeued/enqueued twice;
    P2  deq(x) returns before enq(x) is invoked;
    P3  FIFO inversion: enq(x) precedes enq(y) (returns before invocation)
        and deq(y) precedes deq(x);
    P4  enq(x) precedes enq(y), y is dequeued but x never is;
    P5  a deq→EMPTY whose whole interval is covered by values that are
        provably inside the queue (enq returned before, deq not yet invoked).

  This runs in O(n log n) and scales to the benchmark-sized histories.

* ``check_linearizable_search`` — a direct Wing–Gong search with
  Horn–Kroening-style memoization (what Porcupine executes), kept as an
  independent oracle: the test suite cross-validates both checkers on small
  histories, including hand-built non-linearizable ones.

Histories use the § IV conventions: op 0 = ENQ (arg = value, ret = True on
success), op 1 = DEQ (ret = value, or None for EMPTY).  Failed (FULL)
enqueues have no visible effect and are dropped before checking.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .sim import DEQ, ENQ, HistoryEvent


@dataclass
class CheckResult:
    ok: bool
    reason: str = ""
    nodes: int = 0


def _prepare(history: Sequence[HistoryEvent]) -> List[HistoryEvent]:
    ops = []
    for ev in history:
        if ev.op == ENQ and ev.ret is not True:
            continue  # failed/FULL enqueue: no effect
        ops.append(ev)
    ops.sort(key=lambda e: (e.call, e.end))
    return ops


# ---------------------------------------------------------------------------
# Complete pattern-based checker (distinct values)
# ---------------------------------------------------------------------------


def check_linearizable(history: Sequence[HistoryEvent]) -> CheckResult:
    ops = _prepare(history)
    enq: Dict[int, HistoryEvent] = {}
    deq: Dict[int, HistoryEvent] = {}
    empties: List[HistoryEvent] = []
    for ev in ops:
        if ev.op == ENQ:
            if ev.arg in enq:
                return CheckResult(False, f"P1: value {ev.arg} enqueued twice")
            enq[ev.arg] = ev
        else:
            if ev.ret is None:
                empties.append(ev)
                continue
            if ev.ret in deq:
                return CheckResult(False, f"P1: value {ev.ret} dequeued twice")
            deq[ev.ret] = ev
    for v, d in deq.items():
        e = enq.get(v)
        if e is None:
            return CheckResult(False, f"P1: value {v} dequeued, never enqueued")
        if d.end < e.call:
            return CheckResult(False, f"P2: deq({v}) returned before enq({v}) began")

    # P4: some unmatched x strictly precedes a matched (dequeued) y.
    unmatched = [v for v in enq if v not in deq]
    if unmatched:
        m = min(enq[v].end for v in unmatched)
        for y, ey in enq.items():
            if y in deq and ey.call > m:
                x = next(v for v in unmatched if enq[v].end < ey.call)
                return CheckResult(
                    False, f"P4: enq({x}) precedes enq({y}); {y} dequeued, {x} never")

    # P3: enqEnd(x) < enqCall(y)  ∧  deqEnd(y) < deqCall(x), both matched.
    matched = sorted(deq.keys(), key=lambda v: enq[v].end)
    enq_ends = [enq[v].end for v in matched]
    # prefix max (top-2, to exclude self) of deq(x).call over enq-end order
    best: List[Tuple[Tuple[int, Optional[int]], Tuple[int, Optional[int]]]] = []
    b1: Tuple[int, Optional[int]] = (-1, None)
    b2: Tuple[int, Optional[int]] = (-1, None)
    for v in matched:
        c = deq[v].call
        if c > b1[0]:
            b1, b2 = (c, v), b1
        elif c > b2[0]:
            b2 = (c, v)
        best.append((b1, b2))
    for y in matched:
        k = bisect.bisect_left(enq_ends, enq[y].call)  # x with enqEnd < enqCall(y)
        if k == 0:
            continue
        (c1, x1), (c2, x2) = best[k - 1]
        cand = (c1, x1) if x1 != y else (c2, x2)
        if cand[1] is not None and cand[0] > deq[y].end:
            return CheckResult(
                False,
                f"P3: enq({cand[1]}) precedes enq({y}) but deq({y}) precedes deq({cand[1]})")

    # P5: every EMPTY needs an uncovered instant in its interval.
    blocks: List[Tuple[int, int]] = []  # open intervals (enqEnd, deqCall/∞)
    INF = 1 << 62
    for v, e in enq.items():
        lo = e.end
        hi = deq[v].call if v in deq else INF
        if hi > lo:
            blocks.append((lo, hi))
    blocks.sort()
    merged: List[Tuple[int, int]] = []
    for lo, hi in blocks:
        if merged and lo <= merged[-1][1]:  # open intervals: touching ⇒ escapable
            if lo < merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        else:
            merged.append((lo, hi))
    starts = [b[0] for b in merged]
    for ev in empties:
        # find an instant t ∈ [call, end] outside all open blocks
        k = bisect.bisect_right(starts, ev.call) - 1
        t = ev.call
        covered = True
        while t <= ev.end:
            # is t strictly inside some block?
            while k + 1 < len(merged) and merged[k + 1][0] < t:
                k += 1
            if k >= 0 and merged[k][0] < t < merged[k][1]:
                t = merged[k][1]  # jump to the block's end (escapable boundary)
                continue
            covered = False
            break
        if covered:
            return CheckResult(
                False, f"P5: EMPTY dequeue by proc {ev.proc} at [{ev.call},{ev.end}] "
                       f"overlaps no empty instant")
    return CheckResult(True, "linearizable (complete pattern check)")


# ---------------------------------------------------------------------------
# Wing–Gong / Horn–Kroening search (independent oracle for small histories)
# ---------------------------------------------------------------------------


def check_linearizable_search(history: Sequence[HistoryEvent],
                              max_nodes: int = 500_000) -> CheckResult:
    ops = _prepare(history)
    n = len(ops)
    if n == 0:
        return CheckResult(True, "empty history")
    calls = [op.call for op in ops]
    ends = [op.end for op in ops]
    nodes = 0
    seen = set()
    stack: List[Tuple[int, Tuple[int, ...]]] = [(0, tuple())]
    full_mask = (1 << n) - 1
    while stack:
        mask, q = stack.pop()
        if mask == full_mask:
            return CheckResult(True, "linearizable (search)", nodes)
        key = (mask, q)
        if key in seen:
            continue
        seen.add(key)
        nodes += 1
        if nodes > max_nodes:
            return CheckResult(False, f"search budget exceeded ({nodes} nodes)", nodes)
        min_end = min(ends[i] for i in range(n) if not (mask >> i) & 1)
        for i in range(n):
            if (mask >> i) & 1 or calls[i] > min_end:
                continue
            op = ops[i]
            if op.op == ENQ:
                stack.append((mask | (1 << i), q + (op.arg,)))
            elif op.ret is None:
                if not q:
                    stack.append((mask | (1 << i), q))
            elif q and q[0] == op.ret:
                stack.append((mask | (1 << i), q[1:]))
    return CheckResult(False, "no valid linearization found", nodes)


# Back-compat alias used by benchmarks for very large histories: the pattern
# checker IS complete, so the "screen" is simply the checker itself.
def fast_violation_screen(history: Sequence[HistoryEvent]) -> CheckResult:
    return check_linearizable(history)
