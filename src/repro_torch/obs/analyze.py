"""Trace analysis: timelines and rank-error measurement (DESIGN.md § 7.4) —
a copy of ``repro/obs/analyze.py``, which the port does not import.

The payoff of the trace planes: the relaxed mesh engines *declare* a
worst-case rank-error envelope (``sched.relaxed.mesh_relaxation_bound``,
the paper's k-relaxation bound specialised to the shard/batch geometry)
— this module *measures* the error an actual run incurred and compares.

Two measurement levels:

* :func:`measured_rank_error` — exact, from a legacy-engine pop trace
  (``PriorityMeshRoundRunner(trace=True, fused=False)``): a pop's rank
  error is the number of strictly smaller keys popped in later rounds
  (items it "jumped over"); the run's error is the max over pops.
* :func:`key_inversions` — a proxy computable from the fused engines'
  drained planes alone (no per-item history): the worst inversion depth
  ``max_key[r] − min_key[r']`` over round pairs ``r < r'`` where an
  earlier round popped a key larger than a later round's minimum.  Zero
  inversions ⇒ zero rank error; the proxy is in key units, not ranks, so
  it bounds *which rounds* violated order, not by how many items.

:func:`rank_error_vs_envelope` packages either measurement against the
declared bound for export/plotting.

The span layer (DESIGN.md § 7.6) adds the *latency* face of the same
question: :func:`sojourn_percentiles` reads p50/p95/p99 sojourn out of an
exported ``Spans.summary()`` histogram, :func:`max_wait_highwater` names
the worst-served class, and :func:`starvation_flags` turns the per-class
max-wait high-waters into starvation verdicts — cross-checkable against
the sim fabric's host-side ``wait_stats()`` accounting.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .trace import KEY_SENTINEL, RoundRecord

__all__ = [
    "imbalance_timeline", "key_inversions", "max_wait_highwater",
    "measured_rank_error", "occupancy_timeline", "rank_error_vs_envelope",
    "sojourn_percentiles", "starvation_flags",
]


def occupancy_timeline(records: Sequence[RoundRecord]
                       ) -> List[Tuple[int, List[int]]]:
    """``[(round, [per-shard occupancy])]`` in round order."""
    return [(r.round, list(r.occupancy))
            for r in sorted(records, key=lambda r: r.round)]


def imbalance_timeline(records: Sequence[RoundRecord]
                       ) -> List[Tuple[int, int]]:
    """``[(round, claim imbalance)]`` in round order (max − min per-shard
    pops; the claim_schedule fairness signal)."""
    return [(r.round, r.imbalance)
            for r in sorted(records, key=lambda r: r.round)]


def measured_rank_error(history: Sequence[Sequence[int]],
                        inserts: Optional[Sequence[Sequence[int]]] = None
                        ) -> int:
    """Exact rank error from a per-round pop-key history
    (``history[r]`` = keys popped in round ``r``; the shape a
    ``PriorityMeshRoundRunner(trace=True)`` recording flattens to).  A
    pop of key ``k`` in round ``r`` has rank error = number of *queued*
    keys strictly smaller than ``k`` it overtook — smaller keys popped in
    rounds > ``r`` that were already inserted before round ``r``.
    Returns the max over all pops — directly comparable to the declared
    k-relaxation bound.

    ``inserts[r]`` = keys published in round ``r`` (visible to pops of
    rounds > ``r``); pops with no matching insert are seeds, present from
    the start.  Without ``inserts`` every key is treated as present from
    round 0 — an *upper bound* that also charges a pop for smaller keys
    that did not exist yet (spawn-tree workloads can generate children
    smaller than long-popped parents; only pass ``inserts=None`` when
    keys are monotone over spawn edges, e.g. delta-stepping buckets)."""
    # match each pop to its insert round: FIFO per key value (equal keys
    # are interchangeable), unmatched pops are seeds (round -1)
    ins_q: Dict[int, List[int]] = {}
    ins_pos: Dict[int, int] = {}
    if inserts is not None:
        for r, keys in enumerate(inserts):
            for k in keys:
                ins_q.setdefault(k, []).append(r)
    pops: List[Tuple[int, int, int]] = []        # (round, key, insert round)
    for r, keys in enumerate(history):
        for k in keys:
            q = ins_q.get(k)
            p = ins_pos.get(k, 0)
            ins = -1
            if q is not None and p < len(q):
                ins, ins_pos[k] = q[p], p + 1
            pops.append((r, k, ins))
    # backward over rounds: ``active`` holds the sorted keys of pops from
    # later rounds still eligible at the current round (insert < r); as r
    # decreases, late-inserted items retire from eligibility exactly once
    worst = 0
    by_round: Dict[int, List[Tuple[int, int, int]]] = {}
    for p in pops:
        by_round.setdefault(p[0], []).append(p)
    active: List[int] = []                       # sorted keys, ins < r
    retire: List[Tuple[int, int]] = []           # (-ins, key) heap order
    for r in sorted(by_round, reverse=True):
        while retire and -retire[0][0] >= r:
            _, k = heapq.heappop(retire)
            del active[bisect.bisect_left(active, k)]
        for _, k, _ in by_round[r]:
            worst = max(worst, bisect.bisect_left(active, k))
        for _, k, ins in by_round[r]:
            bisect.insort(active, k)
            heapq.heappush(retire, (-ins, k))
    return worst


def key_inversions(records: Sequence[RoundRecord]
                   ) -> List[Dict[str, int]]:
    """Plane-level inversion proxy: rounds whose max popped key exceeds a
    *later* round's min popped key (order violation visible from extrema
    alone).  Returns ``[{round, later_round, depth}]`` with ``depth`` in
    key units; empty list ⇒ the trace is consistent with zero rank
    error."""
    recs = [r for r in sorted(records, key=lambda r: r.round)
            if r.min_key != KEY_SENTINEL]    # skip empty rounds
    out: List[Dict[str, int]] = []
    # running max of max_key over earlier rounds; report each later round
    # whose min undercuts it
    best_round, run_max = -1, -KEY_SENTINEL
    for r in recs:
        if r.min_key < run_max:
            out.append({"round": r.round, "later_round": best_round,
                        "depth": run_max - r.min_key})
        if r.max_key > run_max:
            run_max, best_round = r.max_key, r.round
    # normalise field names: "round" = the earlier offender, "later_round"
    # = where the smaller key surfaced
    for o in out:
        o["round"], o["later_round"] = o["later_round"], o["round"]
    return out


def rank_error_vs_envelope(envelope: int, *,
                           history: Optional[Sequence[Sequence[int]]] = None,
                           inserts: Optional[Sequence[Sequence[int]]] = None,
                           records: Optional[Sequence[RoundRecord]] = None
                           ) -> Dict[str, Any]:
    """Measured rank error against the declared ``mesh_relaxation_bound``
    envelope.  Pass ``history`` (exact, legacy trace; ``inserts`` refines
    it — see :func:`measured_rank_error`) and/or ``records`` (fused-plane
    inversion proxy); the result is export-ready."""
    out: Dict[str, Any] = {"envelope": int(envelope)}
    if history is not None:
        err = measured_rank_error(history, inserts)
        out["measured_rank_error"] = err
        out["within_envelope"] = err <= envelope
        out["slack"] = int(envelope) - err
    if records is not None:
        inv = key_inversions(records)
        out["key_inversions"] = len(inv)
        out["max_inversion_depth"] = max((i["depth"] for i in inv),
                                         default=0)
    if history is None and records is None:
        raise ValueError("need history and/or records to measure")
    return out


# ---------------------------------------------------------------------------
# span / sojourn analysis (DESIGN.md § 7.6)
# ---------------------------------------------------------------------------


def sojourn_percentiles(summary: Dict[str, Any],
                        qs: Sequence[float] = (0.5, 0.95, 0.99),
                        cls: Optional[int] = None) -> Dict[str, Optional[int]]:
    """Sojourn percentiles (in rounds) from an exported ``Spans.summary()``
    dict — the host twin of ``Spans.percentile`` for post-hoc analysis of
    a jsonl "hist" record.  Log2 buckets resolve to their *upper* edge
    (pessimistic: the reported pNN never understates the true quantile).
    ``cls`` restricts to one histogram row; default aggregates all
    classes.  Empty histograms yield ``None`` per quantile."""
    hist = summary["hist"]
    edges = summary["bucket_edges"]
    rows = [hist[cls]] if cls is not None else list(hist)
    agg = [sum(col) for col in zip(*rows)] if rows else []
    total = sum(agg)
    out: Dict[str, Optional[int]] = {}
    for q in qs:
        name = f"p{round(q * 100)}"
        if total == 0:
            out[name] = None
            continue
        target, c = q * total, 0
        for b, n in enumerate(agg):
            c += n
            if c >= target:
                out[name] = int(edges[b])
                break
    return out


def max_wait_highwater(summary: Dict[str, Any]) -> Dict[str, Any]:
    """Per-class max-wait high-water from ``Spans.summary()``: the device
    scatter-max kept the worst sojourn each class ever saw; this names the
    worst-served class (ties → lowest class index)."""
    mw = [int(w) for w in summary["max_wait"]]
    worst = max(range(len(mw)), key=lambda c: mw[c]) if mw else None
    return {"per_class": mw, "worst_class": worst,
            "high_water": max(mw, default=0)}


def starvation_flags(summary: Dict[str, Any], *, factor: float = 8.0,
                     wait_stats: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """Starvation verdicts from the span histograms: a class is flagged
    when its max-wait high-water exceeds ``factor`` × the all-class median
    sojourn — some class waits far beyond typical service while the
    engine keeps processing.  With ``wait_stats`` (a fabric
    ``wait_stats()`` dict from the sim runtime, DESIGN.md § 5.4) the
    device-side verdict is cross-checked against the host-side
    accounting: both sides classify class 0 as urgent and classes ≥ 1 as
    normal, and ``fabric["agrees"]`` reports whether they point the same
    way on *which lane waits longer* — the scales differ (scheduler steps
    vs engine rounds), so only the direction is comparable."""
    p50 = sojourn_percentiles(summary, qs=(0.5,))["p50"]
    mw = [int(w) for w in summary["max_wait"]]
    threshold = factor * max(p50 or 0, 1)
    flags = [w > threshold for w in mw]
    out: Dict[str, Any] = {
        "p50": p50, "factor": factor, "threshold": threshold,
        "per_class": [{"cls": c, "max_wait": w, "starved": bool(f)}
                      for c, (w, f) in enumerate(zip(mw, flags))],
        "starved_classes": [c for c, f in enumerate(flags) if f],
    }
    if wait_stats is not None:
        span_urgent = mw[0] if mw else 0
        span_normal = max(mw[1:], default=0)
        fab_urgent = float(wait_stats.get("urgent_max_wait", 0.0))
        fab_normal = float(wait_stats.get("normal_max_wait", 0.0))
        out["fabric"] = {
            "urgent_max_wait": fab_urgent, "normal_max_wait": fab_normal,
            "span_urgent_max": span_urgent, "span_normal_max": span_normal,
            "agrees": (span_normal >= span_urgent)
                      == (fab_normal >= fab_urgent),
        }
    return out
