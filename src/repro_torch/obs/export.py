"""Trace export: JSONL and Chrome trace-event emitters (DESIGN.md § 7.3) —
a copy of ``repro/obs/export.py``, which the port does not import.

Two output formats from the same drained telemetry:

* **JSONL** — one self-describing JSON object per line, ``kind``-tagged
  (``round`` | ``sync`` | ``metrics`` | ``meta`` | ``hist`` | ``flow``),
  the format ``tools/trace_check.py`` validates and ``obs.analyze``
  re-parses.
* **Chrome trace-event** — a ``{"traceEvents": [...]}`` file loadable in
  Perfetto / chrome://tracing.  In-loop rounds carry no host timestamps
  (device residency is the point), so the tick axis is the **round
  index** scaled by ``us_per_round``: each round becomes a complete
  ("X") event on the engine track and each per-shard occupancy series a
  counter ("C") track; host syncs are instant ("i") events carrying
  their wall-clock in args.

Schema v2 adds the span layer (DESIGN.md § 7.6): ``hist`` lines carry a
``Spans.summary()`` sojourn histogram, ``flow`` lines carry sampled
ticket lifecycles (birth round → claim round), and the Chrome emitter
renders each sampled ticket as a flow-event pair — an "s" (start) at its
enqueue round bound to an "f" (finish, ``bp: "e"``) at its dequeue round
under one flow id, so Perfetto draws the arrow across the round track.

The roundtrip contract (asserted in tests): ``read_jsonl(write_jsonl(
records, syncs, metrics))`` reproduces every record field exactly.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import RoundRecord, SyncPoint

__all__ = [
    "read_jsonl", "to_chrome_trace", "write_chrome_trace", "write_jsonl",
]

SCHEMA_VERSION = 2

# required fields per JSONL record kind — shared with tools/trace_check.py
JSONL_SCHEMA: Dict[str, Tuple[str, ...]] = {
    "meta": ("kind", "schema_version"),
    "round": ("kind", "engine", "round", "pops", "pushes", "occupancy",
              "imbalance", "min_key", "max_key", "overflow", "sync",
              "wall_time"),
    "sync": ("kind", "engine", "rounds", "occupancy", "wall_time",
             "host_syncs"),
    "metrics": ("kind", "metrics"),
    "hist": ("kind", "engine", "classes", "buckets", "bucket_edges",
             "hist", "max_wait", "total", "p50", "p95", "p99"),
    "flow": ("kind", "engine", "birth", "claim", "cls", "ref"),
}


def _round_line(r: RoundRecord) -> Dict[str, Any]:
    d = r.to_dict()
    d["kind"] = "round"
    return d


def _sync_line(s: SyncPoint, engine: str) -> Dict[str, Any]:
    d = s.to_dict()
    d["kind"] = "sync"
    d["engine"] = engine
    return d


def write_jsonl(path: str, records: Sequence[RoundRecord],
                syncs: Sequence[SyncPoint] = (), *,
                metrics: Optional[Dict[str, Any]] = None,
                engine: str = "fused",
                spans: Optional[Any] = None,
                extra_meta: Optional[Dict[str, Any]] = None) -> int:
    """Emit a telemetry JSONL file; returns the number of lines written.
    Line 1 is always the ``meta`` header (schema version + run info).
    ``spans`` (a drained ``obs.spans.Spans`` collector) appends one
    ``hist`` line (the sojourn histogram summary) plus one ``flow`` line
    per sampled ticket lifecycle."""
    lines: List[Dict[str, Any]] = []
    meta: Dict[str, Any] = {"kind": "meta", "schema_version": SCHEMA_VERSION,
                            "engine": engine}
    if extra_meta:
        meta.update(extra_meta)
    lines.append(meta)
    lines.extend(_round_line(r) for r in records)
    lines.extend(_sync_line(s, engine) for s in syncs)
    if spans is not None:
        hist = dict(spans.summary())
        hist["kind"] = "hist"
        hist["engine"] = engine
        lines.append(hist)
        for fl in spans.flows:
            lines.append({"kind": "flow", "engine": engine, **fl})
    if metrics is not None:
        lines.append({"kind": "metrics", "metrics": metrics})
    with open(path, "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    return len(lines)


def read_jsonl(path: str) -> Dict[str, Any]:
    """Re-parse a telemetry JSONL file into ``{"meta": dict, "records":
    [RoundRecord], "syncs": [SyncPoint], "metrics": dict, "hist": dict,
    "flows": [dict]}`` (``hist``/``flows`` empty when the file carries no
    span layer)."""
    meta: Dict[str, Any] = {}
    records: List[RoundRecord] = []
    syncs: List[SyncPoint] = []
    metrics: Dict[str, Any] = {}
    hist: Dict[str, Any] = {}
    flows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            kind = d.get("kind")
            if kind == "meta":
                meta = d
            elif kind == "round":
                d = dict(d)
                d.pop("kind")
                records.append(RoundRecord.from_dict(d))
            elif kind == "sync":
                syncs.append(SyncPoint(
                    rounds=d["rounds"], occupancy=d["occupancy"],
                    wall_time=d["wall_time"],
                    host_syncs=d.get("host_syncs", 0)))
            elif kind == "metrics":
                metrics = d.get("metrics", {})
            elif kind == "hist":
                hist = {k: v for k, v in d.items() if k != "kind"}
            elif kind == "flow":
                flows.append({k: v for k, v in d.items() if k != "kind"})
            else:
                raise ValueError(f"unknown JSONL record kind {kind!r}")
    return {"meta": meta, "records": records, "syncs": syncs,
            "metrics": metrics, "hist": hist, "flows": flows}


def to_chrome_trace(records: Sequence[RoundRecord],
                    syncs: Sequence[SyncPoint] = (), *,
                    engine: str = "fused",
                    us_per_round: float = 10.0,
                    flows: Sequence[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """Build a Chrome trace-event dict (see module doc for the time-base
    convention).  pid 1 = the engine; tid 1 = the round track, tid
    100 + s = shard s's occupancy counter track.  ``flows`` (sampled
    ticket lifecycles from ``Spans.flows``) render as enqueue→dequeue
    flow-event pairs on the round track."""
    ev: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": f"repro:{engine}"}},
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
         "args": {"name": "rounds"}},
    ]
    for r in records:
        ts = r.round * us_per_round
        ev.append({
            "ph": "X", "pid": 1, "tid": 1, "name": f"round {r.round}",
            "cat": "round", "ts": ts, "dur": us_per_round,
            "args": {"round": r.round, "pops": r.pops, "pushes": r.pushes,
                     "occupancy": r.occupancy, "imbalance": r.imbalance,
                     "min_key": r.min_key, "max_key": r.max_key,
                     "overflow": r.overflow, "sync": r.sync},
        })
        ev.append({
            "ph": "C", "pid": 1, "tid": 1, "name": "occupancy",
            "cat": "occupancy", "ts": ts,
            "args": {f"shard{s}": o for s, o in enumerate(r.occupancy)},
        })
        ev.append({
            "ph": "C", "pid": 1, "tid": 1, "name": "imbalance",
            "cat": "imbalance", "ts": ts, "args": {"pops": r.imbalance},
        })
    for i, s in enumerate(syncs):
        ev.append({
            "ph": "i", "pid": 1, "tid": 1, "name": f"sync {i}",
            "cat": "sync", "s": "p", "ts": s.rounds * us_per_round,
            "args": {"rounds": s.rounds, "occupancy": s.occupancy,
                     "wall_time": s.wall_time,
                     "host_syncs": s.host_syncs},
        })
    for i, fl in enumerate(flows):
        args = {"birth": fl["birth"], "claim": fl["claim"],
                "cls": fl["cls"], "ref": fl["ref"],
                "sojourn": fl["claim"] - fl["birth"]}
        ev.append({
            "ph": "s", "pid": 1, "tid": 1, "id": i,
            "name": f"span cls{fl['cls']}", "cat": "span",
            "ts": fl["birth"] * us_per_round, "args": args,
        })
        ev.append({
            "ph": "f", "pid": 1, "tid": 1, "id": i, "bp": "e",
            "name": f"span cls{fl['cls']}", "cat": "span",
            "ts": fl["claim"] * us_per_round, "args": args,
        })
    return {"traceEvents": ev,
            "displayTimeUnit": "ms",
            "metadata": {"engine": engine, "us_per_round": us_per_round,
                         "schema_version": SCHEMA_VERSION,
                         "time_base": "round-index"}}


def write_chrome_trace(path: str, records: Sequence[RoundRecord],
                       syncs: Sequence[SyncPoint] = (), *,
                       engine: str = "fused",
                       us_per_round: float = 10.0,
                       flows: Sequence[Dict[str, Any]] = ()) -> int:
    """Write the Perfetto-loadable trace file; returns the event count."""
    trace = to_chrome_trace(records, syncs, engine=engine,
                            us_per_round=us_per_round, flows=flows)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
