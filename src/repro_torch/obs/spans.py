"""Task-lifecycle span planes — the PyTorch twin of ``repro/obs/spans.py``:
device sojourn histograms for the fused round engines.

Every install stamps the item's birth round; at claim the round records
``sojourn = claim round - birth round`` into a log2 histogram per class
row.  The stamps travel with the queue state:

* the ring packs them into its enq-flag plane as ``(birth << 1) | 1``
  (``kernels.ring_slots``: the packed waves); seeds keep flag 1, so they
  are born at round 0, and ``enqs & 1`` gives back the unspanned plane.
  The packing caps the round clock at ``SPAN_ROUND_CAP`` = 2^30, which
  the engine core's chunk loop enforces;
* the heap moves a rider plane beside ``vals`` through every sift
  (``kernels.heap_batch.heap_apply(rider=, oprider=)``).

A ``SpanPlane`` is four int32 tensors on the engine's device:

* ``hist``   (L, K, NB+1) — lane-major: claim lane b owns ``hist[b]``;
  columns 0..NB-1 are bucket counts per class, column NB the class's
  max-wait high-water (lanes fold at the host drain);
* ``flows``  (F, 4) — a ring of ``(birth, claim, cls, ref)`` exemplars,
  one per recorded round (lane 0's, when lane 0 claimed);
* ``fcount`` () — exemplars ever written (the ring's cursor);
* ``round``  () — the run's round clock (``span_tick`` bumps it once a
  round, after the round's stamps and records).

The mesh engines carry the plane stacked, one a shard under a leading
shard axis; ``Spans`` folds the shards at the host as it folds lanes.

Bucket 0 holds sojourn 0, bucket b >= 1 holds [2^(b-1), 2^b - 1], and
the top bucket absorbs the tail: ``32 - clz(s)`` clamped, no float.

The round engines record through ``obs.record.obs_record`` (one kernel
launch a round on the card, these torch ops on the CPU), in place on the
engine's kept plane; ``span_record`` and ``span_tick`` are the
functional faces.  ``Spans`` is the host collector; its drain keeps a
device copy of the plane and reads it to the host on first use.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..kernels._build import resolve_device
from ..kernels.ring_slots import SPAN_ROUND_CAP

__all__ = [
    "SPAN_ROUND_CAP", "SpanPlane", "Spans", "bucket_edges", "bucket_of",
    "span_init", "span_record", "span_tick",
]

DEFAULT_BUCKETS = 16


class SpanPlane(NamedTuple):
    """Device sojourn accumulator (see the module doc)."""
    hist: Any       # (L, K, NB+1) int32: buckets + max-wait column
    flows: Any      # (F, 4) int32: (birth, claim, cls, ref) ring
    fcount: Any     # () int32: flow rows ever written
    round: Any      # () int32: the run's round clock

    @property
    def lanes(self) -> int:
        return self.hist.shape[-3]

    @property
    def classes(self) -> int:
        return self.hist.shape[-2]

    @property
    def buckets(self) -> int:
        return self.hist.shape[-1] - 1

    @property
    def flow_capacity(self) -> int:
        return self.flows.shape[-2]


def span_init(classes: int, *, buckets: int = DEFAULT_BUCKETS,
              flow_capacity: int = 64, lanes: int = 1,
              device="cuda") -> SpanPlane:
    """Empty span plane on ``device`` with ``classes`` histogram rows and
    one accumulator slice per claim lane (``lanes`` = the engine's
    batch)."""
    k, nb, f, l = int(classes), int(buckets), int(flow_capacity), int(lanes)
    if k < 1:
        raise ValueError(f"span classes must be >= 1, got {k}")
    if nb < 2:
        raise ValueError(f"span buckets must be >= 2, got {nb}")
    if f < 1:
        raise ValueError(f"span flow_capacity must be >= 1, got {f}")
    if l < 1:
        raise ValueError(f"span lanes must be >= 1, got {l}")
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    return SpanPlane(hist=torch.zeros((l, k, nb + 1), **i32),
                     flows=torch.full((f, 4), -1, **i32),
                     fcount=torch.zeros((), **i32),
                     round=torch.zeros((), **i32))


def _bucket_ix(sojourn: torch.Tensor, buckets: int) -> torch.Tensor:
    """Exact integer log2 bucket: 0 for sojourn 0, else the bit length
    (32 - clz) clamped to the top bucket."""
    s = torch.clamp(sojourn.to(torch.int32), min=0).long()
    # the bit length: how many of 1, 2, 4, ..., 2^30 are <= s
    pow2 = torch.bitwise_left_shift(
        torch.ones(31, dtype=torch.long, device=s.device),
        torch.arange(31, device=s.device))
    bl = (s[..., None] >= pow2).sum(-1)
    return torch.clamp(bl, max=buckets - 1).int()


def span_record_(sp: SpanPlane, cls, sojourn, valid, ref) -> SpanPlane:
    """Accumulate one claim wave's sojourns IN PLACE, with torch ops only
    (nothing is read back).  ``cls``/``sojourn``/``ref`` are (B,) int32
    with B == ``sp.lanes``; invalid lanes drop.  Lane b bumps
    ``hist[b, row, bucket]`` and raises ``hist[b, row, NB]`` to its
    sojourn (row = ``cls`` clamped to the rows); lane 0, when it claimed,
    writes its lifecycle ``(round - sojourn, round, row, ref)`` at flow
    slot ``fcount % F`` and bumps ``fcount``."""
    l, k, nbp1 = sp.hist.shape
    nb = nbp1 - 1
    f = sp.flows.shape[0]
    dev = sp.hist.device
    valid = torch.as_tensor(valid, device=dev).bool().reshape(-1)
    if valid.shape[0] != l:
        raise ValueError(f"span_record wave has {valid.shape[0]} lanes "
                         f"but the plane was built for {l}")
    s = torch.clamp(torch.as_tensor(sojourn, device=dev).to(torch.int32),
                    min=0)
    row = torch.clamp(torch.as_tensor(cls, device=dev).to(torch.int32)
                      .reshape(-1), 0, k - 1)
    ref = torch.as_tensor(ref, device=dev).to(torch.int32).reshape(-1)
    bucket = _bucket_ix(s, nb)
    col = torch.arange(nbp1, dtype=torch.int32, device=dev)[None, None, :]
    rowm = ((row[:, None] == torch.arange(k, dtype=torch.int32,
                                          device=dev)[None, :])
            & valid[:, None])[:, :, None]
    # a bucket in [0, NB - 1] never hits column NB, which the max owns
    bumped = sp.hist + (rowm & (bucket[:, None, None] == col)).int()
    sp.hist.copy_(torch.where(rowm & (col == nb),
                              torch.maximum(sp.hist, s[:, None, None]),
                              bumped))
    rec = valid[0]
    entry = torch.stack([sp.round - s[0], sp.round.clone(), row[0],
                         ref[0]]).int()
    slotmask = ((torch.arange(f, device=dev) == torch.remainder(sp.fcount, f))
                & rec)
    sp.flows.copy_(torch.where(slotmask[:, None], entry[None, :], sp.flows))
    sp.fcount.add_(rec.int())
    return sp


def span_record(sp: SpanPlane, cls, sojourn, valid, ref) -> SpanPlane:
    """Functional ``span_record_``: a new plane with the wave recorded
    (reference ``span_record``)."""
    out = SpanPlane(*(t.clone() for t in sp))
    return span_record_(out, cls, sojourn, valid, ref)


def span_tick_(sp: SpanPlane) -> SpanPlane:
    """Advance the round clock in place — once a round, after its stamps
    and records (children stamped this round carry the pre-tick clock)."""
    sp.round.add_(1)
    return sp


def span_tick(sp: SpanPlane) -> SpanPlane:
    """Functional ``span_tick_`` (reference ``span_tick``)."""
    return sp._replace(round=sp.round + 1)


def bucket_edges(buckets: int = DEFAULT_BUCKETS) -> np.ndarray:
    """Inclusive upper edge of each bucket: ``[0, 1, 3, 7, ...,
    2^(NB-1) - 1]``.  The top bucket is clamped, so its edge is a lower
    bound on the true maximum (pair with ``max_wait``)."""
    b = np.arange(int(buckets))
    return np.where(b == 0, 0, (1 << b) - 1).astype(np.int64)


def bucket_of(sojourn: int, buckets: int = DEFAULT_BUCKETS) -> int:
    """Host twin of the device bucket rule."""
    s = int(sojourn)
    if s <= 0:
        return 0
    return min(s.bit_length(), int(buckets) - 1)


class Spans:
    """Host-side span collector for one engine instance.

    Pass ``spans=Spans(...)`` to a fused round engine: the engine carries
    a ``SpanPlane`` (and its birth stamps) through its rounds and drains
    it here at every readback, the same readback telemetry uses.  With
    ``spans=None`` the engine's round is the unspanned one.

    ``classes`` sizes the histogram rows when ``class_of`` is given: a
    function from the popped keys (priority) or payloads (FIFO), a (B,)
    int32 tensor, to class rows, made of torch ops that read nothing back
    (it runs inside the round, in the captured graph on the card).
    Without it every item is class 0.  The in-round histogram is
    cumulative within a run, so ``drain`` REPLACES the current-run
    snapshot; ``begin_run`` banks it into cross-run totals.
    ``registry`` (a ``MetricsRegistry``, made when not given) receives
    ``<engine>.sojourn_p50/p95/p99`` and per-class
    ``<engine>.max_wait[cls=c]`` gauges."""

    def __init__(self, *, classes: int = 1,
                 buckets: int = DEFAULT_BUCKETS, flow_capacity: int = 64,
                 engine: str = "fused", registry=None,
                 class_of: Optional[Callable] = None) -> None:
        if int(classes) < 1:
            raise ValueError(f"span classes must be >= 1, got {classes}")
        if int(buckets) < 2:
            raise ValueError(f"span buckets must be >= 2, got {buckets}")
        if int(flow_capacity) < 1:
            raise ValueError(
                f"span flow_capacity must be >= 1, got {flow_capacity}")
        self.classes = int(classes)
        self.buckets = int(buckets)
        self.flow_capacity = int(flow_capacity)
        self.engine = engine
        self.class_of = class_of
        if registry is None:
            from .metrics import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self.reset()

    def reset(self) -> None:
        self._hist_total: Optional[np.ndarray] = None
        self._maxw_total: Optional[np.ndarray] = None
        self._flows_total: List[Dict[str, int]] = []
        self._rounds_total = 0
        self._snap = None          # latest drained host plane (this run)
        self._snap_dev = None      # latest device copy, not yet read
        self._gauges_stale = False
        self._dropped = 0

    # -- engine-facing hooks --------------------------------------------------

    def begin_run(self) -> None:
        """Called by the engine at the start of ``run``: bank the previous
        run's snapshot into the cross-run totals."""
        self._bank()

    def drain(self, sp: SpanPlane, *, wall_time: float = None) -> None:
        """REPLACE the current-run snapshot with a copy of ``sp``, taken on
        its device (the engine updates its plane in place); the host
        transfer and the lane fold wait for the first host read."""
        del wall_time                  # kept for drain-signature symmetry
        self._snap_dev = SpanPlane(*(t.clone() for t in sp))

    def finish(self, stats: Dict[str, int]) -> None:
        """Mark the span gauges stale: they are published on the next
        host read."""
        del stats                      # engine stats go through Telemetry
        self._gauges_stale = True

    def _materialize(self) -> None:
        """Fold the held device copy into the host snapshot and flush
        stale gauges.  Idempotent; every host accessor calls it."""
        if self._snap_dev is not None:
            host = SpanPlane(*(np.asarray(t.cpu(), np.int64)
                               for t in self._snap_dev))
            self._snap_dev = None
            acc = host.hist
            k, nbp1 = acc.shape[-2:]
            acc = acc.reshape(-1, k, nbp1)
            hist2 = acc[..., :nbp1 - 1].sum(0)
            maxw2 = acc[..., nbp1 - 1].max(0)
            # a stacked plane (the mesh engines: one a shard) folds its
            # shards as it folds its lanes, and its flow rings one after
            # another
            flows = host.flows.reshape(-1, *host.flows.shape[-2:])
            fcount = host.fcount.reshape(-1)
            rows, dropped = [], 0
            for f, c in zip(flows, fcount):
                r, d = self._ring_rows(f, int(c))
                rows.extend(r)
                dropped += d
            self._snap = (hist2, maxw2, rows, int(host.round.reshape(-1)[0]),
                          dropped)
            self._dropped = dropped
        if self._gauges_stale:
            self._gauges_stale = False  # before publish: re-entry guard
            from .metrics import metric_key
            for q, name in ((0.50, "sojourn_p50"), (0.95, "sojourn_p95"),
                            (0.99, "sojourn_p99")):
                p = self.percentile(q)
                if p is not None:
                    self.registry.gauge(f"{self.engine}.{name}", int(p))
            for c, w in enumerate(self.max_wait):
                self.registry.gauge(
                    metric_key(self.engine, "max_wait", cls=c), int(w))

    @property
    def dropped_flows(self) -> int:
        """Flow-ring overwrites in the current run (sampling, never an
        error)."""
        self._materialize()
        return self._dropped

    # -- host analysis surface ------------------------------------------------

    @staticmethod
    def _ring_rows(flows: np.ndarray, fcount: int):
        f = flows.shape[0]
        keep = min(fcount, f)
        dropped = max(fcount - f, 0)
        slots = np.arange(fcount - keep, fcount) % f if keep else []
        rows = [{"birth": int(b), "claim": int(c), "cls": int(k),
                 "ref": int(r)} for b, c, k, r in flows[slots]]
        return rows, dropped

    def _bank(self) -> None:
        self._materialize()
        if self._snap is None:
            return
        hist, maxw, flows, rounds, _ = self._snap
        if self._hist_total is None:
            self._hist_total = hist.copy()
            self._maxw_total = maxw.copy()
        else:
            if hist.shape != self._hist_total.shape:
                raise ValueError(
                    f"span plane shape changed across runs: "
                    f"{hist.shape} vs {self._hist_total.shape}")
            self._hist_total += hist
            self._maxw_total = np.maximum(self._maxw_total, maxw)
        self._flows_total.extend(flows)
        self._rounds_total += rounds
        self._snap = None

    @property
    def hist(self) -> np.ndarray:
        """Cross-run (K, NB) bucket counts (banked totals + this run)."""
        self._materialize()
        parts = [p for p in (self._hist_total,
                             None if self._snap is None else self._snap[0])
                 if p is not None]
        if not parts:
            return np.zeros((self.classes, self.buckets), np.int64)
        out = parts[0].copy()
        for p in parts[1:]:
            out += p
        return out

    @property
    def max_wait(self) -> np.ndarray:
        """Cross-run (K,) per-class max sojourn high-water."""
        self._materialize()
        parts = [p for p in (self._maxw_total,
                             None if self._snap is None else self._snap[1])
                 if p is not None]
        if not parts:
            return np.zeros((self.classes,), np.int64)
        out = parts[0].copy()
        for p in parts[1:]:
            out = np.maximum(out, p)
        return out

    @property
    def flows(self) -> List[Dict[str, int]]:
        """Sampled flow records ``{birth, claim, cls, ref}`` (newest kept
        per run, banked runs first)."""
        self._materialize()
        out = list(self._flows_total)
        if self._snap is not None:
            out.extend(self._snap[2])
        return out

    @property
    def total(self) -> int:
        """Total sojourns observed (histogram mass)."""
        return int(self.hist.sum())

    def percentile(self, q: float, cls: Optional[int] = None
                   ) -> Optional[int]:
        """Sojourn quantile upper bound in rounds: the inclusive upper
        edge of the smallest bucket whose CDF reaches ``q`` (``None``
        when nothing was observed).  ``cls`` restricts to one class row;
        the default aggregates all rows."""
        h = self.hist
        row = h.sum(0) if cls is None else h[int(cls)]
        total = int(row.sum())
        if total == 0:
            return None
        cdf = np.cumsum(row)
        b = int(np.searchsorted(cdf, q * total, side="left"))
        b = min(b, len(row) - 1)
        return int(bucket_edges(len(row))[b])

    def summary(self) -> Dict[str, Any]:
        """JSON-ready snapshot: per-class histograms, max waits, and the
        aggregate p50/p95/p99 — the shape ``obs.export`` emits."""
        edges = bucket_edges(self.buckets).tolist()
        h = self.hist
        w = self.max_wait
        return {
            "classes": int(h.shape[0]),
            "buckets": int(h.shape[1]),
            "bucket_edges": edges,
            "hist": h.tolist(),
            "max_wait": w.tolist(),
            "total": int(h.sum()),
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }
