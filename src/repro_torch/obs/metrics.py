"""Unified host metrics registry (DESIGN.md § 7.2) — a copy of
``repro/obs/metrics.py``, which the port does not import.

Before this module every subsystem kept its own ad-hoc stats surface:
``_FusedEngine.stats`` dicts, ``TaskRuntime.run()``'s free-form metrics
dict, ``FabricMetrics.per_shard_deq`` keyed by ``(lane, shard)`` tuples,
``ServingEngine.metrics`` + ``admission_log`` — and benchmarks
string-matched whichever shape they happened to know.  The registry puts
them behind one schema:

* **counter** — monotically accumulating int (``host_syncs``, steals,
  admissions).
* **gauge** — last-written value (occupancy, load imbalance).
* **histogram** — stream summary (count/sum/min/max + fixed quantiles via
  a bounded reservoir) for latency-like observations (wait times,
  sync-to-sync round deltas).

Keys are flat strings built by :func:`metric_key`:
``<subsystem>.<name>[label=value,...]`` with labels sorted — e.g.
``fabric.deq[lane=0,shard=1]`` or ``serving.admitted`` — so per-shard
snapshots have *stable* names benchmarks and the trace exporter can rely
on.  ``snapshot()`` returns plain ``{key: number-or-dict}`` suitable for
JSONL export.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

__all__ = ["Histogram", "MetricsRegistry", "metric_key"]


def metric_key(subsystem: str, name: str, **labels) -> str:
    """Canonical flat metric key: ``subsystem.name[k=v,...]`` (labels
    sorted; no-label keys omit the brackets)."""
    base = f"{subsystem}.{name}" if subsystem else name
    if not labels:
        return base
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}[{inner}]"


class Histogram:
    """Bounded-reservoir stream summary: exact count/sum/min/max, and
    quantiles over the most recent ``max_samples`` observations."""

    def __init__(self, max_samples: int = 4096) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []
        self._max_samples = int(max_samples)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._samples) >= self._max_samples:
            self._samples.pop(0)
        self._samples.append(v)

    def quantile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        xs = sorted(self._samples)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def to_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """One process-local registry instance per engine/runtime/benchmark.

    Kinds are enforced per key: re-using ``fabric.deq[shard=0]`` as both a
    counter and a gauge raises — catching exactly the free-form drift this
    registry exists to remove.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Union[int, float]] = {}
        self._gauges: Dict[str, Union[int, float]] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- writes ---------------------------------------------------------------

    def counter(self, key: str, delta: Union[int, float] = 1) -> None:
        self._check_kind(key, self._counters)
        self._counters[key] = self._counters.get(key, 0) + delta

    def gauge(self, key: str, value: Union[int, float]) -> None:
        self._check_kind(key, self._gauges)
        self._gauges[key] = value

    def observe(self, key: str, value: Union[int, float]) -> None:
        self._check_kind(key, self._histograms)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram()
        h.observe(value)

    def _check_kind(self, key: str, own: Mapping[str, Any]) -> None:
        for kind, table in (("counter", self._counters),
                            ("gauge", self._gauges),
                            ("histogram", self._histograms)):
            if table is not own and key in table:
                raise ValueError(
                    f"metric key {key!r} already registered as a {kind}")

    # -- reads ----------------------------------------------------------------

    def get(self, key: str, default=None):
        if key in self._counters:
            return self._counters[key]
        if key in self._gauges:
            return self._gauges[key]
        if key in self._histograms:
            return self._histograms[key]
        return default

    def keys(self) -> List[str]:
        return sorted(set(self._counters) | set(self._gauges)
                      | set(self._histograms))

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{key: value}`` view (histograms as summary dicts) —
        JSON-serialisable, the shape ``obs.export`` emits."""
        out: Dict[str, Any] = {}
        out.update(self._counters)
        out.update(self._gauges)
        for k, h in self._histograms.items():
            out[k] = h.to_dict()
        return dict(sorted(out.items()))

    def filtered(self, prefix: str) -> Dict[str, Any]:
        """Snapshot restricted to keys under ``prefix`` (subsystem view)."""
        return {k: v for k, v in self.snapshot().items()
                if k == prefix or k.startswith(prefix + ".")
                or k.startswith(prefix + "[")}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (counters add, gauges overwrite,
        histogram samples re-observe) — lets per-engine registries roll up
        into one run-level view before export."""
        for k, v in other._counters.items():
            self.counter(k, v)
        for k, v in other._gauges.items():
            self.gauge(k, v)
        for k, h in other._histograms.items():
            for s in h._samples:
                self.observe(k, s)
