"""Observability of the port — the PyTorch twin of ``repro/obs``: trace
and span planes carried by the fused round engines, the host collectors
that drain them, the metrics registry and the trace exporters.

* ``trace`` — ``TracePlane`` (per-round records), ``Telemetry`` (its host
  collector) and the ``SyncPoint`` heartbeat;
* ``spans`` — ``SpanPlane`` (sojourn histograms per class) and ``Spans``;
* ``record`` — ``obs_record``: a round's trace row and span update in one
  call (one kernel launch on the card);
* ``metrics`` — ``MetricsRegistry`` (a copy of the reference's);
* ``export`` / ``analyze`` — JSONL and Chrome trace emitters, timelines
  and rank-error / sojourn analysis (copies of the reference's).
"""

from .analyze import (imbalance_timeline, key_inversions,
                      max_wait_highwater, measured_rank_error,
                      occupancy_timeline, rank_error_vs_envelope,
                      sojourn_percentiles, starvation_flags)
from .export import (read_jsonl, to_chrome_trace, write_chrome_trace,
                     write_jsonl)
from .metrics import Histogram, MetricsRegistry, metric_key
from .record import obs_record, obs_record_plain
from .spans import (SpanPlane, Spans, bucket_edges, bucket_of, span_init,
                    span_record, span_tick)
from .trace import (KEY_SENTINEL, RoundRecord, SyncPoint, Telemetry,
                    TracePlane, drain_plane, masked_min_max, trace_init,
                    trace_record)

__all__ = [
    "KEY_SENTINEL", "Histogram", "MetricsRegistry", "RoundRecord",
    "SpanPlane", "Spans", "SyncPoint", "Telemetry", "TracePlane",
    "bucket_edges", "bucket_of", "drain_plane", "imbalance_timeline",
    "key_inversions", "masked_min_max", "max_wait_highwater",
    "measured_rank_error", "metric_key", "obs_record", "obs_record_plain",
    "occupancy_timeline", "rank_error_vs_envelope", "read_jsonl",
    "sojourn_percentiles", "span_init", "span_record", "span_tick",
    "starvation_flags", "to_chrome_trace", "trace_init", "trace_record",
    "write_chrome_trace", "write_jsonl",
]
