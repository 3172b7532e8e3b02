"""Observability records of the port: the host-sync heartbeat
(``SyncPoint``) and the metrics registry (a copy of
``repro/obs/metrics.py``)."""

from .metrics import Histogram, MetricsRegistry, metric_key
from .trace import SyncPoint

__all__ = ["Histogram", "MetricsRegistry", "SyncPoint", "metric_key"]
