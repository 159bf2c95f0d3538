"""Metrics: OpenCensus-style views with a Prometheus exporter.

The reference records measurements against registered views (tagged
aggregations) and exports them via a Prometheus exporter on its own HTTP
server (reference pkg/metrics/exporter.go:14-15, prometheus_exporter.go).
This package re-provides that shape: `Measure` + `View` + `record()` over a
process-global `Registry`, rendered in the Prometheus text exposition format
by `gatekeeper_tpu_torch.metrics.exporter`.
"""

from .views import (
    AGG_COUNT,
    AGG_DISTRIBUTION,
    AGG_LAST_VALUE,
    AGG_SUM,
    Measure,
    Registry,
    View,
    global_registry,
    record,
)
from .catalog import Reporters, register_catalog
from .exporter import MetricsExporter, render_prometheus

STATUS_ACTIVE = "active"
STATUS_ERROR = "error"
ALL_STATUSES = (STATUS_ACTIVE, STATUS_ERROR)

__all__ = [
    "AGG_COUNT",
    "AGG_DISTRIBUTION",
    "AGG_LAST_VALUE",
    "AGG_SUM",
    "ALL_STATUSES",
    "Measure",
    "MetricsExporter",
    "Registry",
    "Reporters",
    "STATUS_ACTIVE",
    "STATUS_ERROR",
    "View",
    "global_registry",
    "record",
    "register_catalog",
    "render_prometheus",
]
