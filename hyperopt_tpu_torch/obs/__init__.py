"""Observability of the PyTorch port: the metrics registry the serve
scheduler keeps its counters on, its Prometheus exposition, and the
disarmed flight recorder."""

from .expo import render_prometheus
from .flightrec import NULL_RECORDER, NullRecorder
from .registry import (
    Counter,
    CounterAttr,
    Gauge,
    GaugeAttr,
    Histogram,
    HistogramAttr,
    MetricsRegistry,
)

__all__ = [
    "Counter", "CounterAttr", "Gauge", "GaugeAttr", "Histogram", "HistogramAttr",
    "MetricsRegistry", "NULL_RECORDER", "NullRecorder", "render_prometheus",
]
