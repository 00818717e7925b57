"""Observability of the PyTorch port: the metrics registry the serve
scheduler keeps its counters on, its Prometheus exposition, the flight
recorder of trace spans with its durable export, the device-side metric
rows (:mod:`.device`: the serve twin, the compiled loop's registry
adapter) and the ``hyperopt-tpu-torch-scope`` console (:mod:`.cli`)."""

from .expo import render_prometheus
from .flightrec import (
    NULL_RECORDER,
    FlightRecorder,
    NullRecorder,
    audit_flight_log,
    read_flight_log,
    repair_flight_log,
)
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
    "Counter", "CounterAttr", "FlightRecorder", "Gauge", "GaugeAttr", "Histogram",
    "HistogramAttr", "MetricsRegistry", "NULL_RECORDER", "NullRecorder", "audit_flight_log",
    "read_flight_log", "render_prometheus", "repair_flight_log",
]
