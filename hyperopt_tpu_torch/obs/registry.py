"""The typed metrics registry of the PyTorch port: bounded by construction.

A copy of :mod:`hyperopt_tpu.obs.registry` (which imports no JAX; the
port keeps its own copy so it imports nothing of the JAX package).  The
serve scheduler's counters and timing windows live here behind their
historic attribute names (:class:`CounterAttr` /
:class:`HistogramAttr`), so ``SuggestService.counters`` reads the same
keys as the reference's.

Three metric types over one shared lock:

* :class:`Counter` -- a monotone total (``inc``);
* :class:`Gauge` -- a point-in-time value (``set``/``inc``/``dec``),
  ``None`` until first set;
* :class:`Histogram` -- FIXED buckets plus a bounded ring of raw
  observations (``maxlen``), so percentile reads keep working while
  exposition gets bucket counts.

Cardinality is capped at registration: a labeled metric declares its
label NAMES up front and its label-value sets are bounded at
``label_cap`` children -- further values share the ``_overflow`` series.
Reads are snapshot-consistent: :meth:`MetricsRegistry.collect` takes the
registry lock once and returns plain dicts.
"""

from __future__ import annotations

import collections
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "CounterAttr",
    "GaugeAttr",
    "HistogramAttr",
    "DEFAULT_WINDOW",
    "DEFAULT_LABEL_CAP",
    "LATENCY_BUCKETS_S",
    "LATENCY_BUCKETS_MS",
    "RATIO_BUCKETS",
]

#: ring-buffer length for histogram raw-value windows: plenty for any
#: bench window, bounded for a long-running service
DEFAULT_WINDOW = 65536

#: label-value children a labeled metric may materialize before new
#: values collapse into the shared overflow series
DEFAULT_LABEL_CAP = 64

#: the overflow label value unbounded-cardinality callers collapse into
OVERFLOW_LABEL = "_overflow"

LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, float("inf"),
)
LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0, float("inf"),
)
RATIO_BUCKETS = (
    0.1, 0.25, 0.5, 0.75, 0.9, 1.0, float("inf"),
)


class Counter:
    """A monotone total.  ``set_total`` exists only for the back-compat
    descriptors (``self.x += 1`` round-trips through get+set)."""

    kind = "counter"

    def __init__(self, name, help="", lock=None, labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = lock if lock is not None else threading.RLock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def set_total(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def collect(self):
        with self._lock:
            return {
                "name": self.name, "type": self.kind, "help": self.help,
                "labels": dict(self.labels), "value": self._value,
            }

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.RLock()


class Gauge:
    """A point-in-time value; ``None`` until first set."""

    kind = "gauge"

    def __init__(self, name, help="", lock=None, labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = lock if lock is not None else threading.RLock()
        self._value = None

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, n=1):
        with self._lock:
            self._value = (self._value or 0) + n

    def dec(self, n=1):
        self.inc(-n)

    def set_duration_ms(self, t0):
        """Set to the milliseconds elapsed since ``t0`` (a
        ``time.perf_counter()`` instant) -- the registry-side timing
        helper, so callers keep no inline timing deltas."""
        self.set(1000.0 * (time.perf_counter() - t0))

    @property
    def value(self):
        with self._lock:
            return self._value

    def collect(self):
        with self._lock:
            return {
                "name": self.name, "type": self.kind, "help": self.help,
                "labels": dict(self.labels), "value": self._value,
            }

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.RLock()


class _Ring(collections.deque):
    """The histogram's bounded raw-value window: still a deque (the
    read paths slice/sort/len it), but ``append`` also
    feeds the fixed buckets so direct appends -- the back-compat write
    path -- never desynchronize the exposition."""

    def __init__(self, hist, iterable=(), maxlen=DEFAULT_WINDOW):
        super().__init__(iterable, maxlen)
        self._hist = hist

    def append(self, v):
        collections.deque.append(self, v)
        self._hist._bucket_add(v)

    def __reduce__(self):  # pickled via the owning Histogram only
        return (list, (list(self),))


class Histogram:
    """Fixed-bucket counts + a bounded ring of raw observations.

    ``buckets`` are upper bounds (the last is ``+inf``); ``observe``
    (or a direct ``ring.append`` from a back-compat attribute) bumps
    exactly one cumulative-count cell, the running sum, and the ring.
    Bounded by construction: ``len(buckets)`` cells + ``window`` ring
    slots, forever.
    """

    kind = "histogram"

    def __init__(self, name, help="", buckets=LATENCY_BUCKETS_S,
                 window=DEFAULT_WINDOW, lock=None, labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        buckets = tuple(float(b) for b in buckets)
        if not buckets or buckets[-1] != float("inf"):
            buckets = buckets + (float("inf"),)
        self.buckets = buckets
        self.window = int(window)
        self._lock = lock if lock is not None else threading.RLock()
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        self.ring = _Ring(self, maxlen=self.window)

    def _bucket_add(self, v):
        with self._lock:
            v = float(v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            self._sum += v
            self._count += 1

    def observe(self, v):
        self.ring.append(v)

    def observe_since(self, t0):
        """Observe the seconds elapsed since ``t0`` (see
        :meth:`Gauge.set_duration_ms`)."""
        self.observe(time.perf_counter() - t0)

    @property
    def count(self):
        with self._lock:
            return self._count

    def collect(self):
        with self._lock:
            return {
                "name": self.name, "type": self.kind, "help": self.help,
                "labels": dict(self.labels),
                "buckets": [
                    {"le": b, "count": c}
                    for b, c in zip(self.buckets, self._counts)
                ],
                "sum": self._sum,
                "count": self._count,
            }

    def __getstate__(self):
        d = self.__dict__.copy()
        d["ring"] = list(self.ring)
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):
        ring = d.pop("ring", [])
        self.__dict__.update(d)
        self._lock = threading.RLock()
        self.ring = _Ring(self, ring, maxlen=self.window)


class _LabeledMetric:
    """Cardinality-bounded family of one metric type: children keyed by
    label-value tuples, capped at ``label_cap`` -- past the cap every
    new combination shares the ``_overflow`` child."""

    def __init__(self, factory, name, help, label_names, label_cap,
                 lock, **kw):
        self.name = name
        self.kind = factory.kind
        self.help = help
        self.label_names = tuple(label_names)
        self.label_cap = int(label_cap)
        self._factory = factory
        self._kw = kw
        self._lock = lock
        self._children = {}

    def labels(self, **values):
        key = tuple(str(values.get(n, "")) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.label_cap:
                    key = (OVERFLOW_LABEL,) * len(self.label_names)
                    child = self._children.get(key)
                if child is None:
                    child = self._factory(
                        self.name, help=self.help, lock=self._lock,
                        labels=dict(zip(self.label_names, key)),
                        **self._kw,
                    )
                    self._children[key] = child
            return child

    def collect(self):
        with self._lock:
            children = list(self._children.values())
        return [c.collect() for c in children]

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):  # graftlint: disable=GL501 unpickle-time: the object is not yet visible to any other thread, and the lock it re-shares is created on this line
        self.__dict__.update(d)
        self._lock = threading.RLock()
        for c in self._children.values():
            c._lock = self._lock


class MetricsRegistry:
    """One component's metrics, under one lock.

    ``const_labels`` stamp every collected series (the fleet sets
    ``replica=<owner>`` so a router-side merge can tell replicas
    apart).  Metrics are get-or-create by name with a type check --
    two callers registering ``serve_dispatch_total`` as different
    types is a bug, not a silent shadow.
    """

    def __init__(self, namespace="", const_labels=None,
                 label_cap=DEFAULT_LABEL_CAP):
        self.namespace = str(namespace)
        self.const_labels = dict(const_labels or {})
        self.label_cap = int(label_cap)
        self._lock = threading.RLock()
        self._metrics = {}

    def _get_or_create(self, factory, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if labels:
                    m = _LabeledMetric(
                        factory, name, help, labels, self.label_cap,
                        self._lock, **kw,
                    )
                else:
                    m = factory(name, help=help, lock=self._lock, **kw)
                self._metrics[name] = m
            elif m.kind != factory.kind:
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {factory.kind}"
                )
            return m

    def counter(self, name, help="", labels=()):
        return self._get_or_create(Counter, name, help, tuple(labels))

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(Gauge, name, help, tuple(labels))

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS_S,
                  window=DEFAULT_WINDOW, labels=()):
        return self._get_or_create(
            Histogram, name, help, tuple(labels),
            buckets=buckets, window=window,
        )

    def collect(self):
        """Snapshot-consistent read: one lock acquisition, plain
        dicts out (``const_labels`` merged into every series)."""
        with self._lock:
            metrics = list(self._metrics.values())
            const = dict(self.const_labels)
        out = []
        for m in metrics:
            got = m.collect()
            for row in got if isinstance(got, list) else [got]:
                row["labels"] = {**const, **row["labels"]}
                out.append(row)
        return out

    # registries ride along inside pickled ObsBuffers (checkpoint
    # bundles, attachments): locks are not picklable, values are
    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_lock", None)
        return d

    def __setstate__(self, d):  # graftlint: disable=GL501 unpickle-time: the registry is not yet visible to any other thread, and the lock it re-shares is created on this line
        self.__dict__.update(d)
        self._lock = threading.RLock()
        for m in self._metrics.values():
            if isinstance(m, _LabeledMetric):
                m._lock = self._lock
                for c in m._children.values():
                    c._lock = self._lock
            else:
                m._lock = self._lock


def _instance_registry(obj, attr):
    reg = getattr(obj, attr, None)
    if reg is None:
        # lazily heal objects unpickled without a registry
        reg = MetricsRegistry()
        setattr(obj, attr, reg)
    return reg


class CounterAttr:
    """Descriptor exposing a registry :class:`Counter` behind a plain
    numeric attribute name: ``self.dispatch_count += 1`` keeps working
    (get + set round-trip) while the storage, exposition, and bounds
    live on the instance's :class:`MetricsRegistry` (found at
    ``registry_attr``, created lazily for unpickled old objects)."""

    def __init__(self, name, help="", registry_attr="metrics"):
        self.name = name
        self.help = help
        self.registry_attr = registry_attr

    def _metric(self, obj):
        return _instance_registry(obj, self.registry_attr).counter(
            self.name, help=self.help
        )

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._metric(obj).value

    def __set__(self, obj, value):
        self._metric(obj).set_total(value)


class GaugeAttr:
    """:class:`CounterAttr`'s gauge twin (``None`` until first set)."""

    def __init__(self, name, help="", registry_attr="metrics"):
        self.name = name
        self.help = help
        self.registry_attr = registry_attr

    def _metric(self, obj):
        return _instance_registry(obj, self.registry_attr).gauge(
            self.name, help=self.help
        )

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self._metric(obj).value

    def __set__(self, obj, value):
        self._metric(obj).set(value)


class HistogramAttr:
    """Descriptor exposing a registry :class:`Histogram`'s bounded
    ring behind the deque attribute name the code already appends to
    and the bench already slices (``scheduler.ask_latencies``)."""

    def __init__(self, name, help="", buckets=LATENCY_BUCKETS_S,
                 window=DEFAULT_WINDOW, registry_attr="metrics"):
        self.name = name
        self.help = help
        self.buckets = buckets
        self.window = window
        self.registry_attr = registry_attr

    def histogram(self, obj):
        return _instance_registry(obj, self.registry_attr).histogram(
            self.name, help=self.help, buckets=self.buckets,
            window=self.window,
        )

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self.histogram(obj).ring
