"""The flight recorder of the PyTorch port: trace spans of the ask/tell
lifecycle.

The port's copy of :mod:`hyperopt_tpu.obs.flightrec`.  Spans are flat
dicts -- ``{"name", "ts", "dur_ms", **ids}`` -- kept in a bounded ring
(the last ``capacity`` spans, :meth:`FlightRecorder.tail`) and, when a
``path`` is given, appended to a durable export: one checksummed line
per span in the record format of :mod:`hyperopt_tpu_torch.utils.wal`,
written through the ``fs=`` seam, so a crash at
``obs_flight_export_mid_append`` leaves a torn line that
:func:`repair_flight_log` truncates as WAL recovery does.

The spans (the reference's names)::

    ask.submit      admitted into the scheduler queue (event)
    ask.queued      submit -> picked into a dispatch round
    serve.dispatch  one batched device step (n picked, slots)
    ask.delivered   submit -> ack (the latency the client sees)
    tell.wal_append the durability barrier of one tell
    tell.applied    host-buffer and staged-delta application
    tell            the whole tell
    driver.trial    one evaluation of ``fmin``'s driver

Recording only observes: no span touches an rstate stream, a seed draw
or device state, so a stream is bitwise the same with a recorder armed
(the invisibility invariant, ``tests/test_torch_flightrec.py``).
:data:`NULL_RECORDER` is the default everywhere.  Exports are flush-only
(a span is telemetry, not a tell); :meth:`FlightRecorder.flush` adds an
fsync for an orderly shutdown.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ..distributed.faults import REAL_FS
from ..utils.wal import _decode_line, _encode_record

__all__ = [
    "FlightRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "read_flight_log",
    "audit_flight_log",
    "repair_flight_log",
]

DEFAULT_CAPACITY = 4096

FLIGHT_MAGIC = "hyperopt-tpu-flight-1"


class NullRecorder:
    """The disarmed recorder: every call is a no-op.  Call sites keep
    one unconditional ``recorder.record(...)`` instead of branching."""

    enabled = False

    def record(self, name, t0=None, t1=None, **ids):
        pass

    def event(self, name, **ids):
        pass

    def tail(self, n=None):
        return []

    def flush(self):
        pass

    def close(self):
        pass


NULL_RECORDER = NullRecorder()


class FlightRecorder:
    """Bounded span ring + optional WAL-style durable export.

    ``capacity`` bounds the in-memory ring; ``cadence`` samples spans
    (1 = full cadence, k keeps every k-th; admission is per-span and
    deterministic in the record sequence, never in time); ``path``
    arms the durable export through ``fs``.
    """

    enabled = True

    def __init__(self, capacity=DEFAULT_CAPACITY, path=None, fs=REAL_FS,
                 cadence=1):
        self.capacity = int(capacity)
        self.path = None if path is None else str(path)
        self.fs = fs
        self.cadence = max(1, int(cadence))
        self._lock = threading.RLock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._f = None
        self._seq = 0
        self.recorded_total = 0
        self.sampled_out = 0
        self.exported_total = 0

    # -- recording ---------------------------------------------------------
    def record(self, name, t0=None, t1=None, **ids):
        """Record one span.  ``t0``/``t1`` are ``time.perf_counter()``
        instants (both None = a point event); ``ids`` are the
        study/tid/slot/shard/replica correlation fields."""
        with self._lock:
            self._seq += 1
            if self.cadence > 1 and (self._seq - 1) % self.cadence:
                self.sampled_out += 1
                return None
            span = {"name": str(name), "ts": time.time()}
            if t0 is not None and t1 is not None:
                span["dur_ms"] = 1000.0 * (t1 - t0)
            span.update(ids)
            self._ring.append(span)
            self.recorded_total += 1
            if self.path is not None:
                self._export(span)
            return span

    def event(self, name, **ids):
        return self.record(name, **ids)

    def tail(self, n=None):
        """The most recent ``n`` spans (all, when None) -- plain dict
        copies, safe to mutate/serialize."""
        with self._lock:
            spans = list(self._ring)
        if n is not None:
            spans = spans[-int(n):]
        return [dict(s) for s in spans]

    # -- durable export ----------------------------------------------------
    def _ensure_open(self):  # graftlint: disable=GL503 one-time header publish (or torn-tail truncation) when the log is first opened; every later append through here is flush-only
        if self._f is None:
            if not self.fs.exists(self.path):
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with self.fs.open(tmp, "w") as f:
                    f.write(_encode_record(
                        {"seq": -1, "magic": FLIGHT_MAGIC}
                    ))
                    self.fs.fsync(f)
                self.fs.rename(tmp, self.path)
            else:
                # the torn-tail rule at reopen: a restarted recorder
                # must append onto a valid prefix, never bury a crash's
                # torn line mid-file
                repair_flight_log(self.path, fs=self.fs)
            self._f = self.fs.open(self.path, "a")

    def _export(self, span):
        """Append one checksummed line (flush-only; lock held).  The
        crash point fires mid-record, leaving a torn line exactly like
        a machine crash would."""
        try:
            self._ensure_open()
            line = _encode_record(dict(span, seq=self._seq))
            half = max(1, len(line) // 2)
            self._f.write(line[:half])
            self.fs.crashpoint("obs_flight_export_mid_append")
            self._f.write(line[half:])
            self._f.flush()
            self.exported_total += 1
        except OSError:
            # telemetry must never take the serving path down: drop
            # the handle (a torn partial record is the torn-tail rule's
            # job) and keep recording in memory
            self._drop_handle()
        except BaseException:
            # simulated process death mid-append: release the handle
            # over the torn line (reopen truncates it) and keep dying
            self._drop_handle()
            raise

    def _drop_handle(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def flush(self):
        """Explicit durability barrier (shutdown/cadence points)."""
        with self._lock:
            f = self._f
        if f is not None:
            f.flush()
            self.fs.fsync(f)

    def close(self):
        with self._lock:
            self._drop_handle()


# ---------------------------------------------------------------------------
# reading, audit and repair
# ---------------------------------------------------------------------------


def _scan_flight_log(path, fs=REAL_FS):
    """(header, spans, good_bytes, torn_bytes, bad_lines) -- the WAL
    scan rule applied to a flight log, except mid-file corruption is
    REPORTED (a span log is telemetry: nothing is quarantined, the
    audit just counts what it had to skip)."""
    with fs.open(path, "rb") as f:
        raw = f.read()
    lines = raw.splitlines(keepends=True)
    header, spans, good, bad = None, [], 0, 0
    for i, bline in enumerate(lines):
        try:
            line = bline.decode("utf-8")
        except UnicodeDecodeError:
            line = ""
        body = _decode_line(line)
        if body is None:
            if i == len(lines) - 1:
                break  # torn tail
            bad += 1  # mid-file garbage: skipped, counted
            good += len(bline)
            continue
        if body.get("seq") == -1:
            if header is None:
                header = body
        else:
            spans.append(body)
        good += len(bline)
    return header, spans, good, len(raw) - good, bad


def read_flight_log(path, fs=REAL_FS, tail=None):
    """Valid spans of a flight log (torn tail ignored)."""
    _h, spans, _g, _t, _b = _scan_flight_log(path, fs=fs)
    return spans[-int(tail):] if tail is not None else spans


def audit_flight_log(path, fs=REAL_FS):
    """Audit a flight log: ``[(kind, path, detail), ...]`` issue rows."""
    issues = []
    if not fs.exists(path):
        issues.append(("obs_missing", path, "no flight log at path"))
        return issues
    header, spans, _good, torn, bad = _scan_flight_log(path, fs=fs)
    if header is None or header.get("magic") != FLIGHT_MAGIC:
        issues.append((
            "obs_bad_header", path,
            f"missing/foreign header {header!r}",
        ))
    if torn:
        issues.append((
            "obs_torn_tail", path,
            f"{torn} torn tail byte(s) after {len(spans)} valid span(s)",
        ))
    if bad:
        issues.append((
            "obs_corrupt_records", path,
            f"{bad} corrupt mid-file record(s) skipped",
        ))
    return issues


def repair_flight_log(path, fs=REAL_FS):
    """Truncate a torn tail atomically (tmp + fsync + rename); returns
    the bytes dropped.  Mid-file corruption stays in place -- the
    scanner already skips it, and telemetry is not worth quarantining."""
    _h, _spans, good, torn, _bad = _scan_flight_log(path, fs=fs)
    if not torn:
        return 0
    with fs.open(path, "rb") as f:
        raw = f.read()
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open(tmp, "wb") as f:
        f.write(raw[:good])
        fs.fsync(f)
    fs.rename(tmp, path)
    return torn
