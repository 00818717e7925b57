"""Deterministic fault injection for the PyTorch port's serve stack and
compiled loop.

A subset of :mod:`hyperopt_tpu.distributed.faults`: the filesystem seam
(:class:`RealFS`, the ``os`` primitives the write-ahead log and the
durable savers use, and crash points that do nothing), the simulated
process death (:class:`SimulatedCrash`), the device-fault schedule the
scheduler's guard is tested with (:class:`DeviceFaultPlan`: NaN outputs,
dispatch hangs, transient and fatal raises), and a :class:`FaultPlan`
that carries it and arms the driver, serve, compiled-loop, checkpoint
and flight-recorder crash points.  Injected file errors and partial
writes, and network faults, wait for the transport slice (``ROADMAP.md``
Queue A, item 12c).
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time

from ..exceptions import TransientBackendError

__all__ = [
    "ALL_CRASH_POINTS", "CHECKPOINT_CRASH_POINTS", "DEVICE_LOOP_CRASH_POINTS",
    "DRIVER_CRASH_POINTS", "OBS_CRASH_POINTS", "SERVE_CRASH_POINTS", "SHA_CRASH_POINTS", "DeviceFaultPlan", "FaultPlan", "FaultyFS", "REAL_FS",
    "RealFS", "SimulatedCrash",
]

#: crash points of the sequential driver's recovery protocol (``fmin``'s
#: write-ahead tell log and checkpoint bundles, ``utils/wal.py`` and
#: :class:`~hyperopt_tpu_torch.utils.checkpoint.DriverRecovery`):
#:     before_wal_append            evaluated or asked, record not yet durable
#:     after_wal_append_before_tell record durable, tell not yet applied
#:     after_tell_before_ask_ahead  tell applied, the pre-dispatch not yet made
#:     after_ckpt_tmp_before_rename bundle tmp fsynced, not yet published
#:     after_ckpt_publish_before_wal_reset  bundle live, WAL not compacted
DRIVER_CRASH_POINTS = (
    "before_wal_append",
    "after_wal_append_before_tell",
    "after_tell_before_ask_ahead",
    "after_ckpt_tmp_before_rename",
    "after_ckpt_publish_before_wal_reset",
)

#: crash points of the serve scheduler:
#:     serve_after_wal_before_dispatch  tell durable in the study WAL, batch
#:                                      not yet dispatched
#:     serve_mid_batch                  batch assembled, device step not yet run
#:     serve_after_dispatch_before_ack  device state committed, clients not
#:                                      yet acked, served records not logged
#:     serve_group_commit_after_flush_before_barrier
#:                                      the round's tells are flushed (a
#:                                      process death loses none) but the
#:                                      round's fsync barrier has not run
SERVE_CRASH_POINTS = (
    "serve_after_wal_before_dispatch",
    "serve_mid_batch",
    "serve_after_dispatch_before_ack",
    "serve_group_commit_after_flush_before_barrier",
)

#: crash points of the chunked compiled loop
#: (:func:`hyperopt_tpu_torch.device_loop.compile_fmin` with ``chunk_size``):
#:     device_loop_after_chunk_before_ckpt       chunk replayed, carry not
#:                                                yet checkpointed
#:     device_loop_after_ckpt_before_next_chunk  bundle published, next
#:                                                chunk not yet replayed
DEVICE_LOOP_CRASH_POINTS = (
    "device_loop_after_chunk_before_ckpt",
    "device_loop_after_ckpt_before_next_chunk",
)

#: crash points of the rung chain of
#: (:func:`hyperopt_tpu_torch.hyperband.compile_sha` with ``checkpoint=``):
#:     sha_after_rung_before_snapshot       rung trained and ranked, its
#:                                          snapshot not yet written
#:     sha_after_snapshot_before_next_rung  snapshot published, next rung
#:                                          not yet run
SHA_CRASH_POINTS = (
    "sha_after_rung_before_snapshot",
    "sha_after_snapshot_before_next_rung",
)

#: the durable saver's torn-publish window
#: (:func:`hyperopt_tpu_torch.utils.checkpoint.durable_write`):
#:     after_ckpt_tmp_before_rename  bundle tmp fsynced, not yet published
CHECKPOINT_CRASH_POINTS = ("after_ckpt_tmp_before_rename",)

#: the flight recorder's export (:mod:`hyperopt_tpu_torch.obs.flightrec`):
#:     obs_flight_export_mid_append  half a span line written, a torn tail
OBS_CRASH_POINTS = ("obs_flight_export_mid_append",)

# the durable saver's window is also the driver's fourth point: listed once
ALL_CRASH_POINTS = tuple(dict.fromkeys(
    DRIVER_CRASH_POINTS + SERVE_CRASH_POINTS + DEVICE_LOOP_CRASH_POINTS + SHA_CRASH_POINTS
    + CHECKPOINT_CRASH_POINTS + OBS_CRASH_POINTS))


class SimulatedCrash(BaseException):
    """Simulated process death at a named crash point.

    A ``BaseException`` deliberately: error capture (``except
    Exception``) must not swallow a simulated crash -- a dead process
    publishes nothing.
    """

    def __init__(self, point):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class RealFS:
    """The default seam: ``os`` passthrough, no-op crash points."""

    def open(self, path, mode="r"):
        return open(path, mode)

    def rename(self, src, dst):
        os.rename(src, dst)

    def exists(self, path):
        return os.path.exists(path)

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def fsync(self, f):
        f.flush()
        os.fsync(f.fileno())

    def crashpoint(self, name):
        pass


REAL_FS = RealFS()


class DeviceFaultPlan:
    """A seeded, deterministic schedule of DEVICE faults for the serve
    dispatch path, injected through the scheduler's ``fs=`` seam
    (``FaultPlan(device=DeviceFaultPlan(...)).fs()``), never by
    monkeypatching.

    Three fault classes, all keyed to the scheduler's own dispatch
    ordinal so a same-seed replay injects identically:

    * **NaN corruption** (``nan_study`` + ``nan_at`` / ``nan_count``):
      from the ``nan_at``-th dispatch on, the named tenant's batched
      step output columns are overwritten with NaN.  ``nan_count=None`` poisons every
      dispatch (a deterministically bad tenant, driving K-trip
      eviction); ``nan_count=n`` poisons only the first ``n`` hits (a
      transient device fault the re-materialization path absorbs).
      The scheduler's finite check must catch it without disturbing
      sibling slots.
    * **Hang** (``hang_at`` + ``hang_s``): the ``hang_at``-th dispatch
      sleeps ``hang_s`` seconds inside the dispatch closure -- armed
      past the scheduler's watchdog deadline it simulates a wedged
      device; one-shot.
    * **Raises** (``raise_rate`` + ``burst``): each dispatch raises
      :class:`~hyperopt_tpu_torch.exceptions.TransientBackendError` with the
      given probability, burst-bounded to ``burst`` CONSECUTIVE raises
      so the watchdog's retry-once always converges at ``burst=1``.
      ``fatal_at`` instead raises a plain ``RuntimeError`` at that
      ordinal -- the deterministic-program-bug case ``is_transient``
      must classify as NOT worth retrying.
    """

    def __init__(self, seed=0, nan_study=None, nan_at=1, nan_count=None,
                 hang_at=None, hang_s=0.2, raise_rate=0.0, burst=1,
                 fatal_at=None):
        self.seed = int(seed)
        self.nan_study = nan_study
        self.nan_at = int(nan_at)
        self.nan_count = None if nan_count is None else int(nan_count)
        self.hang_at = None if hang_at is None else int(hang_at)
        self.hang_s = min(float(hang_s), 0.5)  # chaos-suite time budget
        self.raise_rate = float(raise_rate)
        self.burst = int(burst)
        self.fatal_at = None if fatal_at is None else int(fatal_at)
        self._rng = random.Random(self.seed)
        self._lock = threading.RLock()
        self._ordinal = 0
        self._raise_streak = 0
        self._nan_hits = 0
        self.stats = collections.Counter()
        self.log = []

    def on_dispatch(self):
        """Called inside the dispatch closure, before the device
        program runs: may sleep (hang) or raise (injected dispatch
        fault).  One RNG draw per call when ``raise_rate`` is set, so
        the schedule is a pure function of the dispatch sequence."""
        with self._lock:
            self._ordinal += 1
            ordinal = self._ordinal
            hang = self.hang_at is not None and ordinal == self.hang_at
            fatal = self.fatal_at is not None and ordinal == self.fatal_at
            raise_now = False
            if self.raise_rate:
                roll = self._rng.random() < self.raise_rate
                if roll and self._raise_streak < self.burst:
                    self._raise_streak += 1
                    raise_now = True
                else:
                    self._raise_streak = 0
            if hang:
                self.stats["device:hang"] += 1
                self.log.append(("dispatch", ordinal, "hang"))
            elif fatal:
                self.stats["device:fatal"] += 1
                self.log.append(("dispatch", ordinal, "fatal"))
            elif raise_now:
                self.stats["device:raise"] += 1
                self.log.append(("dispatch", ordinal, "raise"))
            else:
                self.log.append(("dispatch", ordinal, "ok"))
        if hang:
            time.sleep(self.hang_s)
        if fatal:
            raise RuntimeError(
                f"injected deterministic program bug at dispatch {ordinal}"
            )
        if raise_now:
            raise TransientBackendError(
                f"injected transient device fault at dispatch {ordinal}"
            )

    def corrupt_outputs(self, new_v, slot_of):
        """NaN-poison the named tenant's suggestion columns in the
        fetched batched-step output (``new_v`` is the host ``[S, D,
        batch]`` array, ``slot_of`` maps study name -> slot index).
        Mutates in place; sibling slots are never touched."""
        if self.nan_study is None or self.nan_study not in slot_of:
            return
        with self._lock:
            if self._ordinal < self.nan_at:
                return
            if self.nan_count is not None and self._nan_hits >= self.nan_count:
                return
            self._nan_hits += 1
            self.stats["device:nan"] += 1
            self.log.append(("corrupt", self._ordinal, self.nan_study))
        new_v[slot_of[self.nan_study]] = float("nan")


class FaultPlan:
    """A seeded, deterministic schedule of faults: one-shot crashes at
    named crash points (:meth:`arm`, :data:`ALL_CRASH_POINTS`), and an optional
    :class:`DeviceFaultPlan` riding along (``device=``), which the serve
    scheduler finds through its ``fs=`` seam (``fs.plan.device``)."""

    def __init__(self, seed=0, device=None):
        self.seed = seed
        self.device = device
        self._lock = threading.RLock()
        self._crash = {}
        self.log = []
        self.stats = collections.Counter()

    def fs(self):
        """An injectable filesystem bound to this plan."""
        return FaultyFS(self)

    def arm(self, point, at=1):
        """Arm a one-shot crash at the ``at``-th hit of ``point``."""
        if point not in ALL_CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}")
        with self._lock:
            self._crash[point] = int(at)
        return self

    def fire_crashpoint(self, name):
        with self._lock:
            if name not in self._crash:
                return
            self._crash[name] -= 1
            if self._crash[name] > 0:
                return
            del self._crash[name]
            self.log.append(("crash", name, "fired"))
            self.stats[f"crash:{name}"] += 1
        raise SimulatedCrash(name)


class FaultyFS(RealFS):
    """The injectable seam: the ``os`` primitives of :class:`RealFS` and
    crash points that consult the plan (and raise :class:`SimulatedCrash`
    when armed)."""

    def __init__(self, plan):
        self.plan = plan

    def crashpoint(self, name):
        self.plan.fire_crashpoint(name)
