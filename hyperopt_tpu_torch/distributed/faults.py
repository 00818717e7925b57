"""Deterministic fault injection for the PyTorch port's serve stack and
compiled loop.

The port's copy of :mod:`hyperopt_tpu.distributed.faults`, for the seams
the port has: the filesystem seam (:class:`RealFS`, the ``os`` primitives
the write-ahead log, the durable savers and the file job queue use, crash
points that do nothing), the simulated process death (:class:`SimulatedCrash`), the
device-fault schedule the scheduler's guard is tested with
(:class:`DeviceFaultPlan`: NaN outputs, dispatch hangs, transient and
fatal raises), and :class:`FaultPlan`, which arms the job-queue, driver, serve,
compiled-loop, checkpoint, fleet, autoscaler, flight-recorder and network
crash points and injects seeded file faults through :meth:`FaultPlan.fs`: transient errno
faults (``ESTALE``/``EIO`` at ``rate``, burst-bounded so retries always
converge), bounded latency and partial writes, decision for decision the
reference's for one seed and one sequence of operations.  Network faults
are :mod:`.netfaults`'s, re-exported here.
"""

from __future__ import annotations

import collections
import errno
import os
import random
import threading
import time
import zlib

from ..exceptions import TransientBackendError

__all__ = [
    "ALL_CRASH_POINTS", "CHECKPOINT_CRASH_POINTS", "CRASH_POINTS", "DEFAULT_ERRORS", "DEVICE_LOOP_CRASH_POINTS",
    "DRIVER_CRASH_POINTS", "FLEET_CRASH_POINTS", "NET_CRASH_POINTS", "OBS_CRASH_POINTS",
    "PILOT_CRASH_POINTS", "SERVE_CRASH_POINTS", "SHA_CRASH_POINTS", "DeviceFaultPlan", "FaultPlan", "FaultyFS", "FaultyWire", "NetFaultPlan",
    "REAL_FS", "RealFS", "SimulatedCrash",
]

#: crash points of the file job queue (:mod:`.filequeue`, :mod:`.worker`):
#:     after_publish_tmp_before_rename      job tmp fsynced, not yet in new/
#:     after_claim_utime_before_rename      claim's mtime refreshed, the CAS
#:                                          rename not yet made
#:     after_claim_rename_before_write      job in running/, the claim doc
#:                                          not yet written
#:     after_done_tmp_before_rename         result tmp fsynced, not yet in done/
#:     after_done_rename_before_unlink      result published, claim not released
#:     after_unreserve_utime_before_rename  a given-back job's mtime refreshed,
#:                                          not yet back in new/
#:     after_reap_utime_before_rename       a stale claim's mtime refreshed,
#:                                          not yet back in new/
#:     after_attach_fsync_before_rename     attachment tmp fsynced, not published
#:     before_complete                      evaluated, nothing published
CRASH_POINTS = (
    "after_publish_tmp_before_rename",
    "after_claim_utime_before_rename",
    "after_claim_rename_before_write",
    "after_done_tmp_before_rename",
    "after_done_rename_before_unlink",
    "after_unreserve_utime_before_rename",
    "after_reap_utime_before_rename",
    "after_attach_fsync_before_rename",
    "before_complete",
)

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

#: crash points of the serve fleet (:mod:`hyperopt_tpu_torch.serve.fleet`
#: and :mod:`~hyperopt_tpu_torch.serve.router`; a replica's own death is
#: ``serve_mid_batch`` armed on that replica's plan):
#:     fleet_router_after_forward_before_ack  the replica ran the op, the
#:                                            router died before the ack
#:                                            (retried idempotently)
#:     fleet_migrate_after_snapshot_before_handoff  snapshot published, the
#:                                            source still owns the study
#:     fleet_migrate_after_handoff_before_restore   the source released its
#:                                            claim, the target has not
#:                                            restored (lazy adoption heals)
#:     fleet_claim_tmp_before_rename          claim tmp fsynced, the rename
#:                                            never landed
FLEET_CRASH_POINTS = (
    "fleet_router_after_forward_before_ack",
    "fleet_migrate_after_snapshot_before_handoff",
    "fleet_migrate_after_handoff_before_restore",
    "fleet_claim_tmp_before_rename",
)

#: crash points of the autoscaler (:mod:`hyperopt_tpu_torch.serve.pilot`):
#:     pilot_after_decision_before_actuate  the decision is recorded, no fleet
#:                                          primitive has run
#:     pilot_mid_scale_out                  on the fleet's plan inside
#:                                          ``add_replica``: the ring holds
#:                                          the new replica, only the first
#:                                          remapped study moved
PILOT_CRASH_POINTS = (
    "pilot_after_decision_before_actuate",
    "pilot_mid_scale_out",
)

from .netfaults import (  # noqa: E402 -- re-exported beside FaultPlan
    NET_CRASH_POINTS,
    FaultyWire,
    NetFaultPlan,
)

# the durable saver's window is also the driver's fourth point: listed once
ALL_CRASH_POINTS = tuple(dict.fromkeys(
    CRASH_POINTS + DRIVER_CRASH_POINTS + SERVE_CRASH_POINTS + DEVICE_LOOP_CRASH_POINTS + SHA_CRASH_POINTS
    + CHECKPOINT_CRASH_POINTS + FLEET_CRASH_POINTS + OBS_CRASH_POINTS + PILOT_CRASH_POINTS
    + NET_CRASH_POINTS))

#: the transient errno mix a flaky mount produces (``ENOENT`` may be added
#: to a plan's ``errors`` to simulate a visibility lag)
DEFAULT_ERRORS = (errno.ESTALE, errno.EIO)


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

    def utime(self, path, times=None):
        os.utime(path, times)

    def stat(self, path):
        return os.stat(path)

    def getmtime(self, path):
        return os.path.getmtime(path)

    def listdir(self, path):
        return os.listdir(path)

    def unlink(self, path):
        os.unlink(path)

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
    """A seeded, deterministic schedule of faults.

    One plan is one RNG stream: for a fixed seed and a fixed sequence of
    filesystem operations the injected faults are the same run to run,
    and ``log`` records every decision.  Give each concurrent actor its
    own :meth:`split` plan, so decisions depend only on its own
    operations.

    ``rate`` is the probability of a transient error per gated call,
    drawn from ``errors`` (``OSError(errno, ...)`` picks the matching
    subclass); ``latency`` the most injected delay per call (capped at
    50 ms); ``partial_rate`` the probability that a file opened for
    writing fails midway with ``EIO`` after a prefix (the torn write);
    ``burst`` the most consecutive injected failures per (op, file) key,
    so ``burst + 1`` attempts always converge (None: unbounded); ``ops``
    restricts errors to those op names.  One-shot crashes arm at named
    crash points (:meth:`arm`, :data:`ALL_CRASH_POINTS`), and an optional
    :class:`DeviceFaultPlan` rides along (``device=``): the serve
    scheduler finds it through its ``fs=`` seam (``fs.plan.device``).
    """

    def __init__(self, seed=0, rate=0.0, errors=DEFAULT_ERRORS, latency=0.0,
                 partial_rate=0.0, burst=2, ops=None, device=None):
        self.seed = seed
        self.rate = float(rate)
        self.errors = tuple(errors)
        self.latency = min(float(latency), 0.05)
        self.partial_rate = float(partial_rate)
        self.burst = burst
        self.ops = None if ops is None else frozenset(ops)
        self.device = device
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._consecutive = {}
        self._crash = {}
        self.log = []
        self.stats = collections.Counter()

    def split(self, name):
        """A derived plan with the same fault profile and a stably derived
        seed (crc32, not ``hash()``).  Crash points and the device plan are
        not inherited."""
        child_seed = zlib.crc32(f"{self.seed}/{name}".encode())
        return FaultPlan(seed=child_seed, rate=self.rate, errors=self.errors,
                         latency=self.latency, partial_rate=self.partial_rate,
                         burst=self.burst, ops=self.ops)

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

    # -- decisions (called by FaultyFS) ---------------------------------------
    def _decide_error(self, op, key):
        with self._lock:
            if not self.rate or (self.ops is not None and op not in self.ops):
                self.log.append((op, key, "ok"))
                return None
            k = (op, key)
            streak = self._consecutive.get(k, 0)
            allowed = self.burst is None or streak < self.burst
            if allowed and self._rng.random() < self.rate:
                self._consecutive[k] = streak + 1
                err = self._rng.choice(self.errors)
                self.log.append((op, key, f"errno={err}"))
                self.stats[f"error:{op}"] += 1
                return err
            self._consecutive[k] = 0
            self.log.append((op, key, "ok"))
            return None

    def _decide_partial(self, key, size_hint=256):
        """None, or the byte offset at which a write handle dies."""
        with self._lock:
            if not self.partial_rate:
                return None
            k = ("write", key)
            streak = self._consecutive.get(k, 0)
            allowed = self.burst is None or streak < self.burst
            if allowed and self._rng.random() < self.partial_rate:
                self._consecutive[k] = streak + 1
                cut = self._rng.randrange(0, size_hint)
                self.log.append(("write", key, f"partial@{cut}"))
                self.stats["error:partial_write"] += 1
                return cut
            self._consecutive[k] = 0
            return None

    def _decide_latency(self):
        if not self.latency:
            return 0.0
        with self._lock:
            return self._rng.uniform(0.0, self.latency)

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


class _FaultyWriteFile:
    """A write handle that may die midway: it writes a prefix up to the
    plan's offset, then raises ``EIO`` -- the torn write that the
    tmp + fsync + rename protocols and the WAL's retry survive."""

    def __init__(self, f, fail_at):
        self._f = f
        self._fail_at = fail_at
        self._written = 0

    def write(self, data):
        if self._fail_at is not None:
            budget = self._fail_at - self._written
            if len(data) >= budget:
                if budget > 0:
                    self._f.write(data[:budget])
                    self._written += budget
                self._fail_at = None  # one torn write per handle
                raise OSError(errno.EIO, "injected partial write")
        self._f.write(data)
        self._written += len(data)
        return len(data)

    def flush(self):
        self._f.flush()

    def fileno(self):
        return self._f.fileno()

    def close(self):
        self._f.close()

    @property
    def name(self):
        return self._f.name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


class FaultyFS:
    """The injectable filesystem: every primitive consults the plan for a
    latency and an error decision before it calls ``os``, and crash
    points raise :class:`SimulatedCrash` when armed.  The interface is
    :class:`RealFS`'s."""

    def __init__(self, plan):
        self.plan = plan

    def _gate(self, op, path):
        delay = self.plan._decide_latency()
        if delay:
            time.sleep(delay)
        err = self.plan._decide_error(op, os.path.basename(str(path)))
        if err is not None:
            raise OSError(err, f"injected {errno.errorcode.get(err, err)}", str(path))

    def open(self, path, mode="r"):
        self._gate("open", path)
        f = open(path, mode)
        if any(c in mode for c in "wxa+"):
            fail_at = self.plan._decide_partial(os.path.basename(str(path)))
            if fail_at is not None:
                return _FaultyWriteFile(f, fail_at)
        return f

    def rename(self, src, dst):
        self._gate("rename", src)
        os.rename(src, dst)

    def utime(self, path, times=None):
        self._gate("utime", path)
        os.utime(path, times)

    def stat(self, path):
        self._gate("stat", path)
        return os.stat(path)

    def getmtime(self, path):
        self._gate("stat", path)
        return os.path.getmtime(path)

    def listdir(self, path):
        self._gate("listdir", path)
        return os.listdir(path)

    def unlink(self, path):
        self._gate("unlink", path)
        os.unlink(path)

    def exists(self, path):
        self._gate("stat", path)
        return os.path.exists(path)

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def fsync(self, f):
        self._gate("fsync", getattr(f, "name", "?"))
        f.flush()
        os.fsync(f.fileno())

    def crashpoint(self, name):
        self.plan.fire_crashpoint(name)
