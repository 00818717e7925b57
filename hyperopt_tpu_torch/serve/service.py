"""The in-process service front of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.serve.service`'s
:class:`SuggestService` / :class:`StudyHandle` (``create_study / ask /
tell / best``), over the study-batched
:class:`~hyperopt_tpu_torch.serve.scheduler.BatchScheduler`: concurrent
asks from many studies coalesce into shared device rounds.  The service
runs on the card unless the caller passes ``device="cpu"``
(:func:`~hyperopt_tpu_torch.utils.resolve_device`); without a card it
raises.

``root=`` makes every study durable (:class:`StudyPersistence`): each
tell is appended to the study's :class:`~hyperopt_tpu_torch.utils.wal.
TellWAL` before it is applied, ask records carry the bit-generator
cursor after their seed draw, and snapshot bundles (the dense history's
``.npz`` and the cursor) compact the log every ``snapshot_cadence``
tells.  A service killed mid-round restores each study with zero lost
and zero duplicated tells and a stream that continues exactly where it
stopped; ``ask(recover=True)`` serves a crashed client's undelivered ask
again.  The WAL records are the reference's bytes; the snapshot pickles
the port's own objects and is not read across the packages.

Not ported yet, and refused with ``NotImplementedError`` naming the
``ROADMAP.md`` Queue A item that brings them: ``owner=`` (fleet claims,
item 12d) here, ``mesh=`` (item 15) and ``device_metrics_every`` (item
16) by the scheduler.  The socket transport waits for item 12c.
"""

from __future__ import annotations

import os
import re
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np

from ..distributed import _common
from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError, DeadlineExpired, Overloaded
from ..obs.expo import render_prometheus
from ..ops.compile import compile_space
from ..utils.checkpoint import (
    decode_rstate,
    durable_pickle,
    encode_rstate,
    load_obs_buffer_bytes,
    load_pickle_guarded,
    obs_buffer_npz_bytes,
)
from ..utils.wal import TellWAL
from .scheduler import BatchScheduler, ServeStudy

__all__ = ["RETRY_AFTER_CAP", "StudyHandle", "StudyPersistence", "SuggestService"]

_NAME_RE = re.compile(r"[A-Za-z0-9._-]{1,120}")

#: ceiling on any server-provided ``retry_after`` hint a backoff loop
#: will honor (seconds)
RETRY_AFTER_CAP = 5.0


def _not_ported(what, item):
    return NotImplementedError(
        f"SuggestService({what}) is not ported yet: ROADMAP.md Queue A item {item}"
    )


def _study_guard(algo, space):
    """The study-family fingerprint stamped into every WAL and snapshot
    (the reference's): a root written by another space or algo is
    refused on restore, never reinterpreted."""
    from ..hyperband import _space_fingerprint
    from ..pyll.base import as_apply

    return ["graftserve", 1, str(algo), _space_fingerprint(as_apply(space))]


class StudyPersistence:
    """A study's WAL and snapshot bundle under ``<root>/<name>``.

    ``<name>.wal`` holds ``open`` / ``ask`` / ``served`` / ``tell`` /
    ``fail`` records; ``<name>.snap`` is the durable bundle the WAL
    compacts into every ``cadence`` tells.  A tell is on disk before the
    host buffer changes, so replay after a crash is exactly once (dedup
    by tid)."""

    def __init__(self, root, name, guard, fs=REAL_FS, cadence=256):
        self.root = str(root)
        self.name = name
        self.fs = fs
        self.cadence = max(1, int(cadence))
        self.fs.makedirs(self.root, exist_ok=True)
        base = os.path.join(self.root, name)
        self.snap_path = base + ".snap"
        self.wal = TellWAL(base + ".wal", fs=fs, guard=guard)
        self._tells_since_snap = 0

    def _snap_exists(self):
        return _common.with_retries(lambda: self.fs.exists(self.snap_path),
                                    label="snap exists")

    def exists(self):
        return self.wal.exists() or self._snap_exists()

    # -- write-ahead records -------------------------------------------------
    def log_open(self, seed):
        self.wal.append("open", {"seed": int(seed)})

    def log_ask(self, tid, seed, rstate):
        # flush-only: a lost ask is drawn again from the restored cursor,
        # and the next tell's fsync covers it
        self.wal.append("ask", {"tid": int(tid), "seed": int(seed),
                                "rstate": encode_rstate(rstate)}, sync=False)

    def log_served(self, tid, vals):
        self.wal.append("served", {"tid": int(tid), "vals": dict(vals)}, sync=False)

    def log_tell(self, tid, vals, loss, result=None, sync=True):
        """``sync=False`` is group commit: the record is flushed (a process
        death loses nothing) and the scheduler's round barrier fsyncs it.
        ``result`` (the client's full result dict) rides the record, so a
        resumed client rebuilds its docs from the one WAL."""
        body = {"tid": int(tid), "vals": dict(vals), "loss": float(loss)}
        if result is not None:
            body["result"] = result
        self.wal.append("tell", body, sync=sync)
        self._tells_since_snap += 1

    def log_fail(self, tid, doc=None):
        """One FAILED evaluation, durable before the doc finalizes:
        nothing enters the posterior, but a resumed run never evaluates
        it again."""
        body = {"tid": int(tid)}
        if doc is not None:
            body["doc"] = doc
        self.wal.append("fail", body)
        self._tells_since_snap += 1

    # -- snapshots -------------------------------------------------------------
    def maybe_snapshot(self, study, force=False):
        if not force and self._tells_since_snap < self.cadence:
            return False
        self.snapshot(study)
        return True

    def snapshot(self, study):
        """Publish the bundle, then compact the WAL; a crash between the
        two replays the old log, deduplicated by tid."""
        bundle = {
            "format": 1,
            "guard": self.wal.guard,
            "seed": study.seed,
            "obs_npz": obs_buffer_npz_bytes(study.buf),
            "rstate": encode_rstate(study.rstate),
            "next_tid": int(study.next_tid),
            "n_asks": int(study.n_asks),
            "n_tells": int(study.n_tells),
            "total_tells": int(self.wal.total_tells),
            "outstanding": {int(t): dict(v) for t, v in study.outstanding.items()},
            # restored in-flight asks survive a snapshot that compacts
            # their records away
            "pending_asks": {int(t): int(s) for t, s in study.pending_asks.items()},
        }
        if study.client_state_fn is not None:
            # the fmin client's docs ride the same bundle
            bundle["client"] = study.client_state_fn()
        _common.with_retries(lambda: durable_pickle(bundle, self.snap_path, fs=self.fs),
                             label="serve snapshot")
        _common.with_retries(self.wal.reset, label="serve wal reset")
        self._tells_since_snap = 0

    # -- restore ---------------------------------------------------------------
    def restore(self, ps):
        """The study rebuilt from its snapshot and the WAL suffix, or None
        when the root holds nothing of it.  Tells replay once (dedup by
        tid); the cursor of the last logged ask supersedes the
        snapshot's, so the seed stream continues bitwise."""
        if not self.exists():
            return None
        bundle = None
        if self._snap_exists():
            bundle = load_pickle_guarded(self.snap_path, fs=self.fs, what="study snapshot")
            if (self.wal.guard is not None and bundle.get("guard") is not None
                    and list(bundle["guard"]) != list(self.wal.guard)):
                raise CheckpointError(
                    f"study snapshot {self.snap_path!r} was written by a different study "
                    f"family (guard {bundle['guard']!r} != {self.wal.guard!r}); refusing "
                    "to restore"
                )
        study = ServeStudy(self.name, int(bundle["seed"]) if bundle else 0, ps)
        if bundle is not None:
            study.buf = load_obs_buffer_bytes(ps, bundle["obs_npz"])
            study.rstate = decode_rstate(bundle["rstate"])
            study.next_tid = int(bundle["next_tid"])
            study.n_asks = int(bundle["n_asks"])
            study.n_tells = int(bundle["n_tells"])
            study.outstanding = {int(t): dict(v)
                                 for t, v in bundle.get("outstanding", {}).items()}
            study.pending_asks = {int(t): int(s)
                                  for t, s in bundle.get("pending_asks", {}).items()}
        records = self.wal.replay() if self.wal.exists() else []
        last_cursor = None
        for rec in records:
            kind = rec.get("kind")
            if kind == "open":
                study.seed = int(rec["seed"])
                if bundle is None:
                    study.rstate = np.random.default_rng(study.seed)
                continue
            tid = int(rec["tid"])
            if kind == "ask":
                study.next_tid = max(study.next_tid, tid + 1)
                last_cursor = rec["rstate"]
                # in flight until a served or tell record settles it: the
                # logged seed serves it again bitwise
                study.pending_asks[tid] = int(rec["seed"])
            elif kind == "served":
                study.outstanding[tid] = dict(rec["vals"])
                study.pending_asks.pop(tid, None)
            elif kind in ("tell", "fail"):
                if kind == "tell":
                    buf = study.buf
                    if not (buf.tids[: buf.count] == tid).any():
                        buf.add(dict(rec["vals"]), float(rec["loss"]), tid=tid)
                        study.n_tells += 1
                # a failed evaluation is settled too: never served again
                study.next_tid = max(study.next_tid, tid + 1)
                study.outstanding.pop(tid, None)
                study.pending_asks.pop(tid, None)
        if last_cursor is not None:
            study.rstate = decode_rstate(last_cursor)
        # the client's restore seam: its blob and the replayed records
        study.client_blob = bundle.get("client") if bundle else None
        study.restore_records = records
        study.dirty = True
        return study

    def close(self):
        self.wal.close()


class StudyHandle:
    """One tenant's view of the service: ``ask`` returns ``(tid,
    vals)``; evaluate, then ``tell(tid, loss)`` -- the service remembers
    what it suggested for every outstanding tid."""

    def __init__(self, service, study):
        self._service = service
        self._study = study

    @property
    def name(self):
        return self._study.name

    def ask_async(self):
        """Queue one ask; returns a Future of ``(tid, vals)``.  Raises
        :class:`~hyperopt_tpu_torch.exceptions.Overloaded` when admission
        control refuses the submit."""
        return self._service.scheduler.submit_ask(self._study).future

    def ask(self, timeout=60.0, recover=False, backoff=False):
        """One suggestion, blocking until its round is served.

        ``timeout`` doubles as the CLIENT DEADLINE the scheduler sheds
        against: an ask still queued when it passes is dropped and raises
        :class:`~hyperopt_tpu_torch.exceptions.DeadlineExpired`.
        ``backoff=True`` turns an :class:`Overloaded` refusal into
        bounded retry under the same deadline (sleeping the refusal's
        ``retry_after``, capped at :data:`RETRY_AFTER_CAP`).
        ``recover=True`` declares that the previous ask's reply was lost:
        the smallest undelivered suggestion is served again instead of a
        new draw (a restored in-flight ask with its logged seed, a
        served-but-untold one from its recorded vals)."""
        if recover:
            got = self._service._recover_ask(self._study, timeout)
            if got is not None:
                return got
        deadline = time.perf_counter() + float(timeout)
        while True:
            remaining = deadline - time.perf_counter()
            try:
                req = self._service.scheduler.submit_ask(
                    self._study, deadline=time.perf_counter() + max(remaining, 0.0))
            except Overloaded as e:
                if not backoff:
                    raise
                wait = min(e.retry_after if e.retry_after else 0.05, RETRY_AFTER_CAP)
                if time.perf_counter() + wait >= deadline:
                    raise DeadlineExpired(
                        f"study {self._study.name!r}: the service stayed overloaded "
                        f"({e.reason}) past the client deadline ({timeout}s); last "
                        f"retry_after hint was {wait}s"
                    ) from e
                time.sleep(wait)
                continue
            return self._service._await(req, max(remaining, 0.0))

    def tell(self, tid, loss, vals=None, result=None):
        """Report one evaluation.  ``vals`` defaults to what the service
        served for ``tid``; pass it to tell a trial the service did not
        suggest (a warm start, or work whose ack a crashed service lost).
        ``result`` (JSON-able) is stored on the durable tell record."""
        self._service._tell(self._study, tid, loss, vals, result=result)

    def fail(self, tid, doc=None):
        """Report one FAILED evaluation: the suggestion for ``tid`` is
        retired and nothing enters the posterior; the failure, with the
        JSON-able ``doc`` (error, traceback), is durable first."""
        self._service._fail(self._study, tid, doc)

    def best(self):
        """``{"loss", "vals"}`` of the best completed trial, or None."""
        out = self._study.best()
        if out is None:
            return None
        loss, vals = out
        return {"loss": loss, "vals": vals}

    @property
    def n_tells(self):
        return self._study.n_tells

    def close(self):
        self._service.close_study(self.name)


class SuggestService:
    """The multi-tenant suggestion service over one space.

    ``background=True`` (default) runs the continuous-batching loop on
    a daemon thread: concurrent ``ask()`` calls from many studies
    coalesce into shared device rounds under the ``max_wait_ms``
    latency budget.  ``background=False`` is the deterministic mode:
    submit with ``ask_async`` and serve rounds with :meth:`pump`
    (blocking ``ask`` pumps inline).  ``device`` is where the stacked
    state and every round live (None = the card).  ``algo`` is
    ``"tpe"``, ``"anneal"`` or ``"atpe"`` (whose studies each bring a
    ``host_algo`` hook, :meth:`create_study`); ``algo_kw`` (``n_cand``,
    ``gamma``, ``lf``, ``prior_weight``, ``n_cand_cat``, ``above_cap`` /
    ``avg_best_idx``, ``shrink_coef``) parameterize its step.  ``root``
    makes every study durable (:class:`StudyPersistence`, a snapshot
    every ``snapshot_cadence`` tells) and :meth:`create_study` restores a
    study the root already holds; ``fs`` is the fault seam shared by the
    scheduler and every WAL and snapshot write; ``group_commit`` makes
    one fsync per round cover its tells.
    """

    def __init__(self, space, algo="tpe", root=None, max_batch=64, max_wait_ms=2.0,
                 n_startup_jobs=20, background=True, fs=REAL_FS, snapshot_cadence=256,
                 max_queue=None, study_queue_cap=None, dispatch_timeout=None,
                 finite_check=True, mesh=None, owner=None, recorder=None,
                 device_metrics_every=0, retry_jitter=0.25, retry_jitter_seed=0,
                 group_commit=True, device=None, **algo_kw):
        if owner is not None:
            raise _not_ported("owner= (fleet claims)", "12d")
        self.space = space
        self.ps = compile_space(space, device=device)
        self.device = self.ps.device
        self.root = None if root is None else str(root)
        self.fs = fs
        self.snapshot_cadence = int(snapshot_cadence)
        self._guard = _study_guard(algo, space)
        self._background = bool(background)
        self._lock = threading.RLock()
        self._handles = {}
        self.scheduler = BatchScheduler(
            self.ps, algo=algo, max_batch=max_batch, max_wait=float(max_wait_ms) / 1000.0,
            n_startup_jobs=n_startup_jobs, fs=fs, max_queue=max_queue,
            study_queue_cap=study_queue_cap, dispatch_timeout=dispatch_timeout,
            finite_check=finite_check, mesh=mesh, recorder=recorder,
            device_metrics_every=device_metrics_every, retry_jitter=retry_jitter,
            retry_jitter_seed=retry_jitter_seed, group_commit=group_commit, **algo_kw,
        )
        self.recorder = self.scheduler.recorder
        if self._background:
            self.scheduler.start()

    # -- tenancy -----------------------------------------------------------
    def create_study(self, name, seed=0, host_algo=None):
        """Open (or re-attach to, or restore) a study by name.

        ``host_algo`` (in-process clients) attaches a per-study hook
        ``hook(seed) -> (values [D, 1], active [D, 1])`` that serves the
        study instead of the stacked step (ATPE's host decision layer
        cannot run across studies); the study then takes no slot."""
        if not _NAME_RE.fullmatch(name):
            raise ValueError(f"study name {name!r} must match {_NAME_RE.pattern}")
        with self._lock:
            handle = self._handles.get(name)
            if handle is not None:
                return handle
            persist = study = None
            if self.root is not None:
                persist = StudyPersistence(self.root, name, self._guard, fs=self.fs,
                                           cadence=self.snapshot_cadence)
                study = persist.restore(self.ps)
            if study is None:
                study = ServeStudy(name, seed, self.ps)
                if persist is not None:
                    persist.log_open(seed)
            study.persist = persist
            study.host_algo = host_algo  # before open: it decides the slot
            self.scheduler.open_study(name, seed, study=study)
            if self.recorder.enabled:
                # the study's effective seed (restored or new)
                self.recorder.event("study.open", study=name, seed=int(study.seed))
            handle = self._handles[name] = StudyHandle(self, study)
            return handle

    def close_study(self, name):
        with self._lock:
            if self._handles.pop(name, None) is None:
                return
            study = self.scheduler.close_study(name)
        # the durable close runs outside the registry lock: the study is
        # unregistered, and its WAL holds every tell
        if study.persist is not None:
            study.persist.maybe_snapshot(study, force=True)
            study.persist.close()

    def studies(self):
        with self._lock:
            return sorted(self._handles)

    # -- the handle's plumbing ---------------------------------------------
    def _submit(self, study, timeout=None, replay=None):
        deadline = None if timeout is None else time.perf_counter() + float(timeout)
        return self.scheduler.submit_ask(study, deadline=deadline, replay=replay)

    def _recover_ask(self, study, timeout):
        """Serve the smallest undelivered suggestion again for a client
        that lost its reply, or None when nothing is undelivered."""
        cand = sorted(set(study.pending_asks) | set(study.outstanding))
        if not cand:
            return None
        tid = cand[0]
        if tid in study.outstanding:
            return tid, dict(study.outstanding[tid])
        req = self._submit(study, timeout=timeout, replay=(tid, study.pending_asks[tid]))
        return self._await(req, timeout)

    def _tell(self, study, tid, loss, vals=None, result=None):
        if vals is None:
            vals = study.outstanding.get(tid)
        if vals is None:
            raise ValueError(
                f"study {study.name!r} has no outstanding suggestion for tid "
                f"{tid}; pass vals= explicitly"
            )
        self.scheduler.tell(study, tid, vals, loss, result=result)
        if study.persist is not None and study.client_state_fn is None:
            # a client's study snapshots at trial boundaries instead, so
            # the bundle never captures a doc mid-finalize
            study.persist.maybe_snapshot(study)

    def _fail(self, study, tid, doc=None):
        self.scheduler.tell_failure(study, tid, doc=doc)
        if study.persist is not None and study.client_state_fn is None:
            study.persist.maybe_snapshot(study)

    def _await(self, req, timeout):
        """Block on one admitted ask under its client deadline: pump
        inline in deterministic mode, wait in background mode; on expiry,
        drop the request from the queue or grace-wait a round that
        already picked it."""
        fut = req.future
        if not self._background:
            while not fut.done():
                if self.scheduler.step() == 0 and not fut.done():
                    if req.deadline is not None and time.perf_counter() > req.deadline:
                        break
                    time.sleep(0.001)
            if fut.done():
                return fut.result(timeout=0)
        else:
            try:
                return fut.result(timeout=timeout)
            except FutureTimeout:
                pass
        if self.scheduler.drop_request(req):
            return fut.result(timeout=0)  # raises DeadlineExpired
        grace = self.scheduler.dispatch_timeout or 5.0
        return fut.result(timeout=2.0 * grace + 1.0)

    # -- service-level controls --------------------------------------------
    def pump(self):
        """Serve one coalesced round inline (deterministic mode)."""
        return self.scheduler.step()

    @property
    def counters(self):
        s = self.scheduler
        return {
            "dispatch_count": s.dispatch_count,
            "delta_drain_dispatches": s.delta_drain_dispatches,
            "upload_events": s.upload_events,
            "upload_bytes": s.upload_bytes,
            "joins": s.joins,
            "rebuckets": s.rebuckets,
            "admitted_count": s.admitted_count,
            "shed_count": s.shed_count,
            "guard_checks": s.guard_checks,
            "quarantine_count": s.quarantine_count,
            "evictions": s.evictions,
            "watchdog_timeouts": s.watchdog_timeouts,
            "watchdog_retries": s.watchdog_retries,
            "watchdog_recoveries": s.watchdog_recoveries,
            "host_algo_served": s.host_algo_served,
            # group commit: round fsyncs, and the fsync and tell tallies
            # of the open studies' WALs
            "group_commit_barriers": s.group_commit_barriers,
            "wal_fsyncs": self._wal_stat("fsyncs"),
            "wal_tells": self._wal_stat("total_tells"),
        }

    def _wal_stat(self, attr):
        with self._lock:
            studies = [h._study for h in self._handles.values()]
        return sum(int(getattr(st.persist.wal, attr)) for st in studies
                   if st.persist is not None)

    def metrics_rows(self):
        """Refresh the point-in-time gauges, then one snapshot-consistent
        collect of the scheduler's registry."""
        s = self.scheduler
        m = s.metrics
        with self._lock:
            n_studies = len(self._handles)
        m.gauge("serve_studies", "open studies").set(n_studies)
        m.gauge("serve_queue_depth", "asks queued").set(len(s._asks))
        m.gauge("serve_ready", "1 = accepting asks").set(1 if self.ready() else 0)
        return m.collect()

    def metrics_text(self):
        return render_prometheus(self.metrics_rows())

    def ready(self):
        """False while draining, circuit-broken or stopped."""
        s = self.scheduler
        return not (s.draining or s.circuit_open or s._stopping)

    def health(self):
        """Status, tenancy, queue occupancy and the counters."""
        s = self.scheduler
        if s._stopping:
            status = "stopped"
        elif s.circuit_open:
            status = "circuit_open"
        elif s.draining:
            status = "draining"
        else:
            status = "ok"
        with self._lock:
            n_studies = len(self._handles)
        return {
            "status": status,
            "ready": self.ready(),
            "studies": n_studies,
            "queue_depth": len(s._asks),
            "max_queue": s.max_queue,
            "max_batch": s.max_batch,
            "device": str(self.device),
            "counters": self.counters,
        }

    def drain(self, timeout=30.0, block=True):
        """Refuse new asks with ``Overloaded(reason="draining")``, serve
        what is queued, then shut down, snapshotting every durable study
        (``block=False`` only enters draining mode)."""
        self.scheduler.drain(timeout=timeout)
        if not block:
            return
        deadline = time.perf_counter() + float(timeout)
        while self.scheduler._asks and time.perf_counter() < deadline:
            if not self._background:
                self.scheduler.step()
            else:
                time.sleep(0.01)
        self.shutdown()

    def shutdown(self):
        self.scheduler.stop()
        with self._lock:
            for name in list(self._handles):
                self.close_study(name)
        self.recorder.flush()
        self.recorder.close()
