"""The service front of the PyTorch port: study handles, per-study
durability, and the socket transport.

The counterpart of :mod:`hyperopt_tpu.serve.service`:

* :class:`SuggestService` / :class:`StudyHandle` (``create_study / ask /
  tell / best``), the in-process API over the study-batched
  :class:`~hyperopt_tpu_torch.serve.scheduler.BatchScheduler`:
  concurrent asks from many studies coalesce into shared device rounds.
  The service runs on the card unless the caller passes ``device="cpu"``
  (:func:`~hyperopt_tpu_torch.utils.resolve_device`); without a card it
  raises;
* :func:`serve_forever`, the TCP front (JSON lines by default, binary
  frames after a ``hello``: :mod:`~hyperopt_tpu_torch.serve.frames`),
  and :func:`main`, the ``hyperopt-tpu-torch-serve`` console script.
  The wire is the reference's byte for byte, so clients and servers of
  the two packages interoperate.

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

``owner=`` gives the service a fleet identity (:mod:`.fleet`): with a
``root`` every study is fenced by a per-study claim/epoch token
(:class:`~hyperopt_tpu_torch.serve.fleet.StudyClaim`, the reference's
file bytes), so a replica whose study was taken over
(``create_study(takeover=True)`` on another replica) or handed off
(:meth:`SuggestService.handoff_study`) gets :class:`~hyperopt_tpu_torch.
exceptions.OwnershipLost` instead of serving it twice.

``mesh=`` (a 1-D ``study`` mesh inside this process,
:func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh`) shards the slot
axis of the scheduler (:mod:`.scheduler`); ``main``'s ``--mesh-devices``
builds it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np

from ..distributed import _common
from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError, DeadlineExpired, Overloaded, ServeError
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

logger = logging.getLogger(__name__)

__all__ = ["RETRY_AFTER_CAP", "StudyHandle", "StudyPersistence", "SuggestService", "main",
           "serve_forever"]

_NAME_RE = re.compile(r"[A-Za-z0-9._-]{1,120}")

#: ceiling on any server-provided ``retry_after`` hint a backoff loop
#: will honor (seconds)
RETRY_AFTER_CAP = 5.0

#: ask keys a study remembers (the most recent): a resubmitted ask that
#: carries its key is served as the tid its first copy drew
ASK_KEYS_KEPT = 256


def _study_guard(algo, space):
    """The study-family fingerprint stamped into every WAL and snapshot
    (the reference's): a root written by another space or algo is
    refused on restore, never reinterpreted."""
    from ..hyperband import _space_fingerprint
    from ..pyll.base import as_apply

    return ["graftserve", 1, str(algo), _space_fingerprint(as_apply(space))]


class StudyPersistence:  # graftlint: disable=GL605 the serve crash windows fire at the scheduler batching layer (serve_after_wal_before_dispatch / group-commit barriers bracket these appends from above), and the TellWAL primitive itself rides the driver windows
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
        self._service._fence(self._study)
        return self._service.scheduler.submit_ask(self._study).future

    def ask(self, timeout=60.0, recover=False, backoff=False, ask_id=None):
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
        served-but-untold one from its recorded vals).  ``ask_id`` (the
        socket client's key for one logical ask, the same on each of its
        resubmissions) makes the ask idempotent: every copy is served as
        the tid the first copy drew (:meth:`SuggestService._ask_keyed`)."""
        if ask_id is not None:
            return self._service._ask_keyed(self._study, str(ask_id), timeout, recover)
        if recover:
            got = self._service._recover_ask(self._study, timeout)
            if got is not None:
                return got
        deadline = time.perf_counter() + float(timeout)
        while True:
            remaining = deadline - time.perf_counter()  # graftlint: disable=GL307 deadline arithmetic (time left until the client deadline), not an ad-hoc latency metric
            self._service._fence(self._study)
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
                time.sleep(wait)  # graftlint: disable=GL303 the backoff IS the server's typed retry_after hint, bounded by the client deadline above -- not an unbounded retry loop
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
    one fsync per round cover its tells.  ``owner`` is a fleet replica's
    id: with a ``root`` each study is claimed for it and every ask and
    tell is fenced by the claim; every metric series and span carries it
    as the ``replica`` label.  ``mesh`` shards the study slots
    (:class:`~hyperopt_tpu_torch.serve.scheduler.BatchScheduler`).
    """

    def __init__(self, space, algo="tpe", root=None, max_batch=64, max_wait_ms=2.0,
                 n_startup_jobs=20, background=True, fs=REAL_FS, snapshot_cadence=256,
                 max_queue=None, study_queue_cap=None, dispatch_timeout=None,
                 finite_check=True, mesh=None, owner=None, recorder=None,
                 device_metrics_every=0, retry_jitter=0.25, retry_jitter_seed=0,
                 group_commit=True, device=None, **algo_kw):
        self.space = space
        self.ps = compile_space(space, device=device)
        self.device = self.ps.device
        self.root = None if root is None else str(root)
        self.fs = fs
        self.snapshot_cadence = int(snapshot_cadence)
        self._guard = _study_guard(algo, space)
        self._background = bool(background)
        self.owner = None if owner is None else str(owner)
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
        if self.owner is not None:
            # a fleet scrape and trace tell the replicas apart by this label
            self.scheduler.metrics.const_labels["replica"] = self.owner
            self.scheduler.span_ids["replica"] = self.owner
        if self._background:
            self.scheduler.start()

    # -- tenancy -----------------------------------------------------------
    def create_study(self, name, seed=0, takeover=False, host_algo=None):  # graftlint: disable=GL503 the durable open record must be atomic with the registry insert -- two racing creates of one name must serialize restore-or-create, and an unrecorded-but-registered study would lose its seed on crash
        """Open (or re-attach to, or restore) a study by name.

        With a fleet identity (``owner=`` and a ``root``) the study's claim
        is acquired first: a study another replica owns is refused with
        :class:`~hyperopt_tpu_torch.exceptions.OwnershipLost` unless
        ``takeover=True`` (the failover and migration path, which bumps
        the claim's epoch and fences the previous owner out).  A study
        this replica still holds under a claim it lost is, with
        ``takeover=True``, dropped and restored from the root: every
        local change since the takeover was fenced off, so the root is
        the truth.  ``host_algo`` (in-process clients) attaches a
        per-study hook ``hook(seed) -> (values [D, 1], active [D, 1])``
        that serves the study instead of the stacked step (ATPE's host
        decision layer cannot run across studies); the study then takes
        no slot."""
        if not _NAME_RE.fullmatch(name):
            raise ValueError(f"study name {name!r} must match {_NAME_RE.pattern}")
        with self._lock:
            handle = self._handles.get(name)
            if handle is not None:
                stale = handle._study.claim
                if not (takeover and stale is not None and not stale.is_live()):
                    return handle
                # a rejoining replica: it lost the claim while cut off, and
                # the router adopts the study here again
                self._drop_fenced(name)
            claim = None
            if self.owner is not None and self.root is not None:
                from .fleet import StudyClaim

                claim = StudyClaim.acquire(self.root, name, self.owner, fs=self.fs,
                                           takeover=takeover)
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
            study.claim = claim
            study.host_algo = host_algo  # before open: it decides the slot
            self.scheduler.open_study(name, seed, study=study)
            if self.recorder.enabled:
                # the study's effective seed (restored or new)
                self.recorder.event("study.open", study=name, seed=int(study.seed),
                                    **self.scheduler.span_ids)
            handle = self._handles[name] = StudyHandle(self, study)
            return handle

    def _fenced_off(self, study):
        return study.claim is not None and not study.claim.is_live()

    def _drop_fenced(self, name):
        """Forget a study whose claim another replica took: close its WAL
        and write nothing, since the root now belongs to the new owner."""
        with self._lock:
            self._handles.pop(name, None)
            study = self.scheduler.close_study(name)
        self._close_wal(study)
        return study

    def _close_wal(self, study):
        # under the scheduler's lock: a round may still barrier the WAL
        if study.persist is not None:
            with self.scheduler._lock:
                study.persist.close()

    def close_study(self, name):
        """Close a study: a final snapshot and the claim's release.  A study
        this replica was fenced off from is only forgotten: its snapshot
        would overwrite what the new owner logged since the takeover."""
        with self._lock:
            handle = self._handles.get(name)
            if handle is None:
                return
            if self._fenced_off(handle._study):
                self._drop_fenced(name)
                return
            self._handles.pop(name)
            study = self.scheduler.close_study(name)
        # the durable close runs outside the registry lock: the study is
        # unregistered, and its WAL holds every tell
        if study.persist is not None:
            self._snapshot(study, force=True)
        self._close_wal(study)
        if study.claim is not None:
            study.claim.release()

    def handoff_study(self, name):
        """The source half of a migration: publish a final snapshot while
        still owning the study, then (past the
        ``fleet_migrate_after_snapshot_before_handoff`` crash point, where
        an aborted migration leaves this replica owning and serving it)
        unregister it, close its WAL and release its claim with the
        handoff mark, so the target adopts it with the next epoch.  The
        artifacts in the shared root are the handoff: nothing is copied."""
        with self._lock:
            handle = self._handles.get(name)
            if handle is None:
                raise ValueError(f"study {name!r} is not open here")
            study = handle._study
            if self._fenced_off(study):
                # taken over already: the target adopts from the root as is
                return self._drop_fenced(name)
        if study.persist is not None:
            self._snapshot(study, force=True)
        self.fs.crashpoint("fleet_migrate_after_snapshot_before_handoff")
        with self._lock:
            self._handles.pop(name, None)
            self.scheduler.close_study(name)
        self._close_wal(study)
        if study.claim is not None:
            # adoption overwrites the mark: one still on disk is a study
            # stranded between handoff and restore (fsck's
            # study_half_migrated)
            study.claim.release(handoff=True)
        return study

    def studies(self):
        with self._lock:
            return sorted(self._handles)

    # -- the handle's plumbing ---------------------------------------------
    def _snapshot(self, study, force=False):
        """A study's snapshot at its cadence (``force``: now), under the
        scheduler's lock: a round appends to the same WAL and reads the
        same history, and the snapshot compacts that WAL."""
        with self.scheduler._lock:
            return study.persist.maybe_snapshot(study, force=force)

    def _fence(self, study):
        """The ownership fence: refuse to act on a study whose claim this
        replica no longer holds (a no-op without claims)."""
        if study.claim is not None:
            study.claim.ensure_live()

    def _submit(self, study, timeout=None, replay=None):
        self._fence(study)
        deadline = None if timeout is None else time.perf_counter() + float(timeout)
        return self.scheduler.submit_ask(study, deadline=deadline, replay=replay)

    def _recover_ask(self, study, timeout):
        """Serve the smallest undelivered suggestion again for a client
        that lost its reply, or None when nothing is undelivered."""
        self._fence(study)
        cand = sorted(set(study.pending_asks) | set(study.outstanding))
        if not cand:
            return None
        tid = cand[0]
        if tid in study.outstanding:
            return tid, dict(study.outstanding[tid])
        req = self._submit(study, timeout=timeout, replay=(tid, study.pending_asks[tid]))
        return self._await(req, timeout)

    def _ask_keyed(self, study, key, timeout, recover):
        """An ask that carries its client's key.  A client that lost an
        ask's reply sends it again, with the same key, on a new
        connection; the copy may reach the scheduler before the first
        one, which another handler thread still holds.  Either way both
        are the tid the first of them drew: served again from its vals,
        or, still queued, from its logged seed -- never a second draw,
        which would skip a seed and leave a suggestion nobody tells.
        A key not seen before is an ordinary ask (``recover`` as
        :meth:`StudyHandle.ask`'s)."""
        self._fence(study)
        with self.scheduler._lock:
            tid = study.ask_keys.get(key)
            if tid is None and recover:
                undelivered = sorted(set(study.pending_asks) | set(study.outstanding))
                tid = undelivered[0] if undelivered else None
            if tid is None:
                req = self._submit(study, timeout=timeout)
            elif tid in study.outstanding:
                req = None
            elif tid in study.pending_asks:
                req = self._submit(study, timeout=timeout,
                                   replay=(tid, study.pending_asks[tid]))
            else:
                raise ValueError(f"ask {key!r} of study {study.name!r} was served as tid "
                                 f"{tid}, which is told already")
            study.ask_keys[key] = tid = req.tid if req is not None else tid
            while len(study.ask_keys) > ASK_KEYS_KEPT:
                study.ask_keys.popitem(last=False)
            if req is None:
                return tid, dict(study.outstanding[tid])
        return self._await(req, timeout)

    def _tell(self, study, tid, loss, vals=None, result=None):
        if vals is None:
            vals = study.outstanding.get(tid)
        if vals is None:
            raise ValueError(
                f"study {study.name!r} has no outstanding suggestion for tid "
                f"{tid}; pass vals= explicitly"
            )
        # the fence comes before the WAL append: a replica whose claim was
        # taken over must not write into the log the new owner appends to
        self._fence(study)
        self.scheduler.tell(study, tid, vals, loss, result=result)
        if study.persist is not None and study.client_state_fn is None:
            # a client's study snapshots at trial boundaries instead, so
            # the bundle never captures a doc mid-finalize
            self._snapshot(study)

    def _fail(self, study, tid, doc=None):
        self._fence(study)
        self.scheduler.tell_failure(study, tid, doc=doc)
        if study.persist is not None and study.client_state_fn is None:
            self._snapshot(study)

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
                out = fut.result(timeout=0)
                self._fence(req.study)  # a replica fenced off must not deliver
                return out
        else:
            try:
                out = fut.result(timeout=timeout)
                self._fence(req.study)
                return out
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
            # the study mesh: shard-local rebuilds, and the shard count
            "shard_restacks": s.shard_restacks,
            "mesh_shards": s._n_shards,
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
        m.gauge("serve_kernel_launches",
                "gmm_llr kernel launches of this service's rounds").set(s.kernel_launches)
        return m.collect()

    def metrics_text(self):
        return render_prometheus(self.metrics_rows())

    def trace_tail(self, n=None):
        """The most recent flight-recorder spans (empty when no recorder
        is armed)."""
        return self.recorder.tail(n)

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
            "owner": self.owner,
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


# ---------------------------------------------------------------------------
# the socket transport and the console script
# ---------------------------------------------------------------------------


def _serve_error_reply(e):
    """The refusal a typed :class:`ServeError` maps to on the wire:
    ``error_type`` names the class, and an :class:`Overloaded`'s
    ``retry_after`` and ``reason`` ride along, so a client backs off as
    the in-process API would."""
    reply = {"ok": False, "error": str(e), "error_type": type(e).__name__}
    if isinstance(e, Overloaded):
        # a concrete back-off: null would make a client hot-loop
        reply["retry_after"] = (min(0.05, RETRY_AFTER_CAP) if e.retry_after is None
                                else e.retry_after)
        reply["reason"] = e.reason
    return reply


def _ask_batch(service, req):
    """A multi-study ask: every admitted ask is submitted before any round
    is pumped, so one device round serves the whole group (one
    ``ask_batch`` frame keeps the coalescing a lockstep connection would
    lose).  On a service without a background loop the handler's thread
    pumps the rounds; the scheduler's lock keeps one round in flight."""
    names = list(req.get("studies") or req.get("names") or ())
    timeout = float(req.get("timeout", 60.0))
    results, reqs = {}, {}
    for name in names:
        with service._lock:
            handle = service._handles.get(name)
        if handle is None:
            results[name] = {"ok": False, "error": f"unknown study {name!r}",
                             "error_type": "UnknownStudy"}
            continue
        try:
            reqs[name] = service._submit(handle._study, timeout=timeout)
        except ServeError as e:
            results[name] = _serve_error_reply(e)
    deadline = time.perf_counter() + timeout
    pending = dict(reqs)
    while pending:
        stepped = service.scheduler.step() if not service._background else 0
        for name in [n for n, r in pending.items() if r.future.done()]:
            pending.pop(name)
        if not pending or time.perf_counter() >= deadline:
            break
        if stepped == 0:
            time.sleep(0.001)
    for name, r in reqs.items():
        if not r.future.done():
            # past the deadline: drop it, so a late round cannot strand
            # the suggestion in flight
            service.scheduler.drop_request(r)
        try:
            tid, vals = r.future.result(timeout=0)
            results[name] = {"ok": True, "tid": tid, "vals": vals}
        except ServeError as e:
            results[name] = _serve_error_reply(e)
        except Exception as e:
            results[name] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                             "error_type": type(e).__name__}
    return {"ok": True, "results": results}


def _handle_request(service, req):
    """One request's reply (the reference's ops and reply fields)."""
    op = req.get("op")
    try:
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "health":
            return {"ok": True, **service.health()}
        if op == "ready":
            return {"ok": True, "ready": service.ready()}
        if op == "metrics":
            rows = service.metrics_rows()
            return {"ok": True, "metrics": rows, "text": render_prometheus(rows)}
        if op == "trace":
            tail = req.get("tail")
            return {"ok": True, "spans": service.trace_tail(None if tail is None else int(tail))}
        if op == "create_study":
            h = service.create_study(req["name"], seed=int(req.get("seed", 0)),
                                     takeover=bool(req.get("takeover", False)))
            return {"ok": True, "study": h.name, "n_tells": h.n_tells}
        if op == "studies":
            return {"ok": True, "studies": service.studies()}
        if op == "ask_batch":
            return _ask_batch(service, req)
        if op == "drain":
            service.drain(timeout=float(req.get("timeout", 30.0)), block=False)
            return {"ok": True, "draining": True,
                    "retry_after": service.scheduler.drain_retry_after()}
        name = req.get("study")
        with service._lock:
            handle = service._handles.get(name)
        if handle is None:
            return {"ok": False, "error": f"unknown study {name!r}",
                    "error_type": "UnknownStudy"}
        if op == "ask":
            tid, vals = handle.ask(timeout=float(req.get("timeout", 60.0)),
                                   recover=bool(req.get("recover", False)),
                                   ask_id=req.get("ask_id"))
            return {"ok": True, "tid": tid, "vals": vals}
        if op == "tell":
            handle.tell(int(req["tid"]), float(req["loss"]), vals=req.get("vals"))
            return {"ok": True}
        if op == "best":
            return {"ok": True, "best": handle.best()}
        if op == "close_study":
            handle.close()
            return {"ok": True}
        if op == "handoff_study":
            service.handoff_study(name)
            return {"ok": True, "handed_off": name}
        return {"ok": False, "error": f"unknown op {op!r}"}
    except ServeError as e:
        return _serve_error_reply(e)


def serve_forever(service, host="127.0.0.1", port=0, idle_timeout=300.0, max_conns=256,
                  net_plan=None):
    """Bind the TCP front; returns the (not yet serving)
    ``ThreadingTCPServer``: call ``.serve_forever()`` (the console script
    does) or drive it from a thread (the tests do).

    JSON lines by default: one JSON object per request line, one reply
    line each, every reply with ``ok`` and either the result fields or
    ``error``.  A client whose first request is ``{"op": "hello",
    "proto": 2}`` moves the connection to binary frames
    (:mod:`~hyperopt_tpu_torch.serve.frames`); replies echo a request's
    ``rid``, so a client may keep many requests in flight.  A framing
    error gets a typed ``FrameError`` reply and the connection closes;
    any other failure of a request rides its reply (``ok: false``) and
    the connection stays.

    ``idle_timeout`` is each accepted socket's read deadline (an idle or
    half-open peer is reaped, never a stranded handler thread); at most
    ``max_conns`` connections are served at once, and one past the cap
    gets a typed ``Overloaded`` refusal (``reason: "max_connections"``)
    and a close.  ``net_plan`` (a :class:`~hyperopt_tpu_torch.
    distributed.netfaults.NetFaultPlan`) wraps every accepted connection.
    """
    import socket
    import socketserver

    from .frames import PROTO_V2, FrameError, read_frame, write_frame

    plan = net_plan
    slots = threading.BoundedSemaphore(int(max_conns))

    class Handler(socketserver.StreamRequestHandler):
        timeout = idle_timeout  # StreamRequestHandler sets it on the socket

        def setup(self):
            super().setup()
            if plan is not None:
                self.rfile, self.wfile = plan.wrap_pair(self.rfile, self.wfile,
                                                        sock=self.connection, key="serve-front")

        def _send(self, reply, binary):
            if binary:
                write_frame(self.wfile, reply)
            else:
                self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))
            self.wfile.flush()

        def handle(self):
            if not slots.acquire(blocking=False):
                try:
                    self._send({"ok": False, "error": "server connection cap reached",
                                "error_type": "Overloaded", "reason": "max_connections",
                                "retry_after": min(0.05, RETRY_AFTER_CAP)}, False)
                except OSError:
                    pass
                return
            try:
                self._handle_conn()
            except socket.timeout:
                return  # the idle deadline: a silent or half-open peer is reaped
            except ConnectionError:
                return  # the peer reset or vanished mid-request
            finally:
                slots.release()

        def _refuse(self, error, binary):
            self._send({"ok": False, "error": error, "error_type": "FrameError"}, binary)

        def _handle_conn(self):
            binary = False
            while True:
                if binary:
                    try:
                        req = read_frame(self.rfile)
                    except FrameError as e:
                        # a typed reply, then hang up: past a framing error
                        # the stream offset means nothing
                        self._refuse(str(e), binary)
                        return
                    if req is None:
                        return
                    if not isinstance(req, dict):
                        self._refuse("frame payload must be a map", binary)
                        return
                else:
                    raw = self.rfile.readline()
                    if not raw:
                        return
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except ValueError as e:
                        self._refuse(f"malformed request line: {e}", binary)
                        continue
                    if not isinstance(req, dict):
                        self._refuse("request must be a JSON object", binary)
                        continue
                if req.get("op") == "hello":
                    proto = min(int(req.get("proto", 1)), PROTO_V2)
                    reply = {"ok": True, "proto": proto}
                    if "rid" in req:
                        reply["rid"] = req["rid"]
                    # the ack goes out in the old mode; both sides switch after it
                    self._send(reply, binary)
                    binary = proto >= PROTO_V2
                    continue
                try:
                    reply = _handle_request(service, req)
                except Exception as e:
                    # one bad request does not end the connection: the
                    # error rides its reply
                    logger.debug("request %r failed", req.get("op"), exc_info=True)
                    reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if "rid" in req:
                    reply = dict(reply, rid=req["rid"])
                self._send(reply, binary)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((host, int(port)), Handler)


def _load_space(spec):
    """``module:attr`` -> the space object (called if it is a factory)."""
    import importlib

    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--space must be module:attr, got {spec!r}")
    obj = getattr(importlib.import_module(mod_name), attr)
    return obj() if callable(obj) else obj


def main(argv=None):
    """``hyperopt-tpu-torch-serve``: the service as a process, on the card
    unless ``--device cpu``."""
    import argparse

    from ..utils import resolve_device

    parser = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-serve",
        description="multi-tenant suggestion service on the card: study-batched fused "
        "tell+ask with continuous batching over a JSON-line / binary-frame TCP transport",
    )
    parser.add_argument("--space", required=True,
                        help="module:attr of the search space (or a zero-arg factory)")
    parser.add_argument("--algo", default="tpe", choices=("tpe", "anneal"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7077)
    parser.add_argument("--root", default=None,
                        help="directory for per-study WAL/snapshot durability")
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--n-startup-jobs", type=int, default=20)
    parser.add_argument("--max-queue", type=int, default=None,
                        help="ask-queue high-water mark (default 4 * max-batch); submits "
                        "past it get a typed Overloaded with retry-after")
    parser.add_argument("--dispatch-timeout", type=float, default=30.0,
                        help="watchdog deadline (seconds) per device dispatch; 0 disables "
                        "the watchdog")
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="shard the study slot axis into this many shards inside this "
                        "process (0 = unsharded, -1 = one shard per visible card); every "
                        "shard runs on --device (shards spread over several cards are "
                        "refused)")
    parser.add_argument("--owner", default=None,
                        help="fleet replica identity: with --root, every study is fenced by a "
                        "per-study claim/epoch token (hyperopt-tpu-torch-router fronts such "
                        "replicas)")
    parser.add_argument("--flight-log", default=None, metavar="PATH",
                        help="arm the flight recorder with a durable span export at PATH "
                        "(scrape live with hyperopt-tpu-torch-scope trace, post-mortem with "
                        "hyperopt-tpu-torch-scope flight PATH)")
    parser.add_argument("--trace-cadence", type=int, default=1,
                        help="flight-recorder sampling cadence (1 = record every span; k "
                        "keeps every k-th); only meaningful with --flight-log")
    parser.add_argument("--device-metrics-every", type=int, default=0,
                        help="run the device-metrics twin every N rounds (0 = off: exactly "
                        "zero extra reads of the card)")
    parser.add_argument("--idle-timeout", type=float, default=300.0,
                        help="per-connection idle deadline (seconds): an idle or half-open "
                        "client is reaped instead of stranding a handler thread")
    parser.add_argument("--max-conns", type=int, default=256,
                        help="bound on concurrently served connections; one past the cap "
                        "gets a typed Overloaded refusal (reason max_connections)")
    parser.add_argument("--device", default=None,
                        help="the torch device to serve on (default: the CUDA card; 'cpu' "
                        "must be asked for)")
    args = parser.parse_args(argv)
    if args.mesh_devices < -1:
        parser.error(f"--mesh-devices {args.mesh_devices}: expected 0, -1 or a shard count")

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.exit(2, f"{parser.prog}: {e}\n")
    mesh = None
    if args.mesh_devices:
        import torch

        from ..parallel.mesh import STUDY_AXIS, virtual_mesh

        n = args.mesh_devices
        if n < 0:
            if device.type != "cuda":
                parser.error(f"--mesh-devices -1 counts cards; --device {device} is none")
            n = torch.cuda.device_count()
        mesh = virtual_mesh(n, axis_name=STUDY_AXIS)
    recorder = None
    if args.flight_log:
        from ..obs import FlightRecorder

        recorder = FlightRecorder(path=args.flight_log, cadence=args.trace_cadence)
    service = SuggestService(
        _load_space(args.space), algo=args.algo, root=args.root, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, n_startup_jobs=args.n_startup_jobs,
        max_queue=args.max_queue, dispatch_timeout=args.dispatch_timeout or None,
        mesh=mesh, owner=args.owner, recorder=recorder,
        device_metrics_every=args.device_metrics_every, device=device,
    )
    server = serve_forever(service, host=args.host, port=args.port,
                           idle_timeout=args.idle_timeout, max_conns=args.max_conns)
    host, port = server.server_address[:2]
    print(f"hyperopt-tpu-torch-serve listening on {host}:{port} ({device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
