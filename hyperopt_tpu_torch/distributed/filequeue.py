"""FileTrials: a shared-filesystem job queue with atomic reservation.

The port of :mod:`hyperopt_tpu.distributed.filequeue` (the reference's
MongoDB work-queue role, on the filesystem a cluster already shares: NFS,
GCS FUSE):

* the queue is a directory; a trial is one JSON file, byte for byte the
  reference's for the same doc;
* reservation NEW -> RUNNING is an atomic ``os.rename`` into ``running/``
  (exactly one worker wins; the loser gets ENOENT): the CAS;
* the ``Domain`` ships to workers as a pickled attachment file;
* dead workers are reaped by mtime: ``running/`` entries older than
  ``reserve_timeout`` are renamed back into ``new/``;
* results land in ``done/`` by write-tmp-then-rename (atomic publish);
  an exception produces an ERROR doc with its traceback.

Failure semantics: every filesystem primitive goes through an injectable
``fs`` seam (:mod:`.faults`), and every queue operation retries transient
mount blips (the ESTALE/EIO class) with bounded backoff
(:func:`._common.with_retries`); each claim carries a unique token, and
``complete(doc, require_claim=True)`` publishes only while the claim is
still this worker's (a reaped and rerun job must not produce a second
DONE doc); ``reap`` releases, rather than recycles, a claim whose DONE
doc is already published.  ``hyperopt-tpu-torch-fsck --dir D [--repair]``
(:mod:`.fsck`) audits and repairs a queue directory.

Run workers with ``python -m hyperopt_tpu_torch.distributed.worker --dir
DIR`` (the ``hyperopt-tpu-torch-worker`` console script).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import time
import uuid

from ..base import JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_RUNNING, Trials
from ..utils import coarse_utcnow
from . import _common
from .faults import REAL_FS

logger = logging.getLogger(__name__)

__all__ = ["FileAttachments", "FileJobQueue", "FileTrials", "worker_owner"]


def _encode(obj):
    if isinstance(obj, datetime.datetime):
        return {"__dt__": obj.isoformat()}
    raise TypeError(f"not JSON serializable: {type(obj)}")


def _decode(d):
    if "__dt__" in d:
        return datetime.datetime.fromisoformat(d["__dt__"])
    return d


def _write_atomic(path, payload, fs=REAL_FS, crash_before_rename=None):
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open(tmp, "w") as f:
        json.dump(payload, f, default=_encode)
        fs.fsync(f)
    if crash_before_rename is not None:
        fs.crashpoint(crash_before_rename)
    fs.rename(tmp, path)


def _read_json(path, fs=REAL_FS):
    with fs.open(path) as f:
        return json.load(f, object_hook=_decode)


class FileAttachments:
    """Dict-like binary attachment store backed by a directory."""

    def __init__(self, root, fs=REAL_FS):
        self.root = root
        self.fs = fs
        fs.makedirs(root, exist_ok=True)

    def _path(self, key):
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(key))
        return os.path.join(self.root, safe)

    def __contains__(self, key):
        return self.fs.exists(self._path(key))

    def __getitem__(self, key):
        def read():
            with self.fs.open(self._path(key), "rb") as f:
                return f.read()
        try:
            return _common.with_retries(read, label="attachment read")
        except FileNotFoundError:
            raise KeyError(key)

    def __setitem__(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"

        def write():
            # fsync BEFORE the rename, like _write_atomic: without it a
            # crash shortly after the rename can publish an empty or
            # truncated blob (the rename metadata may reach disk before
            # the data does) -- and a truncated Domain pickle poisons
            # every worker that loads it
            with self.fs.open(tmp, "wb") as f:
                f.write(value)
                self.fs.fsync(f)
            self.fs.crashpoint("after_attach_fsync_before_rename")
            self.fs.rename(tmp, path)

        _common.with_retries(write, label="attachment write")

    def __delitem__(self, key):
        try:
            _common.with_retries(
                lambda: self.fs.unlink(self._path(key)),
                label="attachment delete",
            )
        except FileNotFoundError:
            raise KeyError(key)

    def keys(self):
        return _common.with_retries(
            lambda: self.fs.listdir(self.root), label="attachment list"
        )


class FileJobQueue:
    """The queue protocol: reserve / complete / reap over a directory.

    ``fs`` injects the filesystem seam (default: the real ``os``); pass
    ``faults.FaultPlan(...).fs()`` to run the protocol under seeded
    faults.
    """

    def __init__(self, root, fs=None):
        self.root = os.path.abspath(root)
        self.fs = fs if fs is not None else REAL_FS
        for sub in ("new", "running", "done"):
            self.fs.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self.attachments = FileAttachments(
            os.path.join(self.root, "attachments"), fs=self.fs
        )

    def _p(self, sub, name=""):
        return os.path.join(self.root, sub, name)

    # -- driver side -------------------------------------------------------
    def publish(self, doc):
        _common.with_retries(
            lambda: _write_atomic(
                self._p("new", f"{doc['tid']}.json"), doc, fs=self.fs,
                crash_before_rename="after_publish_tmp_before_rename",
            ),
            label="publish",
        )

    def done_docs(self):
        out = {}
        names = _common.with_retries(
            lambda: self.fs.listdir(self._p("done")), label="done scan"
        )
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                doc = _common.with_retries(
                    lambda: _read_json(self._p("done", name), fs=self.fs),
                    label="done read",
                )
            except (json.JSONDecodeError, OSError):
                continue  # mid-write by a worker on a non-atomic FS
            out[doc["tid"]] = doc
        return out

    def counts(self):
        return {
            sub: len([
                n
                for n in _common.with_retries(
                    lambda: self.fs.listdir(self._p(sub)), label="counts"
                )
                if n.endswith(".json")
            ])
            for sub in ("new", "running", "done")
        }

    # -- worker side -------------------------------------------------------
    def reserve(self, owner, exp_key=None, exclude_tids=()):
        """Atomically claim one NEW job; None if queue empty/raced away.

        ``exclude_tids`` lets a worker skip jobs it has already proven
        it cannot process (e.g. a dangling Domain attachment) -- the
        sorted scan would otherwise hand the same poisoned job back on
        every call and starve everything behind it."""
        names = sorted(
            n
            for n in _common.with_retries(
                lambda: self.fs.listdir(self._p("new")), label="reserve scan"
            )
            if n.endswith(".json")
        )
        for name in names:
            src = self._p("new", name)
            dst = self._p("running", name)
            try:
                doc = _common.with_retries(
                    lambda: _read_json(src, fs=self.fs), label="reserve read"
                )
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            except OSError:
                continue  # transient blip outlasted the retries: the
                # job stays in new/, a later pass picks it up
            if exp_key is not None and doc.get("exp_key") != exp_key:
                continue
            if doc.get("tid") in exclude_tids:
                continue
            try:
                already_done = self._already_done(name)
            except OSError:
                continue  # can't prove it's not completed: skip this
                # candidate for now rather than risk a duplicate
            if already_done:
                # a crash between complete()'s DONE publish and its
                # claim release, reaped by a pre-fix reaper (or fsck
                # fixture corruption), can leave a completed job back
                # in new/ -- re-evaluating it would duplicate the DONE
                # doc, so retire the leftover instead of claiming it
                try:
                    self.fs.unlink(src)
                except OSError:
                    pass
                continue
            try:
                def claim():
                    # refresh the mtime BEFORE the CAS rename: a job that
                    # waited in new/ longer than reserve_timeout would carry
                    # its stale mtime into running/ and be reap-eligible
                    # until _write_atomic below rewrites it -- a concurrent
                    # reaper in that window could move it back to new/ while
                    # this worker recreates the running file, duplicating
                    # the evaluation (as reap() and unreserve() refresh
                    # before their renames).  Touching src is safe
                    # under contention: whoever wins the rename gets a fresh
                    # claim timestamp either way.
                    self.fs.utime(src)
                    self.fs.crashpoint("after_claim_utime_before_rename")
                    self.fs.rename(src, dst)  # the CAS: exactly one winner
                _common.with_retries(claim, label="reserve claim")
            except FileNotFoundError:
                continue  # another worker won this job
            except OSError:
                continue  # transient blip outlasted the retries; if the
                # rename did land server-side the claim sits in running/
                # with a fresh mtime and the reaper recycles it later --
                # delayed, never lost
            doc["state"] = JOB_STATE_RUNNING
            doc["owner"] = owner
            doc["book_time"] = coarse_utcnow()
            # unique claim token: lost-claim detection at completion
            # time must distinguish *this* reservation from a
            # reaped-and-re-claimed one, even when both claimants share
            # an owner string (two worker threads in one process)
            doc["claim"] = uuid.uuid4().hex
            self.fs.crashpoint("after_claim_rename_before_write")
            _common.with_retries(
                lambda: _write_atomic(dst, doc, fs=self.fs),
                label="reserve write",
            )
            return doc
        return None

    def _already_done(self, name):
        """Whether a valid DONE doc exists for ``name``.  Transient
        read failures are retried; if they persist, the OSError
        propagates so each caller can fail toward ITS safe side
        (reserve/reap skip the entry for this pass)."""
        try:
            _common.with_retries(
                lambda: _read_json(self._p("done", name), fs=self.fs),
                label="done check",
            )
            return True
        except (FileNotFoundError, json.JSONDecodeError):
            return False

    def unreserve(self, doc):
        """Return a reserved job to NEW (the reap transition) -- used by
        a worker that cannot process it.  One atomic rename, content
        untouched: the directory is the state (``refresh`` reads only
        done/, ``reserve`` normalizes the doc when it claims).  The
        mtime is refreshed first so the job does not reappear in new/
        already looking reap-stale."""
        name = f"{doc['tid']}.json"
        path = self._p("running", name)

        def give_back():
            self.fs.utime(path)
            self.fs.crashpoint("after_unreserve_utime_before_rename")
            self.fs.rename(path, self._p("new", name))

        try:
            _common.with_retries(give_back, label="unreserve")
        except FileNotFoundError:
            pass  # completed or reaped underneath us

    def claim_is_live(self, doc):
        """Whether ``doc``'s reservation still belongs to its claimant:
        the running file exists and carries the same claim token.  A
        False answer means the claim was reaped (and possibly handed to
        a re-run) -- the claimant must not publish."""
        path = self._p("running", f"{doc['tid']}.json")
        try:
            current = _common.with_retries(
                lambda: _read_json(path, fs=self.fs), label="claim check"
            )
        except FileNotFoundError:
            return False
        except (OSError, json.JSONDecodeError):
            # unreadable after retries: cannot prove the claim lost, and
            # a decode error here can only be a reaped-then-mid-rewrite
            # race; err toward keeping the result unless DONE exists
            try:
                return not self._already_done(f"{doc['tid']}.json")
            except OSError:
                return True  # doubly ambiguous: publishing (at worst an
                # overwrite with an equivalent doc) beats losing a result
        token = doc.get("claim")
        return token is None or current.get("claim") == token

    def complete(self, doc, require_claim=False):
        """Publish a finished (DONE or ERROR) doc and release the claim.

        With ``require_claim=True`` the publish happens only if the
        reservation is still this claimant's (:meth:`claim_is_live`);
        returns False -- publishing nothing -- when the claim was
        reaped mid-evaluation, so a stale worker cannot race the job's
        re-run into a duplicate DONE doc."""
        if require_claim and not self.claim_is_live(doc):
            return False
        doc["refresh_time"] = coarse_utcnow()
        _common.with_retries(
            lambda: _write_atomic(
                self._p("done", f"{doc['tid']}.json"), doc, fs=self.fs,
                crash_before_rename="after_done_tmp_before_rename",
            ),
            label="complete publish",
        )
        self.fs.crashpoint("after_done_rename_before_unlink")
        try:
            _common.with_retries(
                lambda: self.fs.unlink(self._p("running", f"{doc['tid']}.json")),
                label="complete release",
            )
        except (FileNotFoundError, OSError):
            pass  # reaped underneath us, or a blip outlasted the
            # retries -- either way reap() releases DONE-backed claims
        return True

    def reap(self, reserve_timeout):
        """Return RUNNING jobs older than reserve_timeout to NEW (crashed
        or wedged workers lose their claim).  A stale claim whose DONE
        doc is already published is *released* instead of recycled: the
        worker died between publishing and releasing, and re-running it
        would duplicate the DONE doc."""
        if reserve_timeout is None:
            return 0
        now = time.time()
        reaped = 0
        try:
            names = _common.with_retries(
                lambda: self.fs.listdir(self._p("running")), label="reap scan"
            )
        except OSError:
            return 0  # transient blip outlasted the retries: reaping is
            # periodic, the next cycle sees the same stale claims
        for name in names:
            if not name.endswith(".json"):
                continue
            path = self._p("running", name)
            try:
                age = now - _common.with_retries(
                    lambda: self.fs.getmtime(path), label="reap stat"
                )
            except (FileNotFoundError, OSError):
                continue
            if age < reserve_timeout:
                continue
            try:
                _common.with_retries(
                    lambda: _read_json(path, fs=self.fs), label="reap read"
                )  # validity gate: don't recycle a
                # mid-write/truncated claim into unreservable garbage
            except (FileNotFoundError, json.JSONDecodeError, OSError):
                continue
            try:
                already_done = self._already_done(name)
            except OSError:
                continue  # undecidable this cycle; reaping is periodic
            if already_done:
                # the claimant crashed AFTER publishing its DONE doc but
                # before releasing the claim: finish the release for it
                try:
                    _common.with_retries(
                        lambda: self.fs.unlink(path), label="reap release"
                    )
                    logger.warning(
                        "released completed stale claim %s (age %.0fs)",
                        name, age,
                    )
                except (FileNotFoundError, OSError):
                    pass
                continue
            try:
                def recycle():
                    # refresh the mtime BEFORE the rename: the recycled job
                    # must not reappear in new/ still carrying its expired
                    # timestamp, or the next reserver's claim would be
                    # instantly reap-stale (a second reaper could recycle
                    # the LIVE claim mid-reservation -- duplicated job).
                    # Then ONE atomic rename, no content rewrite: the
                    # directory IS the state (refresh reads only done/;
                    # reserve normalizes state/owner/book_time when it
                    # claims), and a rewrite here could race a reserver
                    # into a duplicate or recreate a completed job's file
                    self.fs.utime(path)
                    self.fs.crashpoint("after_reap_utime_before_rename")
                    self.fs.rename(path, self._p("new", name))
                _common.with_retries(recycle, label="reap recycle")
            except (FileNotFoundError, OSError):
                continue
            reaped += 1
            logger.warning("reaped stale job %s (age %.0fs)", name, age)
        return reaped


class FileTrials(Trials):
    """Async Trials over a :class:`FileJobQueue` directory::

        trials = FileTrials("/shared/exp1", exp_key="exp1")
        fmin(fn, space, algo=tpe.suggest, max_evals=500, trials=trials)

    while N workers run ``hyperopt-tpu-torch-worker --dir /shared/exp1``.
    """

    asynchronous = True

    def __init__(self, dirpath, exp_key=None, reserve_timeout=120.0,
                 refresh=True, fs=None):
        self.queue = FileJobQueue(dirpath, fs=fs)
        self.reserve_timeout = reserve_timeout
        super().__init__(exp_key=exp_key, refresh=False)
        self.attachments = self.queue.attachments
        if refresh:
            self.refresh()

    def _insert_trial_docs(self, docs):
        tids = super()._insert_trial_docs(docs)
        for doc in docs:
            self.queue.publish(doc)
        return tids

    def refresh(self):
        done = self.queue.done_docs()
        for trial in self._dynamic_trials:
            upd = done.get(trial["tid"])
            if upd is not None and trial["state"] not in (
                JOB_STATE_DONE, JOB_STATE_ERROR,
            ):
                trial.update(upd)
        self.queue.reap(self.reserve_timeout)
        super().refresh()

    def count_by_state_unsynced(self, arg):
        self.refresh()
        return super().count_by_state_unsynced(arg)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["queue"] = self.queue.root
        state["attachments"] = None
        return state

    def __setstate__(self, state):
        root = state.pop("queue")
        self.__dict__.update(state)
        self.queue = FileJobQueue(root)
        self.attachments = self.queue.attachments


def worker_owner():
    return f"{socket.gethostname()}:{os.getpid()}"
