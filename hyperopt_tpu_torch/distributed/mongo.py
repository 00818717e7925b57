"""MongoTrials: hyperopt's MongoDB work-queue protocol (the port of
:mod:`hyperopt_tpu.distributed.mongo`).

The trials collection is the queue: atomic NEW -> RUNNING reservation by
a compare-and-swap ``find_one_and_update``, the pickled Domain in GridFS,
DONE/ERROR write-back, reserve-timeout reaping and ``exp_key``
namespacing.  Requires ``pymongo`` (import-gated);
:class:`hyperopt_tpu_torch.distributed.FileTrials` plays the same role on
a shared filesystem without it.  The tests run this module's protocol
code against the in-memory doubles of ``tests/fake_backends.py``.
"""

from __future__ import annotations

import logging
import pickle
import uuid

from ..base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    SONify,
    Trials,
    spec_from_misc,
)
from ..utils import coarse_utcnow
from . import _common

logger = logging.getLogger(__name__)

__all__ = ["MongoTrials", "MongoJobs", "MongoWorker", "as_mongo_str", "main_worker"]


def _require_pymongo():
    try:
        import pymongo  # noqa: F401
        import gridfs  # noqa: F401

        return pymongo
    except ImportError as e:
        raise ImportError(
            "MongoTrials requires pymongo, which is not installed in this "
            "environment. Use hyperopt_tpu_torch.distributed.FileTrials (a "
            "shared-filesystem queue) for distributed evaluation."
        ) from e


def as_mongo_str(host_port_db):
    """'host:port/dbname' -> mongodb:// connection string."""
    if host_port_db.startswith("mongodb://"):
        return host_port_db
    return f"mongodb://{host_port_db}"


class MongoJobs:
    """Thin collection wrapper: publish / reserve (CAS) / complete / reap."""

    def __init__(self, db, jobs_collection="jobs"):
        _require_pymongo()
        self.db = db
        self.coll = db[jobs_collection]
        import gridfs

        self.gfs = gridfs.GridFS(db, collection="fs")

    @classmethod
    def new_from_connection_str(cls, conn_str, dbname=None):
        pymongo = _require_pymongo()
        conn_str = as_mongo_str(conn_str)
        if dbname is None:
            dbname = conn_str.rsplit("/", 1)[-1]
            conn_str = conn_str.rsplit("/", 1)[0]
        client = pymongo.MongoClient(conn_str)
        return cls(client[dbname])

    def publish(self, doc):
        doc = SONify(doc)
        _common.with_retries(
            lambda: self.coll.insert_one(doc), label="mongo publish"
        )
        return doc

    def reserve(self, owner, exp_key=None, exclude_tids=()):
        """The CAS: atomically flip one NEW job to RUNNING with our owner.

        Ordered by ``_id`` (insertion order), NOT by tid: BSON sorts all
        numbers before all strings, so a tid sort would starve
        ``asha_mongo``'s string tids ('<runtag>-<n>') behind any
        concurrent fmin's numeric tids on a shared collection.  ``_id`` is type-neutral and insertion-ordered for both the
        real ObjectId and the test doubles' counters; for a single
        driver publishing in tid order the two orderings coincide.

        ``exclude_tids`` lets a worker skip jobs it has already proven
        it cannot process (e.g. a dangling Domain attachment) -- without
        it, the stable ordering would hand the same poisoned job back
        on every iteration and starve everything behind it."""
        query = {"state": JOB_STATE_NEW}
        if exp_key is not None:
            query["exp_key"] = exp_key
        if exclude_tids:
            query["tid"] = {"$nin": list(exclude_tids)}
        # unique claim token: completion-time lost-claim detection must
        # distinguish THIS reservation from a reaped-and-re-claimed one
        # even when both claimants share an owner string
        token = uuid.uuid4().hex
        return _common.with_retries(
            lambda: self.coll.find_one_and_update(
                query,
                {
                    "$set": {
                        "state": JOB_STATE_RUNNING,
                        "owner": owner,
                        "book_time": coarse_utcnow(),
                        "claim": token,
                    }
                },
                sort=[("_id", 1)],
                return_document=True,
            ),
            label="mongo reserve",
        )

    def complete(self, doc, result=None, error=None, require_claim=False):
        """Write the finished state back.  With ``require_claim=True``
        the writeback is a CAS on the reservation's claim token: it
        succeeds (returns True) only if the job is still RUNNING under
        THIS claim -- a job reaped (and possibly re-run) mid-evaluation
        matches nothing, returns False, and the stale worker's result
        is dropped instead of racing the re-run into a duplicate DONE
        doc."""
        update = {"refresh_time": coarse_utcnow()}
        if error is not None:
            update["state"] = JOB_STATE_ERROR
            update["misc.error"] = error
        else:
            update["state"] = JOB_STATE_DONE
            update["result"] = SONify(result)
        query = {"_id": doc["_id"]}
        if require_claim:
            query["state"] = JOB_STATE_RUNNING
            query["claim"] = doc.get("claim")
        res = _common.with_retries(
            lambda: self.coll.update_one(query, {"$set": update}),
            label="mongo complete",
        )
        return res.matched_count == 1

    def unreserve(self, doc):
        """Return a reserved job to NEW (the reap transition) -- used by
        a worker that cannot process it; the queue owns this state
        machine so reap/give-back semantics cannot drift apart."""
        _common.with_retries(
            lambda: self.coll.update_one(
                {"_id": doc["_id"]},
                {"$set": {"state": JOB_STATE_NEW, "owner": None,
                          "book_time": None, "claim": None}},
            ),
            label="mongo unreserve",
        )

    def reap(self, reserve_timeout):
        if reserve_timeout is None:
            return 0
        import datetime

        cutoff = coarse_utcnow() - datetime.timedelta(seconds=reserve_timeout)
        res = _common.with_retries(
            lambda: self.coll.update_many(
                {"state": JOB_STATE_RUNNING, "book_time": {"$lt": cutoff}},
                {"$set": {"state": JOB_STATE_NEW, "owner": None,
                          "book_time": None, "claim": None}},
            ),
            label="mongo reap",
        )
        return res.modified_count

    # attachments (GridFS) --------------------------------------------------
    def _newest_file(self, key):
        """Newest GridFS file for ``key``: real gridfs ``find_one`` has
        NO ordering guarantee (natural order -- oldest first in
        practice), so a replacement must be looked up via
        ``get_last_version``; the in-memory double only has a
        newest-first ``find_one``."""
        try:
            return self.gfs.get_last_version(key)
        except AttributeError:  # double without get_last_version
            return self.gfs.find_one({"filename": key})
        except KeyError:  # the double's stand-in for NoFile
            return None
        except Exception as e:
            # ONLY gridfs.NoFile means "missing"; a connection error
            # must surface as itself, not masquerade as deleted data
            # (callers put tids on cooldown / raise KeyError for None)
            if type(e).__name__ == "NoFile":
                return None
            raise

    def set_attachment(self, key, blob):
        # put-then-sweep: the replacement window must never be EMPTY (a
        # worker loading the Domain mid-republish would fail on a
        # healthy queue); afterwards every file under the name EXCEPT
        # the new one is deleted, so a crash between put and sweep
        # leaves duplicates a later set_attachment cleans up, and
        # readers (newest-first) converge immediately either way
        new_id = self.gfs.put(blob, filename=key)
        for obj in self.gfs.find({"filename": key}):
            # sweep only files OLDER than ours (_ids are time-ordered):
            # two concurrent writers must not delete each other's new
            # file and leave the key empty -- the newest always survives
            if obj._id != new_id and obj._id < new_id:
                self.gfs.delete(obj._id)

    def get_attachment(self, key):
        obj = self._newest_file(key)
        if obj is None:
            raise KeyError(key)
        return obj.read()

    def delete_attachment(self, key):
        """Remove every GridFS file under ``key`` (run-scoped Domain
        cleanup); missing keys are a no-op."""
        for obj in self.gfs.find({"filename": key}):
            self.gfs.delete(obj._id)

    def has_attachment(self, key):
        return self.gfs.find_one({"filename": key}) is not None


class _GfsAttachments:
    def __init__(self, jobs):
        self.jobs = jobs

    def __contains__(self, key):
        return self.jobs.has_attachment(key)

    def __getitem__(self, key):
        return self.jobs.get_attachment(key)

    def __setitem__(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        self.jobs.set_attachment(key, value)


class MongoTrials(Trials):
    """Async Trials over a MongoDB jobs collection (reference-compatible
    ``MongoTrials('mongo://host:port/db/jobs', exp_key=...)`` shape)."""

    asynchronous = True

    def __init__(self, arg, exp_key=None, refresh=True, reserve_timeout=None):
        _require_pymongo()
        if isinstance(arg, MongoJobs):
            self.handle = arg
        else:
            conn = str(arg)
            for prefix in ("mongo://", "mongodb://"):
                if conn.startswith(prefix):
                    conn = conn[len(prefix):]
            conn = conn.rstrip("/")
            if conn.endswith("/jobs"):
                conn = conn[: -len("/jobs")]
            self.handle = MongoJobs.new_from_connection_str(conn)
        self.reserve_timeout = reserve_timeout
        super().__init__(exp_key=exp_key, refresh=False)
        self.attachments = _GfsAttachments(self.handle)
        if refresh:
            self.refresh()

    def _insert_trial_docs(self, docs):
        for doc in docs:
            self.handle.publish(doc)
        return [d["tid"] for d in docs]

    def refresh(self):
        query = {} if self._exp_key is None else {"exp_key": self._exp_key}
        docs = list(_common.with_retries(
            lambda: self.handle.coll.find(query, sort=[("tid", 1)]),
            label="mongo refresh",
        ))
        for d in docs:
            d.pop("_id", None)
        self._dynamic_trials = docs
        if self.reserve_timeout:
            self.handle.reap(self.reserve_timeout)
        super().refresh()

    def new_trial_ids(self, n):
        # ids must be unique across every driver using the collection.
        # Max over NUMERIC tids only, server-side: asha_mongo's
        # transport jobs carry string tids ("<runtag>-<n>"), which BSON
        # sorts above every number -- an unfiltered sort would hand
        # back a string and `+ 1` would crash on a legitimately shared
        # db.  The $type filter keeps this one indexed find_one instead
        # of an O(collection) client-side scan.
        last = self.handle.coll.find_one(
            {"tid": {"$type": "number"}}, sort=[("tid", -1)]
        )
        base = (int(last["tid"]) + 1) if last else 0
        local_floor = max(self._ids, default=-1) + 1
        start = max(base, local_floor)
        rval = list(range(start, start + n))
        self._ids.update(rval)
        return rval

    def delete_all(self):
        query = {} if self._exp_key is None else {"exp_key": self._exp_key}
        self.handle.coll.delete_many(query)
        super().delete_all()


class MongoWorker:
    """Evaluate reserved jobs (the ``hyperopt-mongo-worker`` role)."""

    def __init__(self, jobs, exp_key=None, workdir=None, heartbeat=None):
        self.jobs = jobs
        self.exp_key = exp_key
        self.workdir = workdir
        self.heartbeat = heartbeat
        import collections

        # attachment key -> (gridfs _id, Domain); identity-validated
        # LRU (shared contract with the filequeue worker, _common)
        self._domains = collections.OrderedDict()
        # poisoned-job cooldown (shared TTLSet contract): a tid whose
        # Domain failed to load is excluded from this worker's
        # reservations for the TTL, then retried -- neither a livelock
        # on the lowest tid nor a permanent exclusion on a transient
        # failure
        self._bad_tids = _common.TTLSet()

    def _load_domain(self, doc):
        # the doc's cmd names its Domain attachment (the reference's
        # contract), so drivers with DIFFERENT objectives can share one
        # database -- asha_mongo publishes under a per-run key and a
        # concurrent fmin's jobs keep resolving their own.  Cache keyed
        # by the GridFS file's _id: a re-publish under the same key
        # (set_attachment puts a NEW file) invalidates, the same
        # contract as the filequeue worker's inode check.
        key = _common.blob_key_from_doc(doc)
        obj = self.jobs._newest_file(key)
        if obj is None:
            raise KeyError(key)
        return _common.lru_get(
            self._domains, key, obj._id, lambda: pickle.loads(obj.read())
        )

    def run_one(self, owner):
        doc = self.jobs.reserve(
            owner, exp_key=self.exp_key,
            exclude_tids=self._bad_tids.current(),
        )
        if doc is None:
            return False
        try:
            domain = self._load_domain(doc)
        except Exception as e:
            # give the job back and surface the error: a worker that
            # cannot load the Domain (version skew, missing attachment)
            # must not mark jobs failed -- healthy workers can run
            # them.  The tid joins this worker's cooldown set so its
            # next reserve moves PAST the poisoned job instead of
            # re-reserving it forever
            self._bad_tids.add(doc.get("tid"))
            self.jobs.unreserve(doc)
            e.failed_tid = doc.get("tid")
            raise
        trials = Trials()
        trials._dynamic_trials.append(doc)
        ctrl = Ctrl(trials, current_trial=doc)

        def _beat():
            # refresh book_time so reapers (driver-side asha_mongo,
            # other workers' reap calls) never recycle a LIVE job whose
            # evaluation outlives reserve_timeout -- the mtime-heartbeat
            # contract of the filequeue worker, via the shared scaffold.
            # CAS on the claim token: a reaped-and-re-claimed job must
            # not have its NEW claimant's book_time refreshed by the old
            # worker, and a matched_count of 0 (claim gone) stops the
            # beat thread cleanly (the scaffold's False contract)
            res = _common.with_retries(
                lambda: self.jobs.coll.update_one(
                    {"_id": doc["_id"], "state": JOB_STATE_RUNNING,
                     "claim": doc.get("claim")},
                    {"$set": {"book_time": coarse_utcnow()}},
                ),
                label="mongo heartbeat",
            )
            return res.matched_count == 1

        with _common.claim_heartbeat(_beat, self.heartbeat):
            try:
                result = domain.evaluate(spec_from_misc(doc["misc"]), ctrl)
            except Exception as e:  # graftlint: disable=GL302 objective errors become ERROR docs
                logger.error("job %s failed: %s", doc.get("tid"), e)
                published = self.jobs.complete(
                    doc, error=(str(type(e)), str(e)), require_claim=True
                )
            else:
                published = self.jobs.complete(
                    doc, result=result, require_claim=True
                )
        if not published:
            # completion-time lost-claim detection (the filequeue
            # worker's contract): the claim was reaped mid-evaluation
            # and the job re-queued -- drop this result rather than
            # racing the re-run into a duplicate DONE doc
            logger.warning(
                "job %s: claim lost mid-evaluation (reaped); dropping "
                "result to defer to the re-run", doc.get("tid"),
            )
        return True


def main_worker(argv=None):
    """CLI: ``hyperopt-tpu-torch-mongo-worker --mongo=host:port/db``."""
    import argparse
    import socket
    import os
    import time

    parser = argparse.ArgumentParser(prog="hyperopt-tpu-torch-mongo-worker")
    parser.add_argument("--mongo", required=True)
    parser.add_argument("--exp-key", default=None)
    parser.add_argument("--max-jobs", type=int, default=None)
    parser.add_argument("--poll-interval", type=float, default=1.0)
    parser.add_argument("--reserve-timeout", type=float, default=120.0)
    parser.add_argument("--workdir", default=None)
    parser.add_argument(
        "--max-crash-loop", type=int, default=5,
        help="consecutive unexpected errors before a loud exit (rc 2)",
    )
    options = parser.parse_args(argv)

    from .worker import GracefulDrain

    jobs = MongoJobs.new_from_connection_str(options.mongo)
    worker = MongoWorker(
        jobs, exp_key=options.exp_key, workdir=options.workdir,
        heartbeat=(
            options.reserve_timeout / 3.0
            if options.reserve_timeout else None
        ),
    )
    owner = f"{socket.gethostname()}:{os.getpid()}"
    drain = GracefulDrain().install()
    n = 0
    consecutive_errors = 0
    while options.max_jobs is None or n < options.max_jobs:
        if drain.requested:
            logger.info("drained after %d job(s), exiting 0", n)
            return 0
        # backoff computed in the handler, slept at loop level on the
        # shared schedule (_common.retry_delay)
        backoff = None
        try:
            jobs.reap(options.reserve_timeout)
            ran = worker.run_one(owner)
        except Exception as e:  # graftlint: disable=GL302 crash-loop guard: bounded backoff, then exit 2
            if getattr(e, "failed_tid", None) is not None:
                # a job naming an unloadable Domain: run_one gave it
                # back and put the tid on cooldown; cool off instead of
                # crash-looping the process on the same lowest-tid doc
                logger.error("job %s returned to queue: %s", e.failed_tid, e)
                consecutive_errors = 0
                backoff = options.poll_interval
            else:
                # crash-loop guard (the filequeue worker's contract):
                # back off on unexpected errors -- an AutoReconnect
                # storm that outlives the per-op retries costs backoff,
                # not the process -- then exit loudly so a supervisor
                # restart loop cannot silently spin forever
                consecutive_errors += 1
                if consecutive_errors >= options.max_crash_loop:
                    logger.critical(
                        "%d consecutive unexpected errors (last: %s); "
                        "exiting loudly", consecutive_errors, e,
                        exc_info=True,
                    )
                    return 2
                logger.error(
                    "unexpected worker error (%d/%d): %s",
                    consecutive_errors, options.max_crash_loop, e,
                )
                backoff = _common.retry_delay(
                    consecutive_errors,
                    base_delay=options.poll_interval, max_delay=2.0,
                )
        if backoff is not None:
            time.sleep(backoff)
            continue
        consecutive_errors = 0
        if ran:
            n += 1
        else:
            time.sleep(options.poll_interval)
    return 0
