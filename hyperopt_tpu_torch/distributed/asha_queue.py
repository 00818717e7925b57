"""ASHA over the job queues: the asynchronous scheduler driving the
asynchronous execution backends (the port of
:mod:`hyperopt_tpu.distributed.asha_queue`).

* The DRIVER runs :func:`hyperopt_tpu_torch.hyperband.asha`, its rung-0
  asks on the domain's device; each in-flight slot publishes one
  ``(config, budget)`` job and blocks until that job's result appears,
  so promotion never waits for a rung barrier, as in-process ASHA.
* ``hyperopt-tpu-torch-worker`` processes (any number, on any host that
  shares the mount) reserve jobs by the queue's atomic rename and
  evaluate them through the pickled :class:`BudgetedDomainFn` domain,
  which hands the objective the trial's ``budget`` beside its config.
* Crashed workers are reaped by mtime (``reserve_timeout``) and their
  jobs reserved again; a worker's ERROR doc records as a failed
  evaluation that can never promote.

``asha(checkpoint=...)`` composes: the scheduler snapshot lives with the
driver, the queue directory is the transport record.  :func:`asha_mongo`
is the same split over the MongoDB protocol and :func:`asha_spark` runs
each evaluation as a one-task Spark job; the first two share
:class:`_TransportDriver` (tid namespacing, proportional-backoff polling,
rate-limited reaping, a timeout as a failed trial).
"""

from __future__ import annotations

import itertools
import logging
import os
import pickle
import threading
import time
import uuid

from ..base import Domain, JOB_STATE_DONE, JOB_STATE_NEW, SONify, STATUS_OK
from ..obs.registry import CounterAttr, MetricsRegistry
from . import _common
from .filequeue import FileJobQueue, _read_json

logger = logging.getLogger(__name__)

__all__ = ["BudgetedDomainFn", "asha_filequeue", "asha_mongo", "asha_spark"]


class BudgetedDomainFn:
    """Picklable worker-side objective adapter: evaluates a budget-aware
    ``fn(config, budget)`` from a queued trial doc.

    Shipped to workers inside the pickled ``Domain`` (so ``fn`` must be
    picklable).  Uses the ``pass_expr_memo_ctrl`` seam: the ``Ctrl``'s
    current trial doc carries the rung budget in ``misc["budget"]``, and
    the config is recovered by evaluating the space expression under the
    doc's parameter memo, as ``space_eval`` decodes it.
    """

    fmin_pass_expr_memo_ctrl = True

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, expr, memo, ctrl):
        from ..pyll.base import rec_eval

        budget = ctrl.current_trial["misc"]["budget"]
        cfg = rec_eval(expr, memo=memo)
        return self.fn(cfg, budget)


def asha_filequeue(
    fn,
    space,
    max_budget,
    dirpath,
    eta=3,
    min_budget=1,
    max_jobs=81,
    inflight=8,
    algo=None,
    trials=None,
    rstate=None,
    checkpoint=None,
    checkpoint_every=1,
    exp_key=None,
    poll_interval=0.05,
    eval_timeout=None,
    reserve_timeout=120.0,
    fs=None,
    device=None,
):
    """Run ASHA with evaluations farmed to ``hyperopt-tpu-torch-worker``
    processes over a :class:`FileJobQueue` directory.

    Args are :func:`hyperopt_tpu_torch.hyperband.asha`'s (``device``, None
    = the card, is where the rung-0 asks compute), plus:

      dirpath: the queue directory workers serve (``python -m
        hyperopt_tpu_torch.distributed.worker --dir DIR``).  The budget-aware
        ``Domain`` is (re)published to its attachments at entry.
      fs: injectable filesystem seam for the DRIVER side (see
        :mod:`.faults`); None uses the real ``os``.  Workers inject
        their own.
      inflight: concurrent jobs in the queue (the driver's slot count;
        actual parallelism is however many workers serve the mount).
      poll_interval: driver's BASE done-file poll cadence per slot;
        each slot backs off proportionally to its job's elapsed time
        (~10%, capped at >= 1 s), so short jobs are detected within
        ~poll_interval while long evaluations do not hammer the mount.
      eval_timeout: per-evaluation wall-clock bound; an expired job
        records as a failed evaluation (it keeps its queue files for
        post-mortem, but can never promote).
      reserve_timeout: stale-claim reaping age, as in the worker CLI --
        the driver reaps while polling, so a crashed worker's job
        returns to ``new/`` even if every other worker is busy.

    Returns the :func:`hyperband.asha` result dict; the scheduler's
    trial store is driver-side, the queue directory holds the transport
    record (every job's doc with owner/timings/tracebacks).
    """
    _reject_queue_backed_trials(trials, "asha_filequeue")
    queue = FileJobQueue(dirpath, fs=fs)
    # per-run attachment key: a queue directory shared with a live fmin
    # (or a previous asha run) keeps every driver's Domain intact --
    # each job doc's cmd names the one to evaluate with
    attachment_key = f"FMinIter_Domain.asha-{uuid.uuid4().hex[:8]}"
    domain = Domain(BudgetedDomainFn(fn), space, device=device)
    queue.attachments[attachment_key] = pickle.dumps(domain)

    def fetch(tid):
        done_path = os.path.join(queue.root, "done", f"{tid}.json")
        try:
            if not queue.fs.exists(done_path):
                return None
            return _read_json(done_path, fs=queue.fs)
        except (ValueError, OSError):
            return None  # mid-write on a non-atomic FS, or a transient
            # mount blip: retry next poll, but the driver's deadline
            # check still runs -- a file left permanently truncated by
            # a killed worker must not bypass eval_timeout

    transport = _TransportDriver(
        publish=queue.publish,
        fetch=fetch,
        reap=queue.reap,
        exp_key=exp_key,
        poll_interval=poll_interval,
        eval_timeout=eval_timeout,
        reserve_timeout=reserve_timeout,
        attachment_key=attachment_key,
    )
    try:
        return _run_asha(
            transport.evaluator, fn, space, max_budget, eta, min_budget,
            max_jobs, inflight, algo, trials, rstate, checkpoint,
            checkpoint_every, device,
        )
    finally:
        _cleanup_attachment(
            transport, lambda: queue.attachments.__delitem__(attachment_key)
        )


def _cleanup_attachment(transport, delete):
    """Run-scoped Domain blobs must not accumulate forever (one per
    asha run on a shared queue/database) -- delete on the way out,
    UNLESS any of this run's jobs may still be evaluated later: a
    timed-out job's queue entry, or jobs left published-but-uncollected
    by an aborted driver.  Deleting under those would turn them into
    dangling-attachment poison pills; such runs keep their blob."""
    if transport.expired or transport.collected < transport.published:
        logger.warning(
            "keeping Domain attachment %s: %d timed-out and %d "
            "uncollected job(s) may still be evaluated",
            transport.attachment_key, transport.expired,
            transport.published - transport.collected,
        )
        return
    try:
        delete()
    except KeyError:
        pass
    except Exception as e:  # graftlint: disable=GL302 cleanup must never mask the run's result
        logger.warning(
            "could not delete Domain attachment %s: %s",
            transport.attachment_key, e,
        )


def _reject_queue_backed_trials(trials, caller):
    """Both drivers need an IN-MEMORY scheduler store: an asynchronous
    Trials (FileTrials, MongoTrials, ThreadTrials, SparkTrials -- every
    store whose insert publishes or evaluates docs marks itself
    ``asynchronous``) would re-process each scheduler-recorded doc as a
    job, and workers would churn on budget-less garbage."""
    if trials is not None and getattr(trials, "asynchronous", False):
        raise ValueError(
            f"{caller} needs an in-memory Trials (or None) for trials=; "
            "queue-backed stores re-publish recorded docs as jobs"
        )


def _run_asha(evaluator, fn, space, max_budget, eta, min_budget,
              max_jobs, inflight, algo, trials, rstate, checkpoint,
              checkpoint_every, device):
    """One shared asha() invocation for every transport driver -- a new
    asha parameter threads through here once, not per transport."""
    from ..hyperband import asha

    return asha(
        fn,
        space,
        max_budget,
        eta=eta,
        min_budget=min_budget,
        max_jobs=max_jobs,
        workers=inflight,
        algo=algo,
        trials=trials,
        rstate=rstate,
        checkpoint=checkpoint,
        checkpoint_every=checkpoint_every,
        evaluator=evaluator,
        device=device,
    )


class _TransportDriver:
    """Driver-side transport shared by the filequeue and Mongo ASHA
    drivers: per-run tid namespacing (a resumed driver must never
    collide with a killed run's leftover jobs), trial-doc building,
    result polling with proportional backoff, and rate-limited reaping.

    ``publish(doc)`` enqueues a NEW job doc; ``fetch(tid)`` returns the
    completed doc (state DONE or ERROR) or None while in flight --
    transient read failures should surface as None so the deadline
    check still runs; ``reap(reserve_timeout)`` recycles stale claims.
    """

    # publish/collect/expire accounting (asha_filequeue's cleanup
    # decision and its uncollected-jobs warning read these)
    published = CounterAttr(
        "asha_published_total", "jobs enqueued by this run")
    collected = CounterAttr(
        "asha_collected_total", "completed job docs collected")
    expired = CounterAttr(
        "asha_expired_total",
        "jobs that outran eval_timeout (may still be evaluated later)")

    def __init__(self, publish, fetch, reap, exp_key, poll_interval,
                 eval_timeout, reserve_timeout,
                 attachment_key="FMinIter_Domain"):
        self.metrics = MetricsRegistry("asha_queue")
        self._publish = publish
        self._fetch = fetch
        self._reap = reap
        self.exp_key = exp_key
        self.attachment_key = attachment_key
        self.poll_interval = float(poll_interval)
        self.eval_timeout = eval_timeout
        self.reserve_timeout = reserve_timeout
        self._run_tag = uuid.uuid4().hex[:8]
        self._counter = itertools.count()
        self._lock = threading.Lock()
        # reaping only matters on the reserve_timeout scale; one shared
        # rate limit keeps the polling slots from issuing full queue
        # scans every tick on a network mount / remote database
        self._reap_period = max(1.0, float(reserve_timeout or 0) / 10.0)
        self._last_reap = 0.0

    def _maybe_reap(self):
        with self._lock:
            now = time.monotonic()
            if now - self._last_reap < self._reap_period:
                return
            self._last_reap = now
        try:
            self._reap(self.reserve_timeout)
        except Exception as e:
            # reaping is periodic best-effort: a transient transport
            # failure that outlives the backend's own retries must not
            # kill a polling slot (and with it the whole run) -- the
            # next reap cycle sees the same stale claims.  Anything
            # non-transient is a real bug and surfaces.
            if not _common.is_transient(e):
                raise
            logger.warning("reap cycle skipped on transient failure: %s", e)

    def evaluator(self, vals, cfg, budget):
        """The :func:`hyperband.asha` ``evaluator=`` seam: one queued
        job per call, blocking until its result lands (or expires).
        ``cfg`` (the decoded config) is unused here -- workers decode
        from the doc's index-form vals themselves."""
        del cfg
        with self._lock:
            tid = f"{self._run_tag}-{next(self._counter)}"
            self.published += 1
        self._publish({
            "tid": tid,
            "state": JOB_STATE_NEW,
            "spec": None,
            "result": {"status": "new"},
            "misc": {
                "tid": tid,
                # the doc NAMES its Domain attachment (the reference's
                # cmd contract): drivers with different objectives can
                # share one queue/database without clobbering each other
                "cmd": ("domain_attachment", self.attachment_key),
                "workdir": None,
                "idxs": {k: [tid] for k in vals},
                # SONify: doc vals may be numpy scalars/0-d arrays and
                # transports serialize docs (JSON files / BSON)
                "vals": SONify({k: [v] for k, v in vals.items()}),
                "budget": SONify(budget),
            },
            "exp_key": self.exp_key,
            "owner": None,
            "version": 0,
            "book_time": None,
            "refresh_time": None,
        })
        deadline = (
            None if self.eval_timeout is None
            else time.monotonic() + self.eval_timeout
        )
        # proportional backoff per slot: poll at ~10% of the job's
        # elapsed time, floored at the responsive base cadence and
        # capped at 1 Hz -- short evaluations pay ~poll_interval of
        # detection latency while long (training-scale) ones stop
        # hammering the transport (total polls grow logarithmically,
        # then linearly at 1/s)
        published = time.monotonic()
        while True:
            out = self._fetch(tid)
            if out is not None:
                with self._lock:
                    self.collected += 1
                result = out.get("result") or {}
                if (
                    out.get("state") == JOB_STATE_DONE
                    and result.get("status") == STATUS_OK
                ):
                    return float(result["loss"])
                logger.warning(
                    "queued asha job %s failed: %s", tid,
                    (out.get("misc") or {}).get("error"),
                )
                return float("nan")
            if deadline is not None and time.monotonic() > deadline:
                logger.warning("queued asha job %s timed out", tid)
                with self._lock:
                    self.expired += 1
                return float("nan")
            self._maybe_reap()
            elapsed = time.monotonic() - published
            time.sleep(min(
                max(self.poll_interval, 0.1 * elapsed),
                max(self.poll_interval, 1.0),
            ))


def asha_mongo(
    fn,
    space,
    max_budget,
    mongo,
    eta=3,
    min_budget=1,
    max_jobs=81,
    inflight=8,
    algo=None,
    trials=None,
    rstate=None,
    checkpoint=None,
    checkpoint_every=1,
    exp_key=None,
    poll_interval=0.05,
    eval_timeout=None,
    reserve_timeout=120.0,
    device=None,
):
    """Run ASHA with evaluations farmed to
    ``hyperopt-tpu-torch-mongo-worker`` processes over the MongoDB
    protocol: the same driver/worker split as :func:`asha_filequeue`
    (CAS reservation by ``find_one_and_update``, GridFS Domain shipping).

    ``mongo`` is a connection string (``host:port/db``) or a live
    ``MongoJobs``.  The budget-aware ``Domain`` is (re)published to
    GridFS at entry; completed jobs are polled with ``find_one`` by
    tid.  All other args as :func:`asha_filequeue`.
    """
    from ..base import JOB_STATE_ERROR
    from .mongo import MongoJobs

    _reject_queue_backed_trials(trials, "asha_mongo")
    jobs = (
        mongo if isinstance(mongo, MongoJobs)
        else MongoJobs.new_from_connection_str(mongo)
    )
    try:
        # each poll is a find_one({tid, state}); on a real mongod only
        # _id is indexed by default, so every poll (and reserve's tid
        # sort) would scan the collection.  Doubles without
        # create_index just skip this.
        jobs.coll.create_index([("tid", 1), ("state", 1)])
    except AttributeError:
        pass
    # per-run attachment key (see asha_filequeue): a shared database's
    # concurrent fmin keeps ITS Domain; docs name which one to load
    attachment_key = f"FMinIter_Domain.asha-{uuid.uuid4().hex[:8]}"
    domain = Domain(BudgetedDomainFn(fn), space, device=device)
    jobs.set_attachment(attachment_key, pickle.dumps(domain))

    def fetch(tid):
        return jobs.coll.find_one({
            "tid": tid,
            "state": {"$in": [JOB_STATE_DONE, JOB_STATE_ERROR]},
        })

    transport = _TransportDriver(
        publish=jobs.publish,
        fetch=fetch,
        reap=jobs.reap,
        exp_key=exp_key,
        poll_interval=poll_interval,
        eval_timeout=eval_timeout,
        reserve_timeout=reserve_timeout,
        attachment_key=attachment_key,
    )
    try:
        return _run_asha(
            transport.evaluator, fn, space, max_budget, eta, min_budget,
            max_jobs, inflight, algo, trials, rstate, checkpoint,
            checkpoint_every, device,
        )
    finally:
        _cleanup_attachment(
            transport, lambda: jobs.delete_attachment(attachment_key)
        )


def asha_spark(
    fn,
    space,
    max_budget,
    spark=None,
    eta=3,
    min_budget=1,
    max_jobs=81,
    inflight=4,
    algo=None,
    trials=None,
    rstate=None,
    checkpoint=None,
    checkpoint_every=1,
    device=None,
):
    """Run ASHA with each evaluation dispatched as a 1-task Spark job --
    the :class:`~.spark.SparkTrials` execution model driven by the async
    scheduler.  Each in-flight slot submits
    ``fn(config, budget)`` through ``sc.parallelize([...], 1)`` under
    its own job group and blocks on ``collect``; promotion decisions
    never wait at a rung barrier, and up to ``inflight`` Spark jobs run
    concurrently (cluster parallelism is Spark's to schedule).

    Args as :func:`hyperband.asha` (``device`` included), plus ``spark``:
    a ``SparkSession``
    (default ``SparkSession.builder.getOrCreate()``).  ``fn`` ships to
    executors via Spark's closure serialization, the same contract as
    ``SparkTrials`` objectives; a task exception records as a failed
    evaluation that can never promote.  There is no ``eval_timeout``
    here -- bound task time with Spark's own scheduler configs, as the
    reference's SparkTrials users do.
    """
    from .spark import _require_pyspark, submit_one_task

    _reject_queue_backed_trials(trials, "asha_spark")
    if spark is None:
        pyspark = _require_pyspark()  # curated error names alternatives
        spark = pyspark.sql.SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    run_tag = uuid.uuid4().hex[:8]
    counter = itertools.count()
    counter_lock = threading.Lock()

    def evaluator(vals, cfg, budget):
        del vals  # the decoded cfg ships in the task closure
        with counter_lock:
            i = next(counter)

        def task(_):
            return fn(cfg, budget)

        # per-evaluation job group (observable in the Spark UI;
        # reliably cancellable under pinned threads -- see
        # submit_one_task), through the dispatch SparkTrials shares
        return submit_one_task(
            sc, task, f"hyperopt_tpu-asha-{run_tag}-{i}",
            f"asha eval {i} (budget {budget})",
        )  # float or {"loss": ...}; asha normalizes

    return _run_asha(
        evaluator, fn, space, max_budget, eta, min_budget, max_jobs,
        inflight, algo, trials, rstate, checkpoint, checkpoint_every, device,
    )
