"""``hyperopt-tpu-torch-worker``: evaluate queued trials from a FileJobQueue.

The port of :mod:`hyperopt_tpu.distributed.worker` (the worker-process
role of hyperopt's ``hyperopt-mongo-worker``): reserve (the atomic CAS),
unpickle the shipped Domain, evaluate, publish DONE or ERROR, in a loop,
with reserve-timeout reaping, an idle exit, optional workdir isolation
and a max-jobs budget.  A worker never touches the card: the Domain's
``device`` is where the driver suggests, and the objective runs as the
worker's process runs it.  Workers are separate processes (nothing here
forks), so a driver holding a CUDA context can start them.

Hardening: transient mount blips (the ESTALE/EIO class) in reserve,
heartbeat, complete and reap are retried (``_common.with_retries``), and
persistent ones back the loop off instead of crashing it; a crash-loop
guard exits loudly (rc 2) after ``--max-crash-loop`` consecutive
unexpected errors; SIGTERM drains (the in-flight job finishes or is given
back, then the worker exits 0); a job reaped (and perhaps rerun) while
this worker evaluated it is dropped with a warning, never published as a
second DONE doc.

Usage::

    python -m hyperopt_tpu_torch.distributed.worker --dir /shared/exp1 \
        [--exp-key K] [--max-jobs N] [--poll-interval S] \
        [--reserve-timeout S] [--last-job-timeout S] [--workdir D] \
        [--max-crash-loop N]
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import pickle
import signal
import sys
import time
import traceback

from ..base import (
    Ctrl,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    SONify,
    spec_from_misc,
)
from ..utils import working_dir
from . import _common
from .filequeue import FileJobQueue, FileTrials, worker_owner

logger = logging.getLogger(__name__)

__all__ = ["main", "run_one", "WorkerExit", "GracefulDrain"]


class WorkerExit(Exception):
    pass


class GracefulDrain:
    """SIGTERM -> finish (or give back) the in-flight job, then exit 0.

    The handler only flips a flag: evaluation is never interrupted
    mid-flight, so a drained worker leaves either a published result or
    an intact claim for the reaper -- never a half-written doc.
    ``install()`` is a no-op outside the main thread (signal.signal
    would raise), which keeps in-process/threaded harnesses working.
    """

    def __init__(self):
        self.requested = False

    def _handle(self, signum, frame):
        self.requested = True
        logger.info("SIGTERM received: draining (finishing in-flight job)")

    def install(self):
        try:
            signal.signal(signal.SIGTERM, self._handle)
        except ValueError:  # not the main thread
            pass
        return self


def _load_domain(queue, blob_key="FMinIter_Domain",
                 cache=collections.OrderedDict()):
    """``blob_key`` comes from the job doc's cmd (the reference's
    contract): drivers with different objectives (an fmin and an
    asha_filequeue, say) share one queue directory, each doc naming the
    Domain to evaluate with."""
    if blob_key not in queue.attachments:
        raise WorkerExit(
            f"no pickled Domain {blob_key!r} at {queue.root}/attachments -- "
            "is a driver running against this queue?"
        )
    # cache keyed by the attachment file's identity, not forever: a new
    # driver reusing the directory (e.g. asha_filequeue after an fmin
    # run) RE-publishes the Domain, and a long-lived worker must pick
    # the new objective up rather than silently evaluating the stale
    # one.  Every publish is tmp+rename = a NEW inode, so st_ino moves
    # even on mounts with coarse timestamps where two publishes can
    # land inside one mtime tick; mtime+size ride along as backstops.
    path = queue.attachments._path(blob_key)
    try:
        st = _common.with_retries(
            lambda: queue.fs.stat(path), label="domain stat"
        )
    except FileNotFoundError:  # raced a re-publish; next loop retries
        raise WorkerExit(f"domain attachment vanished under {queue.root}")
    ident = (st.st_ino, st.st_mtime_ns, st.st_size)
    return _common.lru_get(
        cache, (queue.root, blob_key), ident,
        lambda: pickle.loads(queue.attachments[blob_key]),
    )


class _ClaimBeat:
    """The heartbeat callable for a filequeue claim: refresh the
    running-file's mtime each tick; stop (return False) and remember
    the loss once the claim is gone (completed/reaped underneath us).
    Transient mount blips (ESTALE/EIO class) are retried by the shared
    scaffold here; if they persist the tick raises, and
    ``claim_heartbeat`` logs it and keeps beating."""

    def __init__(self, path, fs):
        self.path = path
        self.fs = fs
        self.lost = False

    def __call__(self):
        try:
            _common.with_retries(
                lambda: self.fs.utime(self.path), label="claim heartbeat"
            )
            return True
        except FileNotFoundError:
            self.lost = True
            return False


def run_one(queue, owner, exp_key=None, workdir=None, trials=None,
            heartbeat=None, exclude_tids=()):
    """Reserve and evaluate a single job; False if the queue was empty.

    ``heartbeat`` (seconds) keeps the reserved job's claim fresh during
    evaluation -- the worker CLI passes ``reserve_timeout / 3``.  None
    disables it (unit-test mode / instant objectives).  ``exclude_tids``
    skips jobs this worker already failed to load a Domain for (the CLI
    maintains the cooldown set).
    """
    doc = queue.reserve(owner, exp_key=exp_key, exclude_tids=exclude_tids)
    if doc is None:
        return False
    blob_key = _common.blob_key_from_doc(doc)
    try:
        domain = _load_domain(queue, blob_key)
    except Exception as e:
        # give the job back (the reap transition) and surface the
        # error: a worker that cannot load the Domain must neither
        # strand the reserved job in running/ nor mark it failed --
        # another worker (or this one, once the attachment appears)
        # can still evaluate it.  The tid rides the exception so the
        # CLI loop can cool the job down instead of re-reserving it
        queue.unreserve(doc)  # the queue owns the RUNNING->NEW machine
        e.failed_tid = doc.get("tid")
        raise
    if trials is None:
        trials = FileTrials(queue.root, exp_key=exp_key, refresh=False)
    ctrl = Ctrl(trials, current_trial=doc)
    # Ctrl.checkpoint asserts membership of the live store
    trials._dynamic_trials.append(doc)
    spec = spec_from_misc(doc["misc"])
    running_path = os.path.join(queue.root, "running", f"{doc['tid']}.json")
    beat = _ClaimBeat(running_path, queue.fs)
    with _common.claim_heartbeat(beat, heartbeat):
        try:
            if workdir:
                with working_dir(os.path.join(workdir, str(doc["tid"]))):
                    result = domain.evaluate(spec, ctrl)
            else:
                result = domain.evaluate(spec, ctrl)
        except Exception as e:  # graftlint: disable=GL302 objective errors become ERROR docs
            logger.error("job %s failed: %s", doc["tid"], e)
            doc["state"] = JOB_STATE_ERROR
            doc["misc"]["error"] = (str(type(e)), str(e))
            doc["misc"]["traceback"] = traceback.format_exc()
        else:
            doc["state"] = JOB_STATE_DONE
            doc["result"] = SONify(result)
    queue.fs.crashpoint("before_complete")
    # completion-time lost-claim detection: claim_is_live (inside
    # complete) re-reads the running file and compares claim tokens --
    # the authoritative check; beat.lost is only the early-stop hint
    # that let the heartbeat thread exit cleanly
    if not queue.complete(doc, require_claim=True):
        # the claim was reaped mid-evaluation (heartbeat lost / running
        # file re-owned): the job is already back in new/ or re-running
        # elsewhere -- publishing now would race the re-run into a
        # duplicate DONE doc, so drop this result and move on
        logger.warning(
            "job %s: claim lost mid-evaluation (reaped); dropping result "
            "to defer to the re-run", doc.get("tid"),
        )
    return True


def main_worker_helper(options, drain=None):
    # options.fs (optional) injects the filesystem seam: a test drives the
    # real CLI loop under a FaultPlan this way
    fs = getattr(options, "fs", None)
    queue = FileJobQueue(options.dir, fs=fs)
    owner = worker_owner()
    n_done = 0
    idle_since = time.time()
    drain = (drain or GracefulDrain()).install()
    # jobs whose Domain failed to load are skipped on cooldown so one
    # dangling-attachment job cannot monopolize the sorted reserve scan
    # (other jobs and other drivers keep being served; the TTL retries
    # eventually in case the failure was transient)
    bad_tids = _common.TTLSet()
    # crash-loop guard: consecutive unexpected errors (not per-job
    # Domain failures) back off, then exit LOUDLY -- a worker under a
    # process supervisor must not silently restart-spin on a poisoned
    # environment, and a transient mount outage that outlives the
    # per-op retries should cost backoff, not the process
    consecutive_errors = 0
    max_crash_loop = getattr(options, "max_crash_loop", 5)
    trials = FileTrials(
        options.dir, exp_key=options.exp_key, refresh=False,
        reserve_timeout=options.reserve_timeout, fs=fs,
    )
    logger.info("worker %s serving %s", owner, queue.root)
    while options.max_jobs is None or n_done < options.max_jobs:
        if drain.requested:
            logger.info("drained after %d job(s), exiting 0", n_done)
            return 0
        # backoff decisions are made in the handler, the sleep happens
        # at loop level on the shared schedule (_common.retry_delay): one
        # backoff curve for the whole fault domain
        backoff = None
        try:
            queue.reap(options.reserve_timeout)
            ran = run_one(
                queue, owner, exp_key=options.exp_key,
                workdir=options.workdir, trials=trials,
                heartbeat=(
                    options.reserve_timeout / 3.0
                    if options.reserve_timeout else None
                ),
                exclude_tids=bad_tids.current(),
            )
        except Exception as e:
            # ANY Domain-load failure carries the job's tid (run_one
            # gave the job back) -- WorkerExit for a missing
            # attachment, but also UnpicklingError/ImportError from
            # version skew: all cool the tid down instead of crashing
            # the worker into a supervisor restart loop on the same
            # lowest-tid job.  A misconfigured queue (jobs but never a
            # Domain) thus drains into the cooldown set, run_one starts
            # returning False, and the normal idle path applies the
            # last_job_timeout give-up
            tid = getattr(e, "failed_tid", None)
            if tid is not None:
                logger.error("job %s returned to queue: %s", tid, e)
                bad_tids.add(tid)
                consecutive_errors = 0  # per-job failure, not a crash loop
                backoff = options.poll_interval
            else:
                consecutive_errors += 1
                if consecutive_errors >= max_crash_loop:
                    logger.critical(
                        "%d consecutive unexpected errors (last: %s); "
                        "exiting loudly", consecutive_errors, e,
                        exc_info=True,
                    )
                    return 2
                level = (
                    logging.WARNING if _common.is_transient(e)
                    else logging.ERROR
                )
                logger.log(
                    level, "unexpected worker error (%d/%d): %s",
                    consecutive_errors, max_crash_loop, e, exc_info=True,
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
            n_done += 1
            idle_since = time.time()
        else:
            if (
                options.last_job_timeout is not None
                and time.time() - idle_since > options.last_job_timeout  # graftlint: disable=GL307 idle-timeout protocol arithmetic (exit decision), not a metric accumulation
            ):
                logger.info("idle for %.0fs, exiting", options.last_job_timeout)
                break
            time.sleep(options.poll_interval)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="hyperopt-tpu-torch-worker")
    parser.add_argument("--dir", required=True, help="FileJobQueue directory")
    parser.add_argument("--exp-key", default=None)
    parser.add_argument("--max-jobs", type=int, default=None)
    parser.add_argument("--poll-interval", type=float, default=0.2)
    parser.add_argument("--reserve-timeout", type=float, default=120.0)
    parser.add_argument(
        "--last-job-timeout", type=float, default=None,
        help="exit after this many seconds without work",
    )
    parser.add_argument("--workdir", default=None)
    parser.add_argument(
        "--max-crash-loop", type=int, default=5,
        help="consecutive unexpected errors before a loud exit (rc 2)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    options = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if options.verbose else logging.INFO,
        stream=sys.stderr,
    )
    return main_worker_helper(options)


if __name__ == "__main__":
    sys.exit(main())
