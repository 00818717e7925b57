"""SparkTrials: one Spark task per trial (the port of
:mod:`hyperopt_tpu.distributed.spark`).

An fmin dispatcher launches each trial as a one-task Spark job in its own
thread (at most ``parallelism`` in flight), cancels through job groups on
timeout, and posts results back into the driver's store under a lock;
the suggestion stays on the driver, on the domain's device.  Requires
``pyspark`` (import-gated); the same dispatch runs without it in
:class:`hyperopt_tpu_torch.distributed.ThreadTrials`.  The tests drive
this module over the in-memory SparkSession double of
``tests/fake_backends.py``.
"""

from __future__ import annotations

import logging
import threading
import timeit

from ..base import (
    Ctrl,
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Trials,
    spec_from_misc,
)
from ..utils import coarse_utcnow

logger = logging.getLogger(__name__)

__all__ = ["SparkTrials"]


def _require_pyspark():
    try:
        import pyspark

        return pyspark
    except ImportError as e:
        raise ImportError(
            "SparkTrials requires pyspark, which is not installed in this "
            "environment. ThreadTrials provides the same dispatch semantics "
            "in-process; FileTrials + hyperopt-tpu-torch-worker scales across "
            "hosts on a shared filesystem."
        ) from e


def _spark_supports_job_cancelling(sc):
    return hasattr(sc, "cancelJobGroup")


def submit_one_task(sc, task, group, description, interrupt=True):
    """Run ``task`` as a single-task Spark job under ``group`` and
    return its result -- the 1-trial dispatch idiom shared by
    ``SparkTrials`` and ``asha_spark`` (one definition, so fixes to the
    dispatch cannot drift).  The job group is set only when the context
    supports cancellation (the same capability gate SparkTrials uses).

    NOTE on concurrency: job groups are per-JVM-thread; without
    PySpark pinned-thread mode (``PYSPARK_PIN_THREAD``, default on
    since Spark 3.2) concurrent driver threads can attach a group to
    the wrong job, so external per-group cancellation is only reliable
    under pinned threads."""
    if _spark_supports_job_cancelling(sc):
        sc.setJobGroup(group, description, interrupt)
    [result] = sc.parallelize([0], 1).map(task).collect()
    return result


class SparkTrials(Trials):
    """Trials whose evaluation fans out as single-task Spark jobs."""

    asynchronous = True

    def __init__(self, parallelism=None, timeout=None, spark_session=None,
                 exp_key=None, refresh=True):
        pyspark = _require_pyspark()
        if spark_session is None:
            spark_session = pyspark.sql.SparkSession.builder.getOrCreate()
        self._spark = spark_session
        self._sc = spark_session.sparkContext
        default_par = max(self._sc.defaultParallelism, 1)
        self.parallelism = int(parallelism) if parallelism else default_par
        self.timeout = timeout
        self._lock = threading.RLock()
        self._inflight = {}
        self._fmin_cancelled = False
        self._fmin_cancelled_reason = None
        self._start_time = None
        self._supports_cancel = _spark_supports_job_cancelling(self._sc)
        super().__init__(exp_key=exp_key, refresh=refresh)

    # -- bookkeeping under the lock: results are posted back by the
    # dispatcher threads, refresh() runs on the driver -----------------------
    def refresh(self):
        with self._lock:
            super().refresh()

    def insert_trial_docs(self, docs):
        with self._lock:
            return super().insert_trial_docs(docs)

    def _timed_out(self):
        return (
            self.timeout is not None
            and self._start_time is not None
            and timeit.default_timer() - self._start_time >= self.timeout
        )

    def _job_group(self, trial):
        return f"hyperopt_tpu-trial-{trial['tid']}"

    def _run_trial_async(self, trial, domain):
        """One dispatcher thread: run the trial as a 1-task Spark job."""
        sc = self._sc
        group = self._job_group(trial)
        spec = spec_from_misc(trial["misc"])

        def task(_):
            ctrl = Ctrl(None, current_trial=None)
            return domain.evaluate(spec, ctrl, attach_attachments=False)

        try:
            result = submit_one_task(
                sc, task, group, f"trial {trial['tid']}", True
            )
        except Exception as e:  # graftlint: disable=GL302 a task failure becomes an ERROR doc
            with self._lock:
                if trial["state"] == JOB_STATE_RUNNING:
                    trial["state"] = JOB_STATE_ERROR
                    trial["misc"]["error"] = (str(type(e)), str(e))
                    trial["refresh_time"] = coarse_utcnow()
        else:
            with self._lock:
                trial["state"] = JOB_STATE_DONE
                trial["result"] = result
                trial["refresh_time"] = coarse_utcnow()
        finally:
            with self._lock:
                self._inflight.pop(trial["tid"], None)

    def _dispatch_new(self, domain):
        with self._lock:
            if self._timed_out():
                if not self._fmin_cancelled:
                    self._fmin_cancelled = True
                    self._fmin_cancelled_reason = "fmin run timeout"
                for tid, (th, trial) in list(self._inflight.items()):
                    if self._supports_cancel:
                        self._sc.cancelJobGroup(self._job_group(trial))
                for t in self._dynamic_trials:
                    if t["state"] == JOB_STATE_NEW:
                        t["state"] = JOB_STATE_CANCEL
                return
            for t in self._dynamic_trials:
                if len(self._inflight) >= self.parallelism:
                    break
                if t["state"] != JOB_STATE_NEW:
                    continue
                t["state"] = JOB_STATE_RUNNING
                t["book_time"] = coarse_utcnow()
                t["owner"] = "spark"
                th = threading.Thread(
                    target=self._run_trial_async, args=(t, domain), daemon=True
                )
                self._inflight[t["tid"]] = (th, t)
                th.start()

    def count_by_state_unsynced(self, arg):
        domain = getattr(self, "_domain", None)
        if domain is not None:
            self._dispatch_new(domain)
        with self._lock:
            return super().count_by_state_unsynced(arg)

    def fmin(self, fn, space, algo=None, max_evals=None, **kwargs):
        """Dispatching fmin: suggest on the driver (on ``device=``, None =
        the card), evaluate as Spark jobs."""
        from ..base import Domain
        from ..fmin import fmin as _fmin

        kwargs.pop("allow_trials_fmin", None)
        timeout = kwargs.pop("timeout", None)
        if timeout is not None:
            self.timeout = timeout
        # under the lock: the dispatcher threads read the cancellation
        # flag (as ThreadTrials.fmin)
        with self._lock:
            self._start_time = timeit.default_timer()
            self._fmin_cancelled = False
        pass_expr_memo_ctrl = kwargs.pop("pass_expr_memo_ctrl", None)
        self._domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl,
                              device=kwargs.get("device"))
        if kwargs.get("max_queue_len") is None:
            kwargs["max_queue_len"] = self.parallelism
        return _fmin(
            fn, space, algo=algo, max_evals=max_evals, trials=self,
            allow_trials_fmin=False, timeout=self.timeout,
            pass_expr_memo_ctrl=pass_expr_memo_ctrl, **kwargs,
        )
