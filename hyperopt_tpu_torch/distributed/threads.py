"""ThreadTrials: asynchronous in-process evaluation with a parallelism cap.

The port of :mod:`hyperopt_tpu.distributed.threads`: the control flow of
``SparkTrials`` (a dispatcher loop, at most ``parallelism`` trials in
flight, timeout cancellation, results posted back under a lock) with a
thread pool instead of one-task Spark jobs.  Useful whenever the
objective releases the GIL (work on the card, subprocesses, IO).  The
suggestion stays on the driver's thread, on the domain's device.
"""

from __future__ import annotations

import logging
import threading
import timeit

from ..base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    Trials,
    spec_from_misc,
)
from ..utils import coarse_utcnow

logger = logging.getLogger(__name__)

__all__ = ["ThreadTrials"]


class ThreadTrials(Trials):
    """Trials whose NEW jobs are evaluated by a pool of worker threads.

    Args:
      parallelism: max trials in flight at once.
      timeout: per-experiment wall-clock budget (seconds); when exceeded,
        queued trials are cancelled (running ones finish: Python threads
        are not preemptible, as Spark cancels at a task boundary).
    """

    asynchronous = True

    def __init__(self, parallelism=4, timeout=None, exp_key=None, refresh=True):
        self.parallelism = max(1, int(parallelism))
        self.timeout = timeout
        self._lock = threading.RLock()
        self._inflight = {}
        self._fmin_cancelled = False
        self._fmin_cancelled_reason = None
        self._start_time = None
        super().__init__(exp_key=exp_key, refresh=refresh)

    # -- hooks -------------------------------------------------------------
    def refresh(self):
        with self._lock:
            super().refresh()

    def insert_trial_docs(self, docs):
        with self._lock:
            return super().insert_trial_docs(docs)

    # -- dispatch ----------------------------------------------------------
    def _timed_out(self):
        return (
            self.timeout is not None
            and self._start_time is not None
            and timeit.default_timer() - self._start_time >= self.timeout
        )

    def _run_trial(self, trial, domain):
        ctrl = Ctrl(self, current_trial=trial)
        spec = spec_from_misc(trial["misc"])
        try:
            result = domain.evaluate(spec, ctrl)
        except Exception as e:  # graftlint: disable=GL302 objective errors become ERROR docs
            logger.error("trial %s exception: %s", trial["tid"], e)
            with self._lock:
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
        """Start threads for NEW trials up to the parallelism cap."""
        with self._lock:
            if self._timed_out():
                if not self._fmin_cancelled:
                    self._fmin_cancelled = True
                    self._fmin_cancelled_reason = "fmin run timeout"
                    logger.warning("ThreadTrials: timeout, cancelling queue")
                for t in self._dynamic_trials:
                    if t["state"] == JOB_STATE_NEW:
                        t["state"] = JOB_STATE_CANCEL
                        t["refresh_time"] = coarse_utcnow()
                return
            for t in self._dynamic_trials:
                if len(self._inflight) >= self.parallelism:
                    break
                if t["state"] != JOB_STATE_NEW:
                    continue
                t["state"] = JOB_STATE_RUNNING
                t["book_time"] = coarse_utcnow()
                t["owner"] = f"thread:{len(self._inflight)}"
                th = threading.Thread(target=self._run_trial, args=(t, domain), daemon=True)
                self._inflight[t["tid"]] = th
                th.start()

    # -- fmin entry point --------------------------------------------------
    def fmin(self, fn, space, algo=None, max_evals=None, **kwargs):
        """Dispatching fmin: suggest on the driver (on ``device=``, None =
        the card), evaluate in threads."""
        from ..base import Domain
        from ..fmin import fmin as _fmin

        kwargs.pop("allow_trials_fmin", None)
        timeout = kwargs.pop("timeout", None)
        if timeout is not None:
            self.timeout = timeout
        # under the lock: the worker threads read the cancellation state,
        # and a re-entrant fmin must not tear the previous run's
        with self._lock:
            self._start_time = timeit.default_timer()
            self._fmin_cancelled = False

        pass_expr_memo_ctrl = kwargs.pop("pass_expr_memo_ctrl", None)
        domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl,
                        device=kwargs.get("device"))
        self._domain = domain

        # whole rounds of `parallelism` trials are suggested, dispatched to
        # the pool, then awaited (the SparkTrials dispatch shape)
        if kwargs.get("max_queue_len") is None:
            kwargs["max_queue_len"] = self.parallelism
        return _fmin(fn, space, algo=algo, max_evals=max_evals, trials=self,
                     allow_trials_fmin=False, timeout=self.timeout,
                     pass_expr_memo_ctrl=pass_expr_memo_ctrl, **kwargs)

    def count_by_state_unsynced(self, arg):
        # every poll of FMinIter.block_until_done doubles as the pump
        domain = getattr(self, "_domain", None)
        if domain is not None:
            self._dispatch_new(domain)
        with self._lock:
            return super().count_by_state_unsynced(arg)
