"""The sequential optimization driver of the PyTorch port: ``fmin``.

The counterpart of :mod:`hyperopt_tpu.fmin`, trimmed to the sequential
path: ask the algo for new trial docs at the plugin seam, evaluate them
in order (``serial_evaluate``), stop at ``max_evals``, and return the
argmin config.  The seed draw takes the same ``rstate`` draws as the
reference's driver, so equal ``rstate``s hand the algo equal seeds.  The
engine, client, compiled, checkpoint/WAL, timeout and progress-bar
branches of the reference are later work.

One addition: ``device`` (None = the card) is stored on the ``Domain``,
where the port's suggest path reads it.
"""

from __future__ import annotations

import logging
import traceback

import numpy as np

from . import base
from .base import (
    Ctrl,
    Domain,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Trials,
    spec_from_misc,
)
from .exceptions import AllTrialsFailed, InvalidAnnotatedParameter
from .utils import coarse_utcnow

logger = logging.getLogger(__name__)

__all__ = ["fmin", "FMinIter", "StopExperiment"]


class StopExperiment:
    """Sentinel an algo may return instead of new trials to halt fmin."""


class FMinIter:
    """Object-based sequential fmin: step the ask/evaluate loop explicitly."""

    catch_eval_exceptions = False

    def __init__(self, algo, domain, trials, rstate, max_queue_len=1,
                 max_evals=float("inf")):
        if trials.asynchronous:
            raise NotImplementedError(
                "the port's fmin drives sequential Trials stores only"
            )
        self.algo = algo
        self.domain = domain
        self.trials = trials
        self.rstate = rstate
        self.max_queue_len = max_queue_len
        self.max_evals = max_evals

    def _draw_seed(self):
        # works for both np.random.Generator and legacy RandomState
        if hasattr(self.rstate, "integers"):
            return int(self.rstate.integers(2**31 - 1))
        return int(self.rstate.randint(2**31 - 1))

    def _evaluate_trial(self, trial):
        """Evaluate ONE queued trial doc in place."""
        trial["state"] = JOB_STATE_RUNNING
        trial["book_time"] = coarse_utcnow()
        trial["owner"] = "serial"
        spec = spec_from_misc(trial["misc"])
        ctrl = Ctrl(self.trials, current_trial=trial)
        try:
            result = self.domain.evaluate(spec, ctrl)
        except Exception as e:
            logger.error("job exception: %s", e)
            trial["state"] = JOB_STATE_ERROR
            trial["misc"]["error"] = (str(type(e)), str(e))
            trial["misc"]["traceback"] = traceback.format_exc()
            trial["refresh_time"] = coarse_utcnow()
            if not self.catch_eval_exceptions:
                self.trials.refresh()
                raise
            return
        trial["state"] = JOB_STATE_DONE
        trial["result"] = base.SONify(result)
        trial["refresh_time"] = coarse_utcnow()

    def serial_evaluate(self, N=-1):
        for trial in self.trials._dynamic_trials:
            if trial["state"] != JOB_STATE_NEW:
                continue
            self._evaluate_trial(trial)
            N -= 1
            if N == 0:
                break
        self.trials.refresh()

    def run(self, N):
        """Enqueue and evaluate up to N new trials."""
        trials = self.trials
        n_queued = 0
        stopped = False
        while n_queued < N and not stopped:
            qlen = trials.count_by_state_unsynced(JOB_STATE_NEW)
            while qlen < self.max_queue_len and n_queued < N:
                n_to_enqueue = min(self.max_queue_len - qlen, N - n_queued)
                new_ids = trials.new_trial_ids(n_to_enqueue)
                trials.refresh()
                new_trials = self.algo(new_ids, self.domain, trials, self._draw_seed())
                if new_trials is StopExperiment or not new_trials:
                    stopped = True
                    break
                assert len(new_ids) >= len(new_trials)
                trials.insert_trial_docs(new_trials)
                trials.refresh()
                n_queued += len(new_trials)
                qlen = trials.count_by_state_unsynced(JOB_STATE_NEW)
            self.serial_evaluate()

    def exhaust(self):
        self.run(self.max_evals - len(self.trials))
        self.trials.refresh()
        return self


def _fmin_result(trials, return_argmin):
    """The shared fmin return contract (argmin or best loss)."""
    if return_argmin:
        if len(trials.trials) == 0:
            raise InvalidAnnotatedParameter(
                "There are no evaluation tasks, cannot return argmin of task losses."
            )
        return trials.argmin
    if len(trials) > 0:
        try:
            return trials.best_trial["result"]["loss"]
        except AllTrialsFailed:
            return None
    return None


def fmin(
    fn,
    space,
    algo=None,
    max_evals=None,
    trials=None,
    rstate=None,
    pass_expr_memo_ctrl=None,
    catch_eval_exceptions=False,
    return_argmin=True,
    max_queue_len=1,
    device=None,
):
    """Minimize ``fn`` over ``space`` with ``algo`` (default: the port's
    ``tpe.suggest``), sequentially.

    ``rstate`` is a ``np.random.Generator`` (or an int seed): one
    ``integers(2**31 - 1)`` draw per ask, as the reference draws.
    ``device`` (None = the card, ``"cpu"`` to opt in to the CPU) is where
    the suggest path computes; without CUDA and without ``device="cpu"``
    this raises rather than falling back.
    """
    if algo is None:
        from . import tpe

        algo = tpe.suggest
    if max_evals is None:
        max_evals = float("inf")
    if rstate is None:
        rstate = np.random.default_rng()
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))
    if trials is None:
        trials = Trials()
    elif type(trials).fmin is not Trials.fmin or trials.asynchronous:
        raise NotImplementedError(
            "the port's fmin drives sequential Trials stores only"
        )

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl,
                    device=device)
    rval = FMinIter(algo, domain, trials, rstate=rstate,
                    max_queue_len=max_queue_len, max_evals=max_evals)
    rval.catch_eval_exceptions = catch_eval_exceptions
    rval.exhaust()
    return _fmin_result(trials, return_argmin)
