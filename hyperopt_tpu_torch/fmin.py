"""The optimization driver of the PyTorch port: ``fmin``.

The counterpart of :mod:`hyperopt_tpu.fmin`: ask the algo for new trial
docs at the plugin seam, evaluate them in order (``serial_evaluate``) or,
on an asynchronous store, publish them and wait for the store's workers
(``block_until_done``), stop at ``max_evals``, ``timeout``,
``loss_threshold`` or ``early_stop_fn``, and return the argmin config.
The seed draw takes the same ``rstate`` draws as the reference's driver,
so equal ``rstate``s hand the algo equal seeds, with or without the
ask-ahead hook (``_notify_result``/``_take_seed``) that
``tpe.suggest(fused=True)`` installs.

Durability and containment are the reference's: ``trials_save_file``/
``resume_from`` route through
:class:`~hyperopt_tpu_torch.utils.checkpoint.DriverRecovery` (a
write-ahead tell log and durable bundles: a run killed anywhere resumes
with zero lost and zero duplicated tells and a bitwise stream);
``trial_timeout`` and ``catch`` record an overrunning or raising
objective as a ``STATUS_FAIL`` trial, durably; ``show_progressbar``
(default on) draws a ``tqdm`` bar or calls the caller's progress
context; ``recorder`` (a :class:`~hyperopt_tpu_torch.obs.FlightRecorder`)
records ``driver.trial``/``tell.wal_append`` spans.  ``engine=True`` (or
``ask_ahead=k``) routes the loop through the serve engine as its client
(:mod:`hyperopt_tpu_torch.client`); ``compiled=True`` routes the whole
experiment through the compiled loop
(:func:`hyperopt_tpu_torch.device_loop.compile_fmin`).  Asynchronous
stores (:mod:`hyperopt_tpu_torch.distributed`: ``ThreadTrials``,
``FileTrials``, ``MongoTrials``, ``SparkTrials``) get the pickled Domain
as their ``FMinIter_Domain`` attachment, published before the first ask,
and the driver waits on every round: with ``max_queue_len=k`` the stream
is the sequential driver's at the same ``k``, whatever the workers'
timing.

One addition: ``device`` (None = the card) is stored on the ``Domain``,
where the port's suggest path reads it.
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import threading
import time
import timeit
import traceback

import numpy as np

from . import base
from . import progress as progress_mod
from .base import (
    Ctrl,
    Domain,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_FAIL,
    Trials,
    spec_from_misc,
)
from .exceptions import (
    AllTrialsFailed,
    CheckpointError,
    InvalidAnnotatedParameter,
    TrialTimeout,
)
from .obs.flightrec import NULL_RECORDER
from .pyll.base import as_apply, rec_eval
from .pyll_utils import expr_to_config
from .utils import coarse_utcnow

logger = logging.getLogger(__name__)

__all__ = ["fmin", "FMinIter", "StopExperiment", "fmin_pass_expr_memo_ctrl",
           "generate_trials_to_calculate", "partial", "space_eval"]

class StopExperiment:
    """Sentinel an algo may return instead of new trials to halt fmin."""


def fmin_pass_expr_memo_ctrl(f):
    """Decorator: the objective takes the raw ``(expr, memo, ctrl)``
    instead of a materialized config (the reference's
    ``fmin_pass_expr_memo_ctrl``; :class:`~hyperopt_tpu_torch.base.Domain`
    reads the attribute)."""
    f.fmin_pass_expr_memo_ctrl = True
    return f


def partial(fn, **kwargs):
    """``functools.partial`` that keeps the wrapped algo's attributes."""
    rval = functools.partial(fn, **kwargs)
    functools.update_wrapper(rval, fn, updated=[])
    return rval


def space_eval(space, hp_assignment):
    """Substitute ``{label: value}`` into a space: the concrete config
    the objective would receive (choices resolve to their chosen
    option)."""
    space = as_apply(space)
    memo = {}
    for label, info in expr_to_config(space).items():
        if label in hp_assignment:
            memo[info.node] = hp_assignment[label]
    return rec_eval(space, memo=memo)


def generate_trials_to_calculate(points):
    """A ``Trials`` store seeded with explicit configs to evaluate first:
    ``points`` is a list of ``{label: value}`` dicts (choice values are
    indices)."""
    trials = Trials()
    new_ids = trials.new_trial_ids(len(points))
    miscs = [
        {
            "tid": tid,
            "cmd": None,
            "workdir": None,
            "idxs": {key: [tid] for key in point},
            "vals": {key: [point[key]] for key in point},
        }
        for tid, point in zip(new_ids, points)
    ]
    results = [{"status": base.STATUS_NEW} for _ in points]
    docs = trials.new_trial_docs(new_ids, [None] * len(points), results, miscs)
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


class FMinIter:
    """Object-based fmin: step the ask/evaluate loop explicitly.

    ``recovery`` (a :class:`~hyperopt_tpu_torch.utils.checkpoint.
    DriverRecovery`) makes every ask and tell durable before it is
    applied (sequential stores only: an asynchronous store's queue is its
    own record, and ``trials_save_file`` then pickles the store every
    round); ``client`` (an :class:`~hyperopt_tpu_torch.client.
    EngineClient`) routes the asks and tells through the serve engine
    instead of ``algo``.  ``asynchronous`` (None: the store's own flag)
    publishes the pickled domain as the store's ``FMinIter_Domain``
    attachment and has each round wait for the store's workers, polling
    every ``poll_interval_secs``."""

    catch_eval_exceptions = False
    pickle_protocol = pickle.HIGHEST_PROTOCOL

    def __init__(self, algo, domain, trials, rstate, asynchronous=None, max_queue_len=1,
                 poll_interval_secs=0.1, max_evals=float("inf"), timeout=None,
                 loss_threshold=None, early_stop_fn=None, verbose=False, show_progressbar=True,
                 trials_save_file="", recovery=None, trial_timeout=None, catch=(),
                 recorder=None, client=None):
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.algo = algo
        self.domain = domain
        self.trials = trials
        self.rstate = rstate
        self.asynchronous = trials.asynchronous if asynchronous is None else asynchronous
        self.max_queue_len = max_queue_len
        self.poll_interval_secs = poll_interval_secs
        self.max_evals = max_evals
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.early_stop_fn = early_stop_fn
        self.early_stop_args = []
        self.verbose = verbose
        self.show_progressbar = show_progressbar
        self.start_time = timeit.default_timer()
        self.trials_save_file = trials_save_file
        self._recovery = None if self.asynchronous else recovery
        # per-trial containment: a deadline in seconds, and the exception
        # classes recorded as STATUS_FAIL trials instead of aborting
        self.trial_timeout = trial_timeout
        if catch and not isinstance(catch, tuple):
            catch = (catch,)
        self.catch = catch or ()
        # ask-ahead seam: the seed pre-drawn for the NEXT ask, so that an
        # algo's result hook can pre-dispatch it (see _notify_result)
        self._ask_ahead_seed = None
        self._client = client
        self._span_study = "driver" if client is None else client.study_name

        if self.asynchronous and "FMinIter_Domain" not in trials.attachments:
            # workers fetch the domain by attachment; published before any
            # ask, so it carries none of the suggest paths' caches
            try:
                trials.attachments["FMinIter_Domain"] = pickle.dumps(
                    domain, protocol=self.pickle_protocol)
            except Exception:
                logger.warning("domain not picklable for async backend")

    def _draw_seed(self):
        # works for both np.random.Generator and legacy RandomState
        if hasattr(self.rstate, "integers"):
            return int(self.rstate.integers(2**31 - 1))
        return int(self.rstate.randint(2**31 - 1))

    def _take_seed(self):
        """The next ask's seed: the one pre-drawn for the ask-ahead hook
        if a result notification drew it, else a fresh draw.  One seed
        per ask either way, so the stream is the same with and without
        a hook."""
        seed = self._ask_ahead_seed
        if seed is not None:
            self._ask_ahead_seed = None
            return seed
        return self._draw_seed()

    def _notify_result(self):
        """Right after a result is recorded, hand the algo's registered
        hook (``domain._ask_ahead_hook``, installed by
        ``tpe.suggest(fused=True)``) the next ask's seed, pre-drawn from
        the same rstate stream, so it can enqueue that ask.  A failing
        hook is logged and removed: ask-ahead is an optimization, never a
        correctness dependency."""
        hook = getattr(self.domain, "_ask_ahead_hook", None)
        if hook is None:
            return
        if self._ask_ahead_seed is None:
            self._ask_ahead_seed = self._draw_seed()
        try:
            hook(self.trials, self._ask_ahead_seed)
        except Exception:
            logger.exception("ask-ahead hook failed; continuing with plain asks")
            self.domain._ask_ahead_hook = None

    # -- stopping rules ----------------------------------------------------
    def _timed_out(self):
        return (
            self.timeout is not None
            and timeit.default_timer() - self.start_time >= self.timeout
        )

    def _loss_reached(self):
        if self.loss_threshold is None:
            return False
        try:
            best = self.trials.best_trial["result"]["loss"]
        except AllTrialsFailed:
            return False
        return best <= self.loss_threshold

    def _early_stopped(self):
        if self.early_stop_fn is None or len(self.trials.trials) == 0:
            return False
        stop, kwargs = self.early_stop_fn(self.trials, *self.early_stop_args)
        self.early_stop_args = kwargs
        return bool(stop)

    def should_stop(self):
        return self._timed_out() or self._loss_reached() or self._early_stopped()

    # -- write-ahead seams -------------------------------------------------
    def _crashpoint(self, name):
        if self._recovery is not None:
            self._recovery.fs.crashpoint(name)

    def _log_ask(self, docs):
        """Write the new docs (and the rstate cursor after their seed
        draw) ahead of inserting them: a logged ask is never drawn again
        on resume; one that was not is asked again from the cursor."""
        if self._recovery is not None:
            self._recovery.log_ask(base.SONify(docs), self.rstate)

    def _log_tell(self, trial, result=None):
        """Write one outcome ahead of applying it: a logged tell is never
        evaluated again and never applied twice on resume."""
        if self._recovery is None:
            return
        rec = self.recorder
        t0 = timeit.default_timer() if rec.enabled else 0.0
        if result is not None:
            self._recovery.log_tell(trial["tid"], JOB_STATE_DONE, result=result)
        else:
            self._recovery.log_tell(trial["tid"], JOB_STATE_ERROR,
                                    error=list(trial["misc"].get("error", ())),
                                    tb=trial["misc"].get("traceback"))
        if rec.enabled:
            rec.record("tell.wal_append", t0, timeit.default_timer(), study="driver",
                       tid=int(trial["tid"]))

    def _record_tell(self, trial, result=None):
        """The write-ahead seam of both regimes: the solo driver logs to
        its ``DriverRecovery`` WAL, the engine client tells or fails
        through the study's serve WAL; either way the outcome is durable
        before the doc finalizes."""
        if self._client is not None:
            self._client.record_tell(trial, result)
        else:
            self._log_tell(trial, result=result)

    # -- evaluation --------------------------------------------------------
    def _evaluate_one(self, spec, ctrl):
        """One objective call, under the per-trial deadline when
        ``trial_timeout`` is set: the objective runs on a daemon thread,
        and on expiry the trial is recorded as failed and the driver
        moves on (the runaway thread cannot be killed, only abandoned)."""
        if not self.trial_timeout:
            return self.domain.evaluate(spec, ctrl)
        box = {}

        def _run():
            try:
                box["result"] = self.domain.evaluate(spec, ctrl)
            except BaseException as e:
                box["error"] = e

        worker = threading.Thread(target=_run, daemon=True)
        worker.start()
        worker.join(self.trial_timeout)
        if worker.is_alive():
            raise TrialTimeout(
                f"objective exceeded trial_timeout={self.trial_timeout}s; recording "
                "STATUS_FAIL and continuing (the runaway thread is abandoned)"
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _evaluate_trial(self, trial):
        """Evaluate ONE queued trial doc in place: containment (``catch``,
        ``trial_timeout``), the write-ahead record, the recorder span and
        the ask-ahead notification, shared by :meth:`serial_evaluate` and
        the engine-client loop."""
        trial["state"] = JOB_STATE_RUNNING
        trial["book_time"] = coarse_utcnow()
        trial["owner"] = "serial"
        spec = spec_from_misc(trial["misc"])
        ctrl = Ctrl(self.trials, current_trial=trial)
        result = failure = None
        t_eval = timeit.default_timer() if self.recorder.enabled else 0.0
        try:
            result = self._evaluate_one(spec, ctrl)
        except TrialTimeout as e:
            failure = ("TrialTimeout", str(e), None)
        except self.catch as e:
            failure = (type(e).__name__, str(e), traceback.format_exc())
        except Exception as e:
            logger.error("job exception: %s", e)
            trial["state"] = JOB_STATE_ERROR
            trial["misc"]["error"] = (str(type(e)), str(e))
            trial["misc"]["traceback"] = traceback.format_exc()
            trial["refresh_time"] = coarse_utcnow()
            # durable before any raise: a resumed driver must not run a
            # crashing objective again
            self._record_tell(trial)
            if not self.catch_eval_exceptions:
                self.trials.refresh()
                raise
        if result is None and failure is None:
            return
        if failure is not None:
            kind, msg, tb = failure
            logger.warning("trial %s recorded as failed (%s): %s", trial["tid"], kind, msg)
            result = {"status": STATUS_FAIL, "loss": None, "failure": f"{kind}: {msg}"}
            if tb is not None:
                result["traceback"] = tb
        result = base.SONify(result)
        self._record_tell(trial, result=result)  # on disk before it is applied
        trial["state"] = JOB_STATE_DONE
        trial["result"] = result
        trial["refresh_time"] = coarse_utcnow()
        if self.recorder.enabled:
            self.recorder.record("driver.trial", t_eval, timeit.default_timer(),
                                 study=self._span_study, tid=int(trial["tid"]),
                                 status=result.get("status"))
        self._crashpoint("after_tell_before_ask_ahead")
        self._notify_result()

    def serial_evaluate(self, N=-1):
        for trial in self.trials._dynamic_trials:
            if trial["state"] != JOB_STATE_NEW:
                continue
            self._evaluate_trial(trial)
            N -= 1
            if N == 0:
                break
        self.trials.refresh()

    def block_until_done(self):
        """Wait until the store has no NEW or RUNNING trial left (or the
        run's ``timeout`` passes), polling every ``poll_interval_secs``;
        each poll is also the pump of a store that dispatches from it."""
        unfinished_states = [JOB_STATE_NEW, JOB_STATE_RUNNING]

        def get_queue_len():
            return self.trials.count_by_state_unsynced(unfinished_states)

        qlen = get_queue_len()
        while qlen > 0:
            if self._timed_out():
                logger.warning("timeout while waiting on %d jobs", qlen)
                break
            time.sleep(self.poll_interval_secs)
            self.trials.refresh()
            qlen = get_queue_len()

    # -- checkpoints -------------------------------------------------------
    def _checkpoint_round(self, force=False):
        """Round-boundary durability: the recovery bundle at its tell
        cadence (the WAL covers the gaps), or, without a recovery (an
        asynchronous store), the durable pickle of the store every round."""
        if self._recovery is not None:
            self._recovery.maybe_checkpoint(self.trials, self.rstate,
                                            ask_ahead_seed=self._ask_ahead_seed, force=force)
        elif self.trials_save_file:
            from .utils.checkpoint import save_trials

            save_trials(self.trials, self.trials_save_file)

    # -- main loop ---------------------------------------------------------
    def _progress_ctx(self, initial, total):
        if callable(self.show_progressbar) and not isinstance(self.show_progressbar, bool):
            return self.show_progressbar(initial=initial, total=total)
        if self.show_progressbar:
            return progress_mod.tqdm_progress_callback(initial=initial, total=total)
        return progress_mod.no_progress_callback(initial=initial, total=total)

    def _report(self, progress, initial_n_done):
        """Move the progress context to the trials finished so far."""
        n_done = self.trials.count_by_state_unsynced(JOB_STATE_DONE)
        n_new_done = n_done - initial_n_done
        if n_new_done <= 0:
            return
        try:
            best_loss = self.trials.best_trial["result"]["loss"]
        except AllTrialsFailed:
            best_loss = None
        progress.update(n_done - (initial_n_done + progress_done(progress)), best_loss=best_loss)
        set_progress_done(progress, n_new_done)

    def _run_client(self, N):
        """The engine-client loop: evaluate the docs already queued
        (``points_to_evaluate``, restored NEW docs), then up to N trials
        through the study's ask-ahead window: await the window's head,
        insert its doc, evaluate it under the shared containment, tell.
        Stopping rules, progress and containment are the solo loop's."""
        trials = self.trials
        client = self._client
        n_new = 0
        initial_n_done = trials.count_by_state_unsynced(JOB_STATE_DONE)
        with self._progress_ctx(initial=0, total=N) as progress:
            if trials.count_by_state_unsynced(JOB_STATE_NEW):
                self.serial_evaluate()
                client.maybe_snapshot()
            while n_new < N:
                trials.refresh()
                if self.should_stop() or not client.budget_left():
                    break
                tid, vals = client.next_suggestion()
                doc = client.insert_new_doc(tid, vals)
                n_new += 1
                self._evaluate_trial(doc)
                client.maybe_snapshot()
                self._report(progress, initial_n_done)
        trials.refresh()

    def run(self, N, block_until_done=True):
        """Enqueue and evaluate up to N new trials.  On an asynchronous
        store a blocking round is one ask, then ``block_until_done``: the
        stream is the sequential driver's at the same ``max_queue_len``,
        and a round lasts as long as its slowest trial.  With
        ``block_until_done=False`` it is the reference's refill loop: ask
        whenever fewer than ``max_queue_len`` trials are NEW, sleep one
        poll between fills; the workers stay busy, and the stream
        depends on their timing."""
        if self._client is not None:
            return self._run_client(N)
        trials = self.trials
        n_queued = 0
        stopped = False
        initial_n_done = trials.count_by_state_unsynced(JOB_STATE_DONE)
        with self._progress_ctx(initial=0, total=N) as progress:
            while n_queued < N:
                qlen = trials.count_by_state_unsynced(JOB_STATE_NEW)
                while qlen < self.max_queue_len and n_queued < N and not stopped:
                    n_to_enqueue = min(self.max_queue_len - qlen, N - n_queued)
                    if self.should_stop():
                        stopped = True
                        break
                    new_ids = trials.new_trial_ids(n_to_enqueue)
                    trials.refresh()
                    new_trials = self.algo(new_ids, self.domain, trials, self._take_seed())
                    if new_trials is StopExperiment or not new_trials:
                        stopped = True
                        break
                    assert len(new_ids) >= len(new_trials)
                    self._log_ask(new_trials)
                    trials.insert_trial_docs(new_trials)
                    trials.refresh()
                    n_queued += len(new_trials)
                    if self.asynchronous and block_until_done:
                        # a blocking round is one ask on one history: the
                        # store's workers may take or finish its trials at
                        # once, and a second ask would see part of the round
                        break
                    qlen = trials.count_by_state_unsynced(JOB_STATE_NEW)
                if self.asynchronous:
                    if block_until_done:
                        self.block_until_done()
                    else:
                        time.sleep(self.poll_interval_secs)
                    trials.refresh()
                else:
                    self.serial_evaluate()
                self._report(progress, initial_n_done)
                self._checkpoint_round()
                if stopped:
                    break
        self._checkpoint_round(force=True)

    def exhaust(self):
        self.run(self.max_evals - len(self.trials), block_until_done=self.asynchronous)
        self.trials.refresh()
        return self

    def __iter__(self):
        return self

    def __next__(self):
        self.run(1, block_until_done=self.asynchronous)
        if len(self.trials) >= self.max_evals:
            raise StopIteration()
        return self.trials


def progress_done(progress):
    return getattr(progress, "_n_done", 0)


def set_progress_done(progress, n):
    progress._n_done = n


def _driver_guard(algo, fn, space):
    """The study fingerprint stamped into every recovery artifact:
    resuming under another algo, objective or space would change the
    experiment, so it is refused."""
    from .hyperband import _algo_identity, _space_fingerprint

    return ["fmin-driver", 1, _algo_identity(algo), _algo_identity(fn),
            _space_fingerprint(as_apply(space))]


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


def _compiled_algo_name(algo):
    """The compiled loop's algo name for ``fmin(compiled=True)``: strings
    pass through, the port's suggest callables (``partial``-wrapped too)
    map by their module."""
    if algo is None:
        return "tpe"
    if isinstance(algo, str):
        if algo not in ("tpe", "anneal", "rand", "atpe"):
            raise ValueError(f"unknown compiled algo {algo!r}: expected tpe|anneal|rand|atpe")
        return algo
    a = algo
    while isinstance(a, functools.partial):
        a = a.func
    short = (getattr(a, "__module__", "") or "").rsplit(".", 1)[-1]
    if short in ("tpe", "anneal", "rand", "atpe"):
        return short
    raise ValueError(
        f"compiled=True cannot map algo {algo!r} onto a compiled-loop algo; pass "
        "algo='tpe'|'anneal'|'rand'|'atpe'"
    )


def _run_compiled(fn, space, algo, max_evals, loss_threshold, trials, rstate, return_argmin,
                  options, device):
    """The ``fmin(compiled=True)`` body: the experiment runs in the compiled
    loop (suggest, evaluation and tell of every trial on the device), then
    a standard ``Trials`` store is rebuilt from the history.  ``options``
    are ``compile_fmin`` arguments, or ``runner=`` (a prebuilt runner) and
    ``seed=`` (else one draw from ``rstate``)."""
    from .device_loop import _to_trials, compile_fmin

    opts = dict(options or {})
    runner = opts.pop("runner", None)
    seed = opts.pop("seed", None)
    if seed is None:
        # one draw from the caller's stream, like every host-driver seed
        if hasattr(rstate, "integers"):
            seed = int(rstate.integers(2**31 - 1))
        else:
            seed = int(rstate.randint(2**31 - 1))
    if trials is not None and len(trials):
        raise ValueError(
            "compiled=True starts a fresh experiment; warm-start via "
            "device_loop.history_from_trials + compile_fmin(warm_capacity=...) instead"
        )
    if runner is None:
        if not isinstance(max_evals, (int, np.integer)):
            raise ValueError(
                "compiled=True requires an integer max_evals (the step count is part of "
                "the compiled loop)"
            )
        opts.setdefault("device", device)
        runner = compile_fmin(fn, space, int(max_evals), algo=_compiled_algo_name(algo),
                              loss_threshold=loss_threshold, **opts)
    elif opts:
        raise ValueError(
            "compiled_options: pass either a prebuilt runner= (from compile_fmin) or "
            "compile_fmin options, not both"
        )
    out = runner(seed=seed)
    if trials is None:
        trials = Trials()
    _to_trials(runner._packed_space, out["values"], out["active"], out["losses"],
               trials=trials)
    return _fmin_result(trials, return_argmin)


def _validate_stopping(timeout, loss_threshold):
    if timeout is not None and (not isinstance(timeout, (int, float)) or timeout <= 0):
        raise ValueError(
            f"The timeout argument should be None or a positive value. Given value: {timeout}"
        )
    if loss_threshold is not None and not isinstance(loss_threshold, (int, float)):
        raise ValueError(
            "The loss_threshold argument should be None or a numeric value. "
            f"Given value: {loss_threshold}"
        )


def _run_engine_client(fn, space, algo, max_evals, timeout, loss_threshold, trials, rstate,
                       pass_expr_memo_ctrl, catch_eval_exceptions, verbose, return_argmin,
                       points_to_evaluate, max_queue_len, show_progressbar, early_stop_fn,
                       trials_save_file, resume_from, trial_timeout, catch, recorder, engine,
                       ask_ahead, device):
    """The ``fmin(engine=...)`` body: open a study on an in-process
    :class:`~hyperopt_tpu_torch.serve.SuggestService` and drive the
    sequential loop through its asks and tells with an ask-ahead window
    of depth ``ask_ahead``.  ``engine=True`` goes through the client
    module's shared-service registry, so concurrent calls of one study
    family share one scheduler's rounds, each stream bitwise its solo
    run; the last client out shuts the shared service down."""
    from .client import connect

    if max_queue_len not in (None, 1):
        raise ValueError(
            "engine routing drives one ask at a time -- use ask_ahead=k for pipelining "
            "(max_queue_len applies to the solo driver)"
        )
    if trials is not None and (type(trials).fmin is not Trials.fmin
                               or getattr(trials, "asynchronous", False)):
        raise ValueError("engine routing supports sequential Trials stores only")
    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl, device=device)

    root = None
    require_existing = False
    eng = True if engine is None or isinstance(engine, bool) else engine
    if eng is True:
        if resume_from is not None:
            root = str(resume_from)
            require_existing = True
        elif trials_save_file:
            root = str(trials_save_file)
        if root is not None and os.path.isfile(root):
            raise CheckpointError(
                f"{root!r} is a FILE -- a solo-driver checkpoint; engine-client durability "
                "uses a study-root DIRECTORY (<root>/fmin.wal and fmin.snap).  Resume a "
                "solo checkpoint with engine=False, or start a new recoverable run against "
                "a directory"
            )
    elif trials_save_file or resume_from is not None:
        raise ValueError(
            "with a provided engine service, durability rides its root=; drop "
            "trials_save_file/resume_from (restore is implicit when the root holds study "
            "artifacts)"
        )

    if trials is None and points_to_evaluate is not None:
        assert isinstance(points_to_evaluate, list)
        trials = generate_trials_to_calculate(points_to_evaluate)
    elif trials is not None and points_to_evaluate is not None and len(trials) == 0:
        assert isinstance(points_to_evaluate, list)
        seeded = generate_trials_to_calculate(points_to_evaluate)
        trials._ids.update(t["tid"] for t in seeded._dynamic_trials)
        trials._insert_trial_docs(seeded._dynamic_trials)
        trials.refresh()

    client, trials, rstate, _restored = connect(
        eng, algo, domain, trials, rstate, fn=fn,
        ask_ahead=1 if ask_ahead is None else int(ask_ahead), root=root,
        require_existing=require_existing, max_submits=max_evals, recorder=recorder,
    )
    rval = FMinIter(algo, domain, trials, rstate=rstate, max_evals=max_evals, timeout=timeout,
                    loss_threshold=loss_threshold, early_stop_fn=early_stop_fn,
                    verbose=verbose, show_progressbar=show_progressbar,
                    trial_timeout=trial_timeout, catch=catch, recorder=recorder,
                    client=client)
    rval.catch_eval_exceptions = catch_eval_exceptions
    try:
        rval.exhaust()
    except BaseException:
        # a crash leaves the WAL as the truth, not compacted; the registry
        # hold is dropped so a retry in this process restores from disk
        client.abandon()
        raise
    client.finalize()
    return _fmin_result(trials, return_argmin)


def fmin(
    fn,
    space,
    algo=None,
    max_evals=None,
    timeout=None,
    loss_threshold=None,
    trials=None,
    rstate=None,
    allow_trials_fmin=True,
    pass_expr_memo_ctrl=None,
    catch_eval_exceptions=False,
    verbose=False,
    return_argmin=True,
    points_to_evaluate=None,
    max_queue_len=None,
    early_stop_fn=None,
    device=None,
    show_progressbar=True,
    trials_save_file="",
    resume_from=None,
    trial_timeout=None,
    catch=(),
    compiled=False,
    engine=None,
    ask_ahead=None,
    compiled_options=None,
    recorder=None,
):
    """Minimize ``fn`` over ``space`` with ``algo`` (default: the port's
    ``tpe.suggest``).

    ``rstate`` is a ``np.random.Generator`` (or an int seed): one
    ``integers(2**31 - 1)`` draw per ask, as the reference draws.
    The run stops at ``max_evals`` trials, after ``timeout`` seconds,
    once the best loss is at most ``loss_threshold``, or when
    ``early_stop_fn(trials, *args) -> (stop, args)`` says so (for example
    :func:`hyperopt_tpu_torch.early_stop.no_progress_loss`).
    ``device`` (None = the card, ``"cpu"`` to opt in to the CPU) is where
    the suggest path computes; without CUDA and without ``device="cpu"``
    this raises rather than falling back.  ``points_to_evaluate`` (a list
    of ``{label: value}`` dicts) is evaluated first when the store is
    empty; ``verbose`` is kept on the driver, as the reference keeps it;
    ``allow_trials_fmin`` lets a ``Trials`` subclass with its own ``fmin``
    take the call (``ThreadTrials``, ``SparkTrials``); an asynchronous
    store (``FileTrials``, ``MongoTrials``) is driven here, its workers
    evaluating each round of ``max_queue_len`` trials (None: 1, or a
    dispatching store's ``parallelism``) before the next ask, so the
    stream is the sequential driver's at the same ``max_queue_len``.
    ``show_progressbar`` (default on) draws a ``tqdm`` bar; a callable
    ``(initial=, total=)`` returning a context manager with
    ``update(n, best_loss=)`` takes its place.

    Crash recovery: ``trials_save_file`` routes through
    :class:`~hyperopt_tpu_torch.utils.checkpoint.DriverRecovery` (a
    write-ahead tell log and durable bundles): a run killed anywhere
    resumes with zero lost and zero duplicated tells and a stream bitwise
    the uninterrupted run (the restored bit-generator supersedes
    ``rstate``).  ``resume_from`` is the explicit form: the checkpoint
    must exist (else :class:`~hyperopt_tpu_torch.exceptions.
    CheckpointError`); it may also be a ``DriverRecovery`` (crash tests
    arm crash points on its ``fs``).  ``trial_timeout`` (seconds) records
    an overrunning objective as a ``STATUS_FAIL`` trial and moves on;
    ``catch`` (an exception class or tuple) does the same for a raising
    objective, with its traceback; both are logged ahead, so a resumed
    run never evaluates them again.  ``recorder`` (a
    :class:`~hyperopt_tpu_torch.obs.FlightRecorder`) records the
    driver's spans and changes no stream.

    Engine routing: ``engine=True`` (or any ``ask_ahead=``) makes the
    driver a client of an in-process
    :class:`~hyperopt_tpu_torch.serve.SuggestService` on ``device``:
    ``ask_ahead=k`` keeps k asks submitted ahead (seeds drawn at submit
    time, each dispatch held until the posterior is full), so the stream
    is bitwise the solo fused driver's at any depth.  ``engine`` may be a
    caller-built ``SuggestService``.  ``trials_save_file``/
    ``resume_from`` then name a study-root DIRECTORY (``<root>/fmin.wal``,
    ``fmin.snap``).  ``algo`` must be the port's ``tpe.suggest``,
    ``anneal.suggest`` or ``atpe.suggest`` (partials included).

    ``compiled=True`` runs the whole experiment in the compiled loop on
    ``device`` (:func:`hyperopt_tpu_torch.device_loop.compile_fmin`, ``fn``
    a batch objective over tensors or a ``TrainableObjective``):
    ``algo`` maps by name, ``loss_threshold`` stops on the device,
    ``compiled_options`` holds ``compile_fmin`` arguments (or ``runner=``
    and ``seed=``), and ``trials`` is filled from the history.
    """
    _validate_stopping(timeout, loss_threshold)
    if trial_timeout is not None and (not isinstance(trial_timeout, (int, float))
                                      or trial_timeout <= 0):
        raise ValueError(
            "The trial_timeout argument should be None or a positive value. Given value: "
            f"{trial_timeout}"
        )
    use_engine = bool(engine) or ask_ahead is not None
    if use_engine and compiled:
        raise ValueError(
            "engine=/ask_ahead= route the sequential driver through the serve engine; "
            "compiled=True is the on-device regime -- pick one"
        )
    if compiled:
        if trials_save_file or resume_from is not None:
            raise ValueError(
                "compiled=True durability rides compiled_options (chunk_size/"
                "checkpoint_path/resume -- the chunked compiled loop), not "
                "trials_save_file/resume_from"
            )
        host_only = [
            name for name, v in (
                ("timeout", timeout), ("early_stop_fn", early_stop_fn),
                ("points_to_evaluate", points_to_evaluate),
                ("trial_timeout", trial_timeout), ("catch", catch or None),
            ) if v is not None
        ]
        if host_only:
            raise ValueError(
                f"compiled=True runs the experiment as one compiled loop; host-driver "
                f"feature(s) {host_only} do not apply (loss_threshold compiles to the "
                "on-device stopping rule; use compiled_options for chunked "
                "progress/checkpointing)"
            )
    if algo is None:
        from . import tpe

        algo = tpe.suggest
    if max_evals is None:
        max_evals = float("inf")
    if rstate is None:
        rstate = np.random.default_rng()
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))
    if use_engine:
        return _run_engine_client(
            fn, space, algo, max_evals, timeout, loss_threshold, trials, rstate,
            pass_expr_memo_ctrl, catch_eval_exceptions, verbose, return_argmin,
            points_to_evaluate, max_queue_len, show_progressbar, early_stop_fn,
            trials_save_file, resume_from, trial_timeout, catch, recorder, engine, ask_ahead,
            device,
        )
    if compiled:
        return _run_compiled(fn, space, algo, max_evals, loss_threshold, trials, rstate,
                             return_argmin, compiled_options, device)

    from .utils.checkpoint import DriverRecovery

    recovery = None
    ask_ahead_seed = None
    if resume_from is not None or trials_save_file:
        if isinstance(resume_from, DriverRecovery):
            # an injected coordinator: load if it exists, else start anew
            recovery = resume_from
        else:
            recovery = DriverRecovery(resume_from or trials_save_file)
            if resume_from is not None and not recovery.exists():
                raise CheckpointError(
                    f"resume_from checkpoint {recovery.path!r} does not exist; pass "
                    "trials_save_file= to start a new recoverable run instead"
                )
        recovery.set_guard(_driver_guard(algo, fn, space))
        if recovery.exists():
            restored = recovery.load()
            trials = restored.trials
            ask_ahead_seed = restored.ask_ahead_seed
            if restored.rstate is not None:
                rstate = restored.rstate
                logger.info(
                    "resumed %d trials from %r (replayed %d tell(s) from the WAL); the "
                    "bit-generator is restored, so the stream continues exactly",
                    len(trials), recovery.path, restored.n_replayed_tells)

    if trials is None:
        if points_to_evaluate is None:
            trials = Trials()
        else:
            assert isinstance(points_to_evaluate, list)
            trials = generate_trials_to_calculate(points_to_evaluate)
    elif points_to_evaluate is not None and len(trials) == 0:
        assert isinstance(points_to_evaluate, list)
        seeded = generate_trials_to_calculate(points_to_evaluate)
        trials._ids.update(t["tid"] for t in seeded._dynamic_trials)
        trials._insert_trial_docs(seeded._dynamic_trials)
        trials.refresh()
    if allow_trials_fmin and type(trials).fmin is not Trials.fmin:
        return trials.fmin(
            fn, space, algo=algo, max_evals=max_evals, timeout=timeout,
            loss_threshold=loss_threshold, max_queue_len=max_queue_len, rstate=rstate,
            pass_expr_memo_ctrl=pass_expr_memo_ctrl, verbose=verbose,
            catch_eval_exceptions=catch_eval_exceptions, return_argmin=return_argmin,
            show_progressbar=show_progressbar, early_stop_fn=early_stop_fn,
            trials_save_file=trials_save_file, device=device,
        )
    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl, device=device)
    rval = FMinIter(algo, domain, trials, rstate=rstate,
                    max_queue_len=1 if max_queue_len is None else max_queue_len,
                    max_evals=max_evals, timeout=timeout, loss_threshold=loss_threshold,
                    early_stop_fn=early_stop_fn, verbose=verbose,
                    show_progressbar=show_progressbar, trials_save_file=trials_save_file,
                    recovery=recovery, trial_timeout=trial_timeout, catch=catch,
                    recorder=recorder)
    rval.catch_eval_exceptions = catch_eval_exceptions
    if ask_ahead_seed is not None:
        # the seed the crashed run had pre-drawn for its next ask
        rval._ask_ahead_seed = int(ask_ahead_seed)
    if rval._recovery is not None and not recovery.exists():
        # anchor bundle before the first ask: WAL replay is relative to a
        # bundle, and points_to_evaluate must survive an early crash
        recovery.checkpoint(trials, rstate)
    rval.exhaust()
    return _fmin_result(trials, return_argmin)
