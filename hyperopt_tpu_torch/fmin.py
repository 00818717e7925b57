"""The sequential optimization driver of the PyTorch port: ``fmin``.

The counterpart of :mod:`hyperopt_tpu.fmin`, trimmed to the sequential
path: ask the algo for new trial docs at the plugin seam, evaluate them
in order (``serial_evaluate``), stop at ``max_evals``, ``timeout``,
``loss_threshold`` or ``early_stop_fn``, and return the argmin config.
The seed draw takes the same ``rstate`` draws as the reference's driver,
so equal ``rstate``s hand the algo equal seeds, with or without the
ask-ahead hook (``_notify_result``/``_take_seed``) that
``tpe.suggest(fused=True)`` installs.  The progress bar, per-trial
containment (``trial_timeout``, ``catch``), checkpoints and the WAL,
and the engine are later work and raise ``NotImplementedError``.
``compiled=True`` routes the whole experiment through the compiled loop
(:func:`hyperopt_tpu_torch.device_loop.compile_fmin`) and rebuilds a
standard ``Trials`` store from its history.

One addition: ``device`` (None = the card) is stored on the ``Domain``,
where the port's suggest path reads it.
"""

from __future__ import annotations

import functools
import logging
import timeit
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
from .pyll.base import as_apply, rec_eval
from .pyll_utils import expr_to_config
from .utils import coarse_utcnow

logger = logging.getLogger(__name__)

__all__ = ["fmin", "FMinIter", "StopExperiment", "generate_trials_to_calculate", "partial",
           "space_eval"]


class StopExperiment:
    """Sentinel an algo may return instead of new trials to halt fmin."""


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
    """Object-based sequential fmin: step the ask/evaluate loop explicitly."""

    catch_eval_exceptions = False

    def __init__(self, algo, domain, trials, rstate, max_queue_len=1,
                 max_evals=float("inf"), timeout=None, loss_threshold=None,
                 early_stop_fn=None, verbose=False):
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
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.early_stop_fn = early_stop_fn
        self.early_stop_args = []
        self.verbose = verbose
        self.start_time = timeit.default_timer()
        # ask-ahead seam: the seed pre-drawn for the NEXT ask, so that an
        # algo's result hook can pre-dispatch it (see _notify_result)
        self._ask_ahead_seed = None

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

    def run(self, N):
        """Enqueue and evaluate up to N new trials."""
        trials = self.trials
        n_queued = 0
        stopped = False
        while n_queued < N and not stopped:
            qlen = trials.count_by_state_unsynced(JOB_STATE_NEW)
            while qlen < self.max_queue_len and n_queued < N:
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
    max_queue_len=1,
    early_stop_fn=None,
    device=None,
    show_progressbar=False,
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
    ``tpe.suggest``), sequentially.

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
    take the call (the port's stores are all sequential, so none does).

    ``compiled=True`` runs the whole experiment in the compiled loop on
    ``device`` (:func:`hyperopt_tpu_torch.device_loop.compile_fmin`, ``fn``
    a batch objective over tensors or a ``TrainableObjective``):
    ``algo`` maps by name, ``loss_threshold`` stops on the device,
    ``compiled_options`` holds ``compile_fmin`` arguments (or ``runner=``
    and ``seed=``), and ``trials`` is filled from the history.  The
    reference's progress bar, ``trial_timeout``/``catch``, checkpoints
    (``trials_save_file``, ``resume_from``), the flight recorder
    (``recorder``) and ``engine``/``ask_ahead`` are not ported: setting
    one raises ``NotImplementedError``.
    """
    if recorder is not None:
        raise NotImplementedError(
            "fmin(recorder=...): the flight recorder's driver spans are not ported yet "
            "(ROADMAP.md Queue A, item 12b)"
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
    unported = [
        name for name, v in (
            ("show_progressbar", show_progressbar), ("trials_save_file", trials_save_file),
            ("resume_from", resume_from), ("trial_timeout", trial_timeout),
            ("catch", catch), ("engine", engine), ("ask_ahead", ask_ahead),
        ) if v
    ]
    if unported:
        raise NotImplementedError(f"fmin: {unported} not ported yet")
    _validate_stopping(timeout, loss_threshold)
    if algo is None:
        from . import tpe

        algo = tpe.suggest
    if max_evals is None:
        max_evals = float("inf")
    if rstate is None:
        rstate = np.random.default_rng()
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))
    if compiled:
        return _run_compiled(fn, space, algo, max_evals, loss_threshold, trials, rstate,
                             return_argmin, compiled_options, device)
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
    if trials.asynchronous:
        raise NotImplementedError(
            "the port's fmin drives sequential Trials stores only"
        )

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl,
                    device=device)
    rval = FMinIter(algo, domain, trials, rstate=rstate,
                    max_queue_len=max_queue_len, max_evals=max_evals,
                    timeout=timeout, loss_threshold=loss_threshold,
                    early_stop_fn=early_stop_fn, verbose=verbose)
    rval.catch_eval_exceptions = catch_eval_exceptions
    rval.exhaust()
    return _fmin_result(trials, return_argmin)
