"""Experiment core of the PyTorch port: trial documents, the ``Trials``
history store and ``Domain``.

A copy of the framework-neutral half of :mod:`hyperopt_tpu.base`
(``posterior_state``, ``Trials``, ``Domain``, ``Ctrl`` and the document
helpers they use), so the port imports nothing of the JAX package.  One
addition: ``Domain`` carries the ``device`` the port's suggest path
computes on (:func:`hyperopt_tpu_torch.utils.resolve_device`).

Trial documents are JSON-ish dicts::

    {tid, state, spec, result{status, loss, ...},
     misc{tid, cmd, idxs, vals, workdir}, exp_key, owner, version,
     book_time, refresh_time}

``misc['vals'][label]`` is ``[value]`` if the hyperparameter was active
for the trial and ``[]`` if not (conditional ``hp.choice`` branches).
The dense mirror of this store lives in
:mod:`hyperopt_tpu_torch.torch_trials`.
"""

from __future__ import annotations

import logging

import numpy as np

from .exceptions import (
    AllTrialsFailed,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
)
from .pyll.base import as_apply, rec_eval
from .pyll_utils import expr_to_config
from .utils import coarse_utcnow, resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "JOB_STATE_NEW",
    "JOB_STATE_RUNNING",
    "JOB_STATE_DONE",
    "JOB_STATE_ERROR",
    "JOB_STATE_CANCEL",
    "JOB_STATES",
    "JOB_VALID_STATES",
    "STATUS_NEW",
    "STATUS_RUNNING",
    "STATUS_SUSPENDED",
    "STATUS_OK",
    "STATUS_FAIL",
    "STATUS_STRINGS",
    "Trials",
    "trials_from_docs",
    "Domain",
    "Ctrl",
    "miscs_to_idxs_vals",
    "miscs_update_idxs_vals",
    "spec_from_misc",
    "SONify",
]

# -- job states (trial lifecycle) ------------------------------------------
JOB_STATE_NEW = 0
JOB_STATE_RUNNING = 1
JOB_STATE_DONE = 2
JOB_STATE_ERROR = 3
JOB_STATE_CANCEL = 4
JOB_STATES = (
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_CANCEL,
)
JOB_VALID_STATES = JOB_STATES

# -- result statuses (objective-reported) ----------------------------------
STATUS_NEW = "new"
STATUS_RUNNING = "running"
STATUS_SUSPENDED = "suspended"
STATUS_OK = "ok"
STATUS_FAIL = "fail"
STATUS_STRINGS = (STATUS_NEW, STATUS_RUNNING, STATUS_SUSPENDED, STATUS_OK, STATUS_FAIL)


def posterior_state(trial):
    """Classify a trial doc for posterior ingestion -- THE shared
    predicate of every observation mirror (host ``tpe._ObsIndex``, device
    ``torch_trials.ObsBuffer``, and the reference-shaped filters):

      * ``"ok"``      -- completed, status ok, finite loss: ingest.
      * ``"pending"`` -- may still become ok: NEW/RUNNING state, or a
        DONE state whose result still reads new/running (an async worker
        writes ``state`` and ``result`` as two plain stores; a reader in
        that window must keep waiting, not evict the trial).
      * ``"dead"``    -- will never produce an observation (ERROR,
        CANCEL, failed/suspended status, missing or non-finite loss).
    """
    state = trial["state"]
    if state in (JOB_STATE_NEW, JOB_STATE_RUNNING):
        return "pending"
    if state == JOB_STATE_DONE:
        status = trial["result"].get("status")
        if status == STATUS_OK:
            loss = trial["result"].get("loss")
            if loss is not None and np.isfinite(float(loss)):
                return "ok"
            return "dead"
        if status in (STATUS_NEW, STATUS_RUNNING):
            return "pending"  # mid-write race window
        return "dead"
    return "dead"

TRIAL_KEYS = frozenset(
    [
        "tid",
        "spec",
        "result",
        "misc",
        "state",
        "owner",
        "book_time",
        "refresh_time",
        "exp_key",
        "version",
    ]
)
TRIAL_MISC_KEYS = frozenset(["tid", "cmd", "idxs", "vals"])


def SONify(arg):
    """Recursively convert numpy scalars/arrays to plain JSON-able Python."""
    if isinstance(arg, dict):
        return {SONify(k): SONify(v) for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        return [SONify(a) for a in arg]
    if isinstance(arg, np.ndarray):
        return [SONify(a) for a in arg.tolist()] if arg.ndim else SONify(arg.item())
    if isinstance(arg, np.integer):
        return int(arg)
    if isinstance(arg, np.floating):
        return float(arg)
    if isinstance(arg, np.bool_):
        return bool(arg)
    if isinstance(arg, (str, bytes, int, float, bool)) or arg is None:
        return arg
    if hasattr(arg, "item"):  # 0-d tensors etc.
        return SONify(arg.item())
    return arg


def miscs_to_idxs_vals(miscs, keys=None):
    """Aggregate per-trial sparse encodings into {label: [tids]}, {label: [vals]}."""
    if keys is None:
        if len(miscs) == 0:
            raise ValueError("cannot infer keys from empty miscs")
        keys = list(miscs[0]["idxs"].keys())
    idxs = {k: [] for k in keys}
    vals = {k: [] for k in keys}
    for misc in miscs:
        for k in keys:
            t_idxs = misc["idxs"].get(k, [])
            t_vals = misc["vals"].get(k, [])
            assert len(t_idxs) == len(t_vals) <= 1, (k, t_idxs, t_vals)
            idxs[k].extend(t_idxs)
            vals[k].extend(t_vals)
    return idxs, vals


def miscs_update_idxs_vals(miscs, idxs, vals, assert_all_vals_used=True, idxs_map=None):
    """Scatter aggregated {label: tids/vals} back into per-trial miscs."""
    if idxs_map is None:
        idxs_map = {}
    misc_by_id = {m["tid"]: m for m in miscs}
    for m in miscs:
        m["idxs"] = {k: [] for k in idxs}
        m["vals"] = {k: [] for k in idxs}
    for k, tids in idxs.items():
        for tid, val in zip(tids, vals[k]):
            tid = idxs_map.get(tid, tid)
            if tid in misc_by_id:
                misc_by_id[tid]["idxs"][k] = [tid]
                misc_by_id[tid]["vals"][k] = [val]
            elif assert_all_vals_used:
                raise ValueError(f"tid {tid} not found among miscs")
    return miscs


def spec_from_misc(misc):
    """Config dict {label: value} for one trial's sparse misc encoding."""
    spec = {}
    for k, v in misc["vals"].items():
        if len(v) == 0:
            continue
        if len(v) == 1:
            spec[k] = v[0]
        else:
            raise NotImplementedError(f"multiple values for label {k}: {v}")
    return spec


def validate_trial(trial):
    if not isinstance(trial, dict):
        raise InvalidTrial(f"trial should be a dict, got {type(trial)}")
    missing = TRIAL_KEYS - set(trial)
    if missing:
        raise InvalidTrial(f"trial missing keys {sorted(missing)}")
    if trial["state"] not in JOB_VALID_STATES:
        raise InvalidTrial(f"invalid state {trial['state']!r}")
    misc = trial["misc"]
    if not isinstance(misc, dict):
        raise InvalidTrial("trial['misc'] must be a dict")
    missing_misc = TRIAL_MISC_KEYS - set(misc)
    if missing_misc:
        raise InvalidTrial(f"trial['misc'] missing keys {sorted(missing_misc)}")
    if trial["tid"] != misc["tid"]:
        raise InvalidTrial(f"tid mismatch: {trial['tid']} != {misc['tid']}")
    return trial


class Trials:
    """In-memory experiment history: a list of trial documents.

    Synchronous, single-process store (reference ``base.Trials``).
    Subclasses override ``asynchronous`` / ``refresh`` to provide
    distributed stores.
    """

    asynchronous = False

    def __init__(self, exp_key=None, refresh=True):
        self._ids = set()
        self._dynamic_trials = []
        self._exp_key = exp_key
        self.attachments = {}
        self._trials = []
        if refresh:
            self.refresh()

    # -- basics ------------------------------------------------------------
    def view(self, exp_key=None, refresh=True):
        rval = object.__new__(self.__class__)
        rval._exp_key = exp_key
        rval._ids = self._ids
        rval._dynamic_trials = self._dynamic_trials
        rval.attachments = self.attachments
        if refresh:
            rval.refresh()
        return rval

    def aname(self, trial, name):
        return f"ATTACH::{trial['tid']}::{name}"

    def trial_attachments(self, trial):
        """Mapping-like view over one trial's binary attachments."""
        store = self.attachments
        aname = self.aname

        class _View:
            def __contains__(self, name):
                return aname(trial, name) in store

            def __getitem__(self, name):
                return store[aname(trial, name)]

            def __setitem__(self, name, value):
                store[aname(trial, name)] = value

            def __delitem__(self, name):
                del store[aname(trial, name)]

        return _View()

    def __iter__(self):
        return iter(self._trials)

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, item):
        return self._trials[item]

    def refresh(self):
        if self._exp_key is None:
            self._trials = list(self._dynamic_trials)
        else:
            self._trials = [
                t for t in self._dynamic_trials if t["exp_key"] == self._exp_key
            ]
        self._ids.update(t["tid"] for t in self._trials)

    @property
    def trials(self):
        return self._trials

    @property
    def tids(self):
        return [t["tid"] for t in self._trials]

    @property
    def specs(self):
        return [t["spec"] for t in self._trials]

    @property
    def results(self):
        return [t["result"] for t in self._trials]

    @property
    def miscs(self):
        return [t["misc"] for t in self._trials]

    @property
    def idxs_vals(self):
        return miscs_to_idxs_vals(self.miscs)

    @property
    def idxs(self):
        return self.idxs_vals[0]

    @property
    def vals(self):
        return self.idxs_vals[1]

    # -- ids / insertion ---------------------------------------------------
    def new_trial_ids(self, n):
        aa = len(self._ids)
        rval = list(range(aa, aa + n))
        self._ids.update(rval)
        return rval

    def new_trial_docs(self, tids, specs, results, miscs):
        rval = []
        for tid, spec, result, misc in zip(tids, specs, results, miscs):
            doc = {
                "state": JOB_STATE_NEW,
                "tid": tid,
                "spec": spec,
                "result": result,
                "misc": misc,
                "exp_key": self._exp_key,
                "owner": None,
                "version": 0,
                "book_time": None,
                "refresh_time": None,
            }
            rval.append(doc)
        return rval

    def source_trial_docs(self, tids, specs, results, miscs, sources):
        rval = self.new_trial_docs(tids, specs, results, miscs)
        for doc in rval:
            doc["misc"]["from_tid"] = [s["tid"] for s in sources]
        return rval

    def _insert_trial_docs(self, docs):
        self._dynamic_trials.extend(docs)
        return [d["tid"] for d in docs]

    def insert_trial_doc(self, doc):
        return self._insert_trial_docs([validate_trial(SONify(doc))])[0]

    def insert_trial_docs(self, docs):
        return self._insert_trial_docs([validate_trial(SONify(d)) for d in docs])

    def delete_all(self):
        self._dynamic_trials = []
        self._ids = set()
        self.attachments = {}
        self.refresh()

    # -- queries -----------------------------------------------------------
    def count_by_state_synced(self, arg, trials=None):
        """Number of *synced* (post-refresh) trials in the given state(s)."""
        if trials is None:
            trials = self._trials
        if isinstance(arg, int):
            queue = [t for t in trials if t["state"] == arg]
        else:
            states = set(arg)
            queue = [t for t in trials if t["state"] in states]
        return len(queue)

    def count_by_state_unsynced(self, arg):
        """Number of trials in state(s) counting unsynced dynamic docs."""
        if self._exp_key is not None:
            exp_trials = [
                t for t in self._dynamic_trials if t["exp_key"] == self._exp_key
            ]
        else:
            exp_trials = self._dynamic_trials
        return self.count_by_state_synced(arg, trials=exp_trials)

    def losses(self, bandit=None):
        if bandit is None:
            return [r.get("loss") for r in self.results]
        return [bandit.loss(r, s) for r, s in zip(self.results, self.specs)]

    def statuses(self, bandit=None):
        if bandit is None:
            return [r.get("status") for r in self.results]
        return [bandit.status(r, s) for r, s in zip(self.results, self.specs)]

    @property
    def best_trial(self):
        """Trial with lowest loss among status-ok completed trials."""
        candidates = [
            t
            for t in self._trials
            if t["state"] == JOB_STATE_DONE
            and t["result"].get("status") == STATUS_OK
            and t["result"].get("loss") is not None
        ]
        if not candidates:
            raise AllTrialsFailed()
        losses = np.array([float(t["result"]["loss"]) for t in candidates])
        if np.all(np.isnan(losses)):
            raise AllTrialsFailed()
        return candidates[int(np.nanargmin(losses))]

    @property
    def argmin(self):
        """Best config as {label: value} (choices are indices)."""
        return spec_from_misc(self.best_trial["misc"])

    def average_best_error(self, bandit=None):
        """Mean of true-losses of trials within 3 sigma of the best loss.

        Parity: reference ``Trials.average_best_error`` -- uses
        ``true_loss`` when provided, weighting by loss variance.
        """

        def fmap(f):
            rval = np.asarray(
                [
                    f(r, s)
                    for (r, s) in zip(self.results, self.specs)
                    if (bandit.status(r) if bandit else r.get("status")) == STATUS_OK
                ]
            ).astype(float)
            if not np.all(np.isfinite(rval)):
                raise ValueError("non-finite losses in average_best_error")
            return rval

        if bandit is None:
            def loss(r, s):
                return r.get("loss")

            def loss_v(r, s):
                return r.get("loss_variance", 0)

            def true_loss(r, s):
                return r.get("true_loss", r.get("loss"))
        else:
            loss, loss_v, true_loss = bandit.loss, bandit.loss_variance, bandit.true_loss

        loss3 = list(zip(fmap(loss), fmap(loss_v), fmap(true_loss)))
        if not loss3:
            raise AllTrialsFailed()
        loss3.sort()
        loss3 = np.asarray(loss3)
        if np.all(loss3[:, 1] == 0):
            best_idx = int(np.argmin(loss3[:, 0]))
            return loss3[best_idx, 2]
        cutoff = 0
        sigma = np.sqrt(loss3[0][1])
        while cutoff < len(loss3) and loss3[cutoff][0] < loss3[0][0] + 3 * sigma:
            cutoff += 1
        return np.mean(loss3[:cutoff, 2])

    # -- convenience -------------------------------------------------------
    def fmin(self, fn, space, algo=None, max_evals=None, **kwargs):
        """Minimize ``fn`` over ``space``, storing trials in self."""
        from .fmin import fmin as _fmin  # local import avoids cycle

        return _fmin(
            fn, space, algo=algo, max_evals=max_evals, trials=self, **kwargs
        )


def trials_from_docs(docs, validate=True, **kwargs):
    """Build a Trials object from a list of trial documents."""
    rval = Trials(**kwargs)
    if validate:
        rval.insert_trial_docs(docs)
    else:
        rval._insert_trial_docs(docs)
    rval.refresh()
    return rval


class Ctrl:
    """Job-control handle passed to objectives that ask for it.

    Parity: reference ``base.Ctrl`` (checkpoint / attachments /
    inject_results).
    """

    info = logger.info
    warn = logger.warning
    error = logger.error
    debug = logger.debug

    def __init__(self, trials, current_trial=None):
        self.trials = trials
        self.current_trial = current_trial

    @property
    def attachments(self):
        """Attachment view scoped to the current trial."""
        return self.trials.trial_attachments(trial=self.current_trial)

    def checkpoint(self, result=None):
        """Persist a partial result for the running trial."""
        assert self.current_trial in self.trials._dynamic_trials
        if result is not None:
            self.current_trial["result"] = SONify(result)
            self.current_trial["refresh_time"] = coarse_utcnow()

    def inject_results(self, specs, results, miscs, new_tids=None):
        """Inject pre-evaluated trials (DONE) into the store from inside an
        objective -- used for population/batched evaluation strategies."""
        trial = self.current_trial
        assert trial is not None
        num = len(specs)
        if new_tids is not None:
            assert num == len(new_tids)
        else:
            new_tids = self.trials.new_trial_ids(num)
        docs = self.trials.source_trial_docs(
            tids=new_tids, specs=specs, results=results, miscs=miscs, sources=[trial]
        )
        for doc in docs:
            doc["state"] = JOB_STATE_DONE
        return self.trials.insert_trial_docs(docs)


class Domain:
    """Binds a user objective ``fn`` to a search space.

    Evaluation: ``memo_from_config`` substitutes sampled values at the
    labeled nodes, ``rec_eval`` materializes the (possibly nested) config,
    and ``fn`` is called on it.  ``device`` (None = the card) is where the
    port's suggest path keeps the packed space, the history and every
    draw for this domain; it is resolved here, so a domain built without
    ``device="cpu"`` on a machine without CUDA raises at once.
    """

    rec_eval_print_node_on_error = False

    def __init__(
        self,
        fn,
        expr,
        workdir=None,
        pass_expr_memo_ctrl=None,
        name=None,
        loss_target=None,
        device=None,
    ):
        self.fn = fn
        self.device = resolve_device(device)
        if pass_expr_memo_ctrl is None:
            self.pass_expr_memo_ctrl = getattr(fn, "fmin_pass_expr_memo_ctrl", False)
        else:
            self.pass_expr_memo_ctrl = pass_expr_memo_ctrl

        self.expr = as_apply(expr)
        self.workdir = workdir
        self.name = name
        self.loss_target = loss_target

        # label -> ParamInfo (validates labels, detects DuplicateLabel)
        self.hps = expr_to_config(self.expr)
        # label -> distribution node (memo substitution point)
        self.params = {label: info.node for label, info in self.hps.items()}

        self.cmd = ("domain_attachment", "FMinIter_Domain")

    def __getstate__(self):
        # the suggest paths cache derived state on the domain under private
        # names (the packed space and history on the card, built suggest
        # functions, the ask-ahead hook's closure, a weakref to the trials
        # store): a pickled domain -- the one an asynchronous fmin ships to
        # its workers -- carries only what __init__ set
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    # -- evaluation --------------------------------------------------------
    def memo_from_config(self, config):
        memo = {}
        for label, node in self.params.items():
            if label in config:
                memo[node] = config[label]
        return memo

    def evaluate(self, config, ctrl, attach_attachments=True):
        memo = self.memo_from_config(config)
        if self.pass_expr_memo_ctrl:
            rval = self.fn(expr=self.expr, memo=memo, ctrl=ctrl)
        else:
            pyll_rval = rec_eval(self.expr, memo=memo)
            rval = self.fn(pyll_rval)

        if isinstance(rval, (float, int, np.number)):
            loss = float(rval)
            if not np.isfinite(loss):
                # NaN/Inf quarantine: a non-finite loss is recorded as
                # a FAILED trial -- never as an "ok" observation that
                # would poison best_trial/loss_threshold and every
                # subsequent suggestion's above/below split
                result = {
                    "status": STATUS_FAIL,
                    "loss": None,
                    "failure": f"non-finite loss {loss!r}",
                }
            else:
                result = {"status": STATUS_OK, "loss": loss}
        elif isinstance(rval, dict):
            result = dict(rval)
            status = result.get("status")
            if status not in STATUS_STRINGS:
                raise InvalidResultStatus(
                    f"objective returned invalid status {status!r}"
                )
            if status == STATUS_OK:
                try:
                    result["loss"] = float(result["loss"])
                except (KeyError, TypeError, ValueError):
                    raise InvalidLoss(
                        f"objective with status 'ok' must return a float loss, "
                        f"got {result.get('loss')!r}"
                    )
                if not np.isfinite(result["loss"]):
                    # same quarantine for the dict-result path
                    result["failure"] = (
                        f"non-finite loss {result['loss']!r}"
                    )
                    result["status"] = STATUS_FAIL
                    result["loss"] = None
        else:
            raise InvalidResultStatus(
                f"objective must return float or dict, got {type(rval)}"
            )

        if attach_attachments:
            attachments = result.pop("attachments", {})
            for key, val in attachments.items():
                ctrl.attachments[key] = val
        return result

    def evaluate_async(self, config, ctrl, attach_attachments=True):
        """Deferred variant for backends that run objectives elsewhere."""
        return self.evaluate(config, ctrl, attach_attachments=attach_attachments)

    def short_str(self):
        return f"Domain{{{getattr(self.fn, '__name__', self.fn)!r}}}"

    # -- result accessors --------------------------------------------------
    def loss(self, result, config=None):
        return result.get("loss")

    def loss_variance(self, result, config=None):
        return result.get("loss_variance", 0.0)

    def true_loss(self, result, config=None):
        return result.get("true_loss", result.get("loss"))

    def true_loss_variance(self, config=None):
        raise NotImplementedError()

    def status(self, result, config=None):
        return result["status"]

    def new_result(self):
        return {"status": STATUS_NEW}
