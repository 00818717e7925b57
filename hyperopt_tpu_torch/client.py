"""``fmin`` as a client of the serve engine: ``fmin(engine=True, ask_ahead=k)``.

The port's counterpart of :mod:`hyperopt_tpu.client`.  ``fmin(engine=
True)`` opens a study on an in-process
:class:`~hyperopt_tpu_torch.serve.SuggestService` (no socket; rounds
served inline by default) and drives every trial through its asks and
tells, so the solo driver gets the engine's admission control, write-ahead
log, recorder spans, and its one ``gmm_llr`` launch per round.

Why the stream is the solo fused driver's, bitwise:

* **Submit-time seeds.**  The scheduler draws each ask's seed from the
  study's rstate at submit time, and the client hands the study ``fmin``'s
  own ``rstate``: the seeds are the ones the solo driver would draw.
* **The ask-ahead window** (``ask_ahead=k``): up to ``k`` asks are
  submitted ahead, and the study's ``fresh_window`` holds a queued ask
  back until every suggestion served before it has its tell, so every
  dispatch sees the full posterior, at any depth.
* **One durability story.**  ``trials_save_file``/``resume_from`` name a
  serve study root: the study's :class:`~hyperopt_tpu_torch.utils.wal.
  TellWAL` and snapshot bundle.  Ask records carry the cursor after
  their seed draw, tell records the full result dict, ``fail`` records
  the failed docs (durable before they finalize, so a resumed run never
  evaluates them again), and the bundle carries the client's docs.
* **Backpressure paces.**  An :class:`~hyperopt_tpu_torch.exceptions.
  Overloaded` refusal becomes bounded retry under the client deadline,
  ending in :class:`~hyperopt_tpu_torch.exceptions.DeadlineExpired`,
  never in a hang.

Algorithms: the port's ``tpe.suggest`` and ``anneal.suggest`` (partials
included) map onto the engine's stacked step; ``atpe.suggest`` keeps its
host decision layer as the study's ``host_algo`` hook, served inside the
same rounds.  Anything else raises and names the solo path.

:class:`RemoteStudy` is the exactly-once client of one study behind a
TCP front (:func:`~hyperopt_tpu_torch.serve.service.serve_forever`, the
``hyperopt-tpu-torch-serve`` process, or the reference's server: the wire
is the same).
"""

from __future__ import annotations

import collections
import functools
import json
import logging
import threading
import time
import uuid

import numpy as np

from .base import JOB_STATE_DONE, JOB_STATE_ERROR, STATUS_OK, SONify, Trials
from .distributed import _common
from .exceptions import (
    CheckpointError,
    DeadlineExpired,
    DispatchTimeout,
    NetworkTimeout,
    Overloaded,
    OwnershipLost,
    PeerUnreachable,
    ReplicaDead,
    StudyPoisoned,
    StudyQuarantined,
)
from .rand import docs_from_idxs_vals

logger = logging.getLogger(__name__)

__all__ = [
    "CLIENT_SNAPSHOT_CADENCE",
    "CLIENT_STUDY",
    "EngineClient",
    "EngineSpec",
    "RemoteStudy",
    "SHARED_MAX_BATCH",
    "SHARED_QUEUE_CAP",
    "connect",
    "resolve_engine_algo",
]

#: the study a solo ``fmin`` client opens: its root then holds
#: ``fmin.wal`` and ``fmin.snap``
CLIENT_STUDY = "fmin"

#: tells per snapshot of a client study (``DriverRecovery``'s default)
CLIENT_SNAPSHOT_CADENCE = 25

#: round width of a shared client service: concurrent ``fmin`` clients of
#: one study family ride the same rounds, up to this many asks per round
SHARED_MAX_BATCH = 64

#: per-study queue cap of a shared service; a client's ``ask_ahead``
#: window is clamped to it (depth does not change the stream)
SHARED_QUEUE_CAP = 8

# The shared-service registry: live client-owned services keyed by their
# study family (root, algo and its knobs, space fingerprint, objective).
# Concurrent connect() calls of one family share one service, each with
# its own study, so their asks share rounds; each stream stays bitwise its
# solo run (seeds come off each study's own rstate).  Refcounted: the last
# client out shuts the service down, so a later restore finds the root
# quiet.  Calls with a fault seam (fs=) or a recorder get a private one.
_SHARED_SERVICES = {}  # key -> [service, refcount]
_SHARED_LOCK = threading.Lock()

_ENGINE_MODULES = {
    "hyperopt_tpu_torch.tpe": "tpe",
    "hyperopt_tpu_torch.anneal": "anneal",
    "hyperopt_tpu_torch.atpe": "atpe",
}


def _registry_key(spec, domain, fn, root):
    """The study family of one client-owned service (the port's space
    fingerprint)."""
    from .hyperband import _algo_identity, _space_fingerprint

    return json.dumps(
        [str(root), spec.name, sorted(spec.algo_kw.items()), spec.n_startup_jobs,
         sorted((spec.hook_kw or {}).items()), bool(spec.resident),
         _space_fingerprint(domain.expr), _algo_identity(fn) if fn is not None else None,
         str(domain.device)],
        sort_keys=True, default=str,
    )


def _alloc_study_name(service):
    """The next free client study name: ``fmin``, else ``fmin-2``, ...
    (callers hold :data:`_SHARED_LOCK`)."""
    existing = set(service.studies())
    if CLIENT_STUDY not in existing:
        return CLIENT_STUDY
    i = 2
    while f"{CLIENT_STUDY}-{i}" in existing:
        i += 1
    return f"{CLIENT_STUDY}-{i}"


def _drop_hold(key, service, shutdown):
    """Release one hold on a shared service (lock held): True when it was
    the last, and then the entry is gone (and the service shut down when
    ``shutdown``)."""
    entry = _SHARED_SERVICES.get(key)
    if entry is None or entry[0] is not service:
        return False
    entry[1] -= 1
    if entry[1] > 0:
        return False
    del _SHARED_SERVICES[key]
    if shutdown:
        # inside the lock: a racing connect() of the same family must not
        # build a second service over a root still closing
        service.shutdown()
    return True


class EngineSpec:
    """How one plugin-seam ``algo`` maps onto the serve engine."""

    __slots__ = ("name", "algo_kw", "n_startup_jobs", "hook_kw", "resident")

    def __init__(self, name, algo_kw, n_startup_jobs, hook_kw=None, resident=None):
        self.name = name
        self.algo_kw = dict(algo_kw)
        self.n_startup_jobs = int(n_startup_jobs)
        self.hook_kw = hook_kw
        self.resident = resident


def _unwrap_algo(algo):
    """Peel ``partial`` layers; the outermost keywords win."""
    kw = {}
    a = algo
    while isinstance(a, functools.partial):
        merged = dict(a.keywords or {})
        merged.update(kw)
        kw = merged
        a = a.func
    return a, kw


def resolve_engine_algo(algo):
    """Map the plugin-seam ``algo`` onto an :class:`EngineSpec`.

    Raises ``ValueError`` (naming the offender and the solo path) for
    anything the engine cannot serve bitwise: other algos, ``joint_ei``,
    ``speculative=k`` (the ask-ahead window replaces it) or unknown
    keywords."""
    from . import anneal as A
    from . import tpe as T

    a, kw = _unwrap_algo(algo)
    short = _ENGINE_MODULES.get(getattr(a, "__module__", "") or "")
    if short is None or getattr(a, "__name__", "") != "suggest":
        raise ValueError(
            f"fmin(engine=...) cannot route algo {algo!r} through the serve engine: "
            "supported are hyperopt_tpu_torch's tpe.suggest, anneal.suggest and "
            "atpe.suggest (partials included); pass engine=False for the solo path"
        )
    if kw.pop("speculative", 0):
        raise ValueError(
            "algo speculative=k is the solo driver's staleness-based dispatch "
            "amortization; the engine client's ask_ahead=k window replaces it without "
            "stale posteriors -- drop speculative= (or pass engine=False)"
        )
    kw.pop("max_stale", None)  # only meaningful with speculative
    # the engine's stacked state is resident by construction
    kw.pop("fused", None)
    kw.pop("ask_ahead", None)
    resident = kw.pop("resident", None)
    if short == "tpe":
        if kw.pop("joint_ei", False):
            raise ValueError(
                "joint_ei=True has no batched engine body; pass engine=False to use it"
            )
        algo_kw = dict(
            n_cand=int(kw.pop("n_EI_candidates", T._default_n_EI_candidates)),
            gamma=float(kw.pop("gamma", T._default_gamma)),
            lf=float(kw.pop("linear_forgetting", T._default_linear_forgetting)),
            prior_weight=float(kw.pop("prior_weight", T._default_prior_weight)),
            n_cand_cat=kw.pop("n_EI_candidates_cat", T._default_n_EI_candidates_cat),
            above_cap=kw.pop("above_cap", None),
        )
        n_startup = int(kw.pop("n_startup_jobs", T._default_n_startup_jobs))
        spec = EngineSpec("tpe", algo_kw, n_startup, resident=resident)
    elif short == "anneal":
        algo_kw = dict(
            avg_best_idx=float(kw.pop("avg_best_idx", A._default_avg_best_idx)),
            shrink_coef=float(kw.pop("shrink_coef", A._default_shrink_coef)),
        )
        # anneal warms at the first observation whatever n_startup_jobs
        spec = EngineSpec("anneal", algo_kw, 1, resident=resident)
    else:
        if kw.pop("mesh", None) is not None:
            raise ValueError(
                "atpe mesh= shards the candidate sweep of the SOLO dispatch; unsupported "
                "on the client path (pass engine=False)"
            )
        hook_kw = dict(
            n_startup_jobs=int(kw.pop("n_startup_jobs", 20)),
            linear_forgetting=int(kw.pop("linear_forgetting", 25)),
            lock_fraction=float(kw.pop("lock_fraction", 0.5)),
            elite_count=int(kw.pop("elite_count", 8)),
        )
        spec = EngineSpec("atpe", {}, hook_kw["n_startup_jobs"], hook_kw=hook_kw,
                          resident=resident)
    if kw:
        raise ValueError(
            f"fmin(engine=...) cannot map algo keyword(s) {sorted(kw)} onto the serve "
            "engine; pass engine=False for the solo path"
        )
    return spec


def _make_host_hook(spec, domain, trials):
    """ATPE's ``host_algo`` hook: the solo host-adaptive draw (the
    ``ATPEOptimizer`` settings and lock rolls over the client's live
    ``Trials``, the device sweep through ``tpe.suggest_dense``) without
    the doc building the client owns: bitwise the solo ``atpe.suggest``
    stream.  It runs inside the scheduler's round, on the round's
    thread."""
    from . import atpe
    from .pyll.stochastic import ensure_rng

    hk = spec.hook_kw
    if spec.resident is not None:
        from .torch_trials import obs_buffer_for

        obs_buffer_for(domain, trials, resident=bool(spec.resident))

    def hook(seed):
        opt = atpe._optimizer_for(domain, hk["lock_fraction"], hk["elite_count"])
        return atpe._dense_draw(domain, trials, opt, ensure_rng(int(seed)), 1,
                                hk["n_startup_jobs"], hk["linear_forgetting"])

    return hook


def _misc_vals(trial):
    """``{label: value}`` of one doc, as ``ObsBuffer`` ingests it, so what
    the client tells is what the solo buffer would have taken."""
    return {k: v[0] for k, v in trial["misc"]["vals"].items() if len(v) == 1}


def _client_guard(base_guard, fn):
    """The serve guard extended with the objective's identity: resuming a
    root under another objective is refused."""
    from .hyperband import _algo_identity

    return list(base_guard) + ["fmin-client", _algo_identity(fn)]


class EngineClient:
    """``FMinIter``'s view of the engine: one study, one ask-ahead window.

    Built by :func:`connect` and driven by ``FMinIter``, which keeps the
    evaluation machinery (``catch``, ``trial_timeout``, spans).  The
    client keeps the serve side: the submit-ahead window with
    ``Overloaded`` backoff, docs from served vals, tells and fails with
    their durable payloads, and restore."""

    def __init__(self, service, handle, spec, domain, trials, ask_ahead=1,
                 owns_service=True, max_submits=None, restored=False, shared_key=None):
        self.service = service
        self.handle = handle
        self.study = handle._study
        self.spec = spec
        self.domain = domain
        self.trials = trials
        self.ps = service.ps
        # clamped to the per-study queue cap: depth does not change the
        # stream, and an unclamped window would spin against the cap
        self.ask_ahead = max(1, min(int(ask_ahead), service.scheduler.study_queue_cap))
        self._shared_key = shared_key
        self.owns_service = owns_service
        #: the ask budget (max_evals): submits stop there, so the rstate
        #: cursor ends where the solo driver's would
        self.max_submits = float("inf") if max_submits is None else max_submits
        self.restored = restored
        self._queue = collections.deque()  # submitted-ahead requests
        self._recovering = bool(self.study.pending_asks or self.study.outstanding)
        self.durable = self.study.persist is not None
        self.closed = False

    @property
    def study_name(self):
        return self.study.name

    # -- the ask window ------------------------------------------------------
    def budget_left(self):
        return (self.study.next_tid < self.max_submits or bool(self._queue)
                or self._recovering)

    def _submit_one(self, deadline):
        """Submit one ask; an :class:`Overloaded` refusal sleeps its
        ``retry_after`` (capped) and retries until ``deadline``, then
        raises :class:`DeadlineExpired`."""
        from .serve.service import RETRY_AFTER_CAP

        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise DeadlineExpired(
                    f"client study {self.study_name!r}: ask window submit deadline exhausted"
                )
            try:
                req = self.service._submit(self.study, timeout=remaining)
            except Overloaded as e:
                wait = min(e.retry_after if e.retry_after else 0.05, RETRY_AFTER_CAP)
                if time.perf_counter() + wait >= deadline:
                    raise DeadlineExpired(
                        f"client study {self.study_name!r}: the engine stayed overloaded "
                        f"({e.reason}) past the client deadline; last retry_after hint "
                        f"was {wait}s"
                    ) from e
                time.sleep(wait)  # graftlint: disable=GL303 the backoff IS the server's typed retry_after hint, bounded by the client deadline above -- not an unbounded retry loop
                continue
            self._queue.append(req)
            return

    def next_suggestion(self, timeout=60.0):
        """The stream's next ``(tid, vals)``: an ask a crashed run left
        undelivered first, else the head of the submit-ahead window."""
        if self._recovering:
            if self.study.pending_asks or self.study.outstanding:
                return self.handle.ask(timeout=timeout, recover=True, backoff=True)
            self._recovering = False
        deadline = time.perf_counter() + float(timeout)
        while len(self._queue) < self.ask_ahead and self.study.next_tid < self.max_submits:
            self._submit_one(deadline)
        if not self._queue:
            raise RuntimeError(
                f"client study {self.study_name!r}: ask budget ({self.max_submits}) exhausted"
            )
        req = self._queue.popleft()
        return self.service._await(req, max(deadline - time.perf_counter(), 0.001))

    # -- docs ----------------------------------------------------------------
    def insert_new_doc(self, tid, vals):
        """One NEW doc from served vals: what the solo seam would insert
        (``docs_from_idxs_vals`` over the same labels)."""
        tid = int(tid)
        idxs = {label: ([tid] if label in vals else []) for label in self.ps.labels}
        vv = {label: ([vals[label]] if label in vals else []) for label in self.ps.labels}
        docs = docs_from_idxs_vals([tid], self.domain, self.trials, idxs, vv)
        self.trials.insert_trial_docs(docs)
        self.trials.refresh()
        for doc in reversed(self.trials._dynamic_trials):
            if doc["tid"] == tid:
                return doc
        raise RuntimeError(f"inserted doc for tid {tid} not found")

    # -- tells ---------------------------------------------------------------
    def record_tell(self, trial, result=None):
        """Report one outcome to the engine ahead of the doc finalizing: a
        finite ``STATUS_OK`` loss tells (with the full result when
        durable); anything else fails the tid durably, so resume never
        evaluates or serves it again."""
        tid = int(trial["tid"])
        loss = None
        ok = False
        if result is not None and result.get("status") == STATUS_OK:
            loss = result.get("loss")
            ok = loss is not None and np.isfinite(float(loss))
        if ok:
            self.handle.tell(tid, float(loss), vals=_misc_vals(trial),
                             result=SONify(result) if self.durable else None)
            return
        doc = None
        if self.durable:
            doc = SONify({"state": JOB_STATE_ERROR if result is None else JOB_STATE_DONE,
                          "misc": trial["misc"], "result": result})
        self.handle.fail(tid, doc=doc)

    # -- restore -------------------------------------------------------------
    def rebuild_trials(self, store=None):
        """Restore's client half: docs from the snapshot's client blob and
        the replayed WAL suffix (tell records finalize once, fail records
        rebuild their docs; served-but-untold asks are served again by
        the recover path, which builds their docs then).  Rebuilds into
        ``store`` when it is an empty sequential store, else into a new
        one of its class."""
        st = self.study
        blob = st.client_blob or {}
        docs_by_tid = {int(d["tid"]): d for d in blob.get("docs", ())}
        for rec in st.restore_records or ():
            kind = rec.get("kind")
            if kind == "tell":
                tid = int(rec["tid"])
                have = docs_by_tid.get(tid)
                if have is not None and have["state"] == JOB_STATE_DONE:
                    continue  # the bundle has the final doc
                result = rec.get("result") or {"status": STATUS_OK, "loss": float(rec["loss"])}
                doc = self.insert_doc_shape(tid, dict(rec["vals"]), result)
                doc["state"] = JOB_STATE_DONE
                docs_by_tid[tid] = doc
            elif kind == "fail":
                tid = int(rec["tid"])
                have = docs_by_tid.get(tid)
                if have is not None and have["state"] in (JOB_STATE_DONE, JOB_STATE_ERROR):
                    continue
                docs_by_tid[tid] = self._rebuild_fail_doc(tid, rec.get("doc") or {})
        st.client_blob = None
        st.restore_records = None
        if store is not None and not store._dynamic_trials:
            trials = store
        else:
            trials = (type(store) if store is not None else Trials)()
        docs = [docs_by_tid[t] for t in sorted(docs_by_tid)]
        if docs:
            trials.insert_trial_docs(docs)
            trials.refresh()
        self.trials = trials
        return trials

    def insert_doc_shape(self, tid, vals, result):
        """A doc (not inserted) from ``(tid, vals)``: deterministic, so
        WAL replay and the live loop build the same misc."""
        labels = sorted(self.ps.labels)
        misc = {
            "tid": tid,
            "cmd": self.domain.cmd,
            "workdir": self.domain.workdir,
            "idxs": {label: ([tid] if label in vals else []) for label in labels},
            "vals": {label: ([vals[label]] if label in vals else []) for label in labels},
        }
        store = self.trials if self.trials is not None else Trials()
        return store.new_trial_docs([tid], [None], [result], [misc])[0]

    def _rebuild_fail_doc(self, tid, payload):
        misc = payload.get("misc")
        state = payload.get("state", JOB_STATE_ERROR)
        result = payload.get("result")
        if result is None:
            result = {"status": "new"}
        if misc is not None:
            store = self.trials if self.trials is not None else Trials()
            doc = store.new_trial_docs([tid], [None], [result], [dict(misc)])[0]
        else:  # a bare fail record (a client without durability wrote it)
            doc = self.insert_doc_shape(tid, {}, result)
        doc["state"] = state
        return doc

    # -- durability ----------------------------------------------------------
    def maybe_snapshot(self):
        """The snapshot cadence at trial boundaries: the service leaves a
        client study's snapshots to here, so the doc blob never captures
        a trial whose tell is durable but whose doc is not DONE yet."""
        if self.durable:
            self.service._snapshot(self.study)

    def arm_durability(self):
        """Put the client's docs into the study's snapshot and publish the
        anchor snapshot of a new durable study: ``points_to_evaluate``
        must survive a crash before the first cadence boundary, and WAL
        replay is relative to a bundle."""
        if not self.durable:
            return
        st = self.study
        st.client_state_fn = lambda: {"format": 1,
                                      "docs": SONify(list(self.trials._dynamic_trials))}
        if not self.restored:
            _common.with_retries(lambda: self.service._snapshot(st, force=True),
                                 label="client anchor")

    def finalize(self):
        """The orderly end of a run: drop the queued window tail, publish
        the last snapshot, close the study (and the service, when this
        client owns it).  A crash never comes here: the WAL stays the
        truth."""
        if self.closed:
            return
        self.closed = True
        while self._queue:
            self.service.scheduler.drop_request(self._queue.popleft())
        if not self.owns_service:
            self.service.close_study(self.study_name)
        elif self._shared_key is None:
            self.service.shutdown()  # close_study snapshots inside
        else:
            with _SHARED_LOCK:
                if not _drop_hold(self._shared_key, self.service, shutdown=True):
                    self.service.close_study(self.study_name)

    def abandon(self):
        """The crash path: drop the registry hold without finalizing (no
        snapshot, no close), so a later ``connect()`` of the family builds
        a new service and restores from disk."""
        if self.closed:
            return
        self.closed = True
        if self._shared_key is not None:
            with _SHARED_LOCK:
                _drop_hold(self._shared_key, self.service, shutdown=False)


#: a reply's ``error_type`` -> the exception it is raised as: a server's
#: failure crosses the wire as a name and comes back typed
_REPLY_ERRORS = {
    "DeadlineExpired": DeadlineExpired,
    "DispatchTimeout": DispatchTimeout,
    "NetworkTimeout": NetworkTimeout,
    "OwnershipLost": OwnershipLost,
    "PeerUnreachable": PeerUnreachable,
    "ReplicaDead": ReplicaDead,
    "StudyPoisoned": StudyPoisoned,
    "StudyQuarantined": StudyQuarantined,
}


class RemoteStudy:
    """Exactly-once client of ONE study behind a TCP front.

    The transport discipline (the reference's :class:`hyperopt_tpu.
    client.RemoteStudy`):

    * every socket carries connect and read deadlines
      (:func:`~hyperopt_tpu_torch.serve.frames.dial`): a silent peer
      surfaces as :class:`NetworkTimeout`, never a hung thread;
    * a transport failure (reset, torn frame, missed deadline, refused
      connect) drops the connection and retries the op on a new one with
      bounded backoff: asks go again with ``recover=True`` (the service
      serves the oldest undelivered suggestion again, bitwise, instead of
      drawing a new seed), tells with their explicit ``vals`` (the WAL's
      tid dedup absorbs the duplicate), so a lost ack neither loses nor
      duplicates a trial;
    * a server's typed error comes back as its exception class;
    * ``Overloaded`` (queue caps, draining, the connection cap) is retried
      after the server's ``retry_after`` hint, capped at
      :data:`~hyperopt_tpu_torch.serve.service.RETRY_AFTER_CAP`.

    ``max_retries`` failed attempts on one op end in
    :class:`PeerUnreachable` (transport) or the last ``Overloaded``.  Not
    thread-safe: one RemoteStudy per driving thread.
    """

    def __init__(self, host, port, name, seed=0, connect_timeout=None, read_timeout=None,
                 net_plan=None, key=None, max_retries=8, create=True, takeover=False):
        from .serve.frames import DEFAULT_CONNECT_TIMEOUT, DEFAULT_READ_TIMEOUT

        self.host = host
        self.port = int(port)
        self.name = str(name)
        self.connect_timeout = (DEFAULT_CONNECT_TIMEOUT if connect_timeout is None
                                else float(connect_timeout))
        self.read_timeout = (DEFAULT_READ_TIMEOUT if read_timeout is None
                             else float(read_timeout))
        self.net_plan = net_plan
        self.key = key if key is not None else f"client/{name}"
        self.max_retries = int(max_retries)
        self.stats = collections.Counter()
        self._conn = None
        if create:
            self.call({"op": "create_study", "name": self.name, "seed": int(seed),
                       "takeover": bool(takeover)})

    # -- transport -----------------------------------------------------------
    def _connect(self):
        from .serve.frames import FrameConn, dial

        if self._conn is None:
            _sock, f = dial(self.host, self.port, connect_timeout=self.connect_timeout,
                            read_timeout=self.read_timeout, net_plan=self.net_plan,
                            key=self.key)
            self._conn = FrameConn(f)
        return self._conn

    def _drop(self):
        c, self._conn = self._conn, None
        if c is not None:
            c.close()

    def close(self):
        self._drop()

    def call(self, req, mutate=None):
        """One op, exactly once under a hostile network: bounded transport
        retries on new connections (``mutate`` rewrites the request for a
        resubmission: the ask's ``recover=True``), bounded ``Overloaded``
        backoff under the server's hint, typed re-raise of the rest."""
        from .distributed.faults import SimulatedCrash
        from .serve.frames import FrameError
        from .serve.service import RETRY_AFTER_CAP

        transport = (NetworkTimeout, PeerUnreachable, ConnectionError, FrameError, OSError)
        last = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.stats["retries"] += 1
                if mutate is not None:
                    req = mutate(req)
            try:
                reply = self._connect().call(req)
            except Overloaded as e:
                # the front's connection-cap refusal rides the hello line
                self._drop()
                last = e
                self.stats["typed:Overloaded"] += 1
                time.sleep(min(e.retry_after or 0.05, RETRY_AFTER_CAP))  # graftlint: disable=GL303 the backoff IS the server's typed retry_after hint, capped and bounded by the attempt budget
                continue
            except SimulatedCrash:
                # an armed network crash point: this client died in its
                # send/ack window; a harness restarting it starts clean
                self._drop()
                raise
            except transport as e:
                self._drop()
                last = e
                self.stats["transport_errors"] += 1
                self.stats[f"transport:{type(e).__name__}"] += 1
                time.sleep(min(0.01 * (attempt + 1), 0.05))  # graftlint: disable=GL303 bounded linear backoff under the max_retries attempt budget -- not an unbounded retry loop
                continue
            if reply.get("ok"):
                return reply
            etype = reply.get("error_type")
            if etype == "Overloaded":
                last = Overloaded(reply.get("error") or "overloaded",
                                  retry_after=reply.get("retry_after"),
                                  reason=reply.get("reason") or "queue_full")
                self.stats["typed:Overloaded"] += 1
                time.sleep(min(last.retry_after or 0.05, RETRY_AFTER_CAP))
                continue
            self.stats[f"typed:{etype}"] += 1
            exc = _REPLY_ERRORS.get(etype)
            if exc is not None:
                raise exc(reply.get("error") or etype)
            if etype == "FrameError":
                # the server closed after a framing error: a new connection
                self._drop()
                last = FrameError(reply.get("error") or "framing error")
                self.stats["transport_errors"] += 1
                continue
            raise RuntimeError(
                f"study {self.name!r}: server error {etype or '?'}: {reply.get('error')}")
        if isinstance(last, Overloaded):
            raise last
        raise PeerUnreachable(
            f"study {self.name!r}: {self.max_retries + 1} attempts exhausted against "
            f"{self.host}:{self.port} (last: {type(last).__name__ if last else '?'}: {last})"
        ) from (last if isinstance(last, Exception) else None)

    # -- the study API --------------------------------------------------------
    def ask(self, timeout=60.0):
        """The next ``(tid, vals)``; after a transport failure the ask goes
        again with ``recover=True``, so a suggestion the service already
        logged is delivered again bitwise, never drawn anew.  Every copy
        carries one ``ask_id``: the port's server serves them all as one
        tid, whichever reaches it first (the reference's server ignores
        the key)."""
        reply = self.call({"op": "ask", "study": self.name, "timeout": float(timeout),
                           "ask_id": uuid.uuid4().hex},
                          mutate=lambda r: dict(r, recover=True))
        return reply["tid"], reply["vals"]

    def tell(self, tid, loss, vals):
        """Report one result.  ``vals`` is required: a tell sent again after
        a lost ack carries its payload (the service refuses a bare tell for
        a tid it no longer holds), and the WAL's tid dedup absorbs it."""
        self.call({"op": "tell", "study": self.name, "tid": int(tid), "loss": float(loss),
                   "vals": vals})

    def best(self):
        return self.call({"op": "best", "study": self.name})["best"]

    def close_study(self):
        self.call({"op": "close_study", "study": self.name})
        self._drop()


def connect(engine, algo, domain, trials, rstate, fn=None, ask_ahead=1, root=None,
            require_existing=False, max_submits=None, recorder=None, fs=None):
    """Build the :class:`EngineClient` of one ``fmin`` call.

    ``engine`` is ``True`` (an in-process service on ``domain.device``,
    shared through the registry with concurrent clients of the same
    study family; ``fs=`` or ``recorder=`` make it private) or a
    caller's :class:`~hyperopt_tpu_torch.serve.SuggestService`.  ``root``
    makes the study durable; ``require_existing`` is ``resume_from=``'s
    posture (a root without the study is refused).  Returns ``(client,
    trials, rstate, restored)``: on restore the rebuilt store and the
    study's cursor supersede the ones passed in.
    """
    from .serve import SuggestService

    spec = resolve_engine_algo(algo)
    owns = not isinstance(engine, SuggestService)
    shared_key = None

    def build(**kw):
        service = SuggestService(
            domain.expr, algo=spec.name, root=root, background=False,
            n_startup_jobs=spec.n_startup_jobs, snapshot_cadence=CLIENT_SNAPSHOT_CADENCE,
            finite_check=False, device=domain.device, **kw, **spec.algo_kw)
        if fn is not None:
            service._guard = _client_guard(service._guard, fn)
        return service

    if owns:
        if fs is None and recorder is None:
            shared_key = _registry_key(spec, domain, fn, root)
            with _SHARED_LOCK:
                entry = _SHARED_SERVICES.get(shared_key)
                if entry is None:
                    entry = _SHARED_SERVICES[shared_key] = [
                        build(max_batch=SHARED_MAX_BATCH, study_queue_cap=SHARED_QUEUE_CAP,
                              max_queue=8 * SHARED_MAX_BATCH), 0]
                entry[1] += 1
                service = entry[0]
        else:
            service = build(max_batch=1, study_queue_cap=max(2, int(ask_ahead)),
                            max_queue=max(8, 2 * int(ask_ahead)), recorder=recorder,
                            **({} if fs is None else {"fs": fs}))
    else:
        service = engine
        if service.scheduler.algo != spec.name:
            raise ValueError(
                f"the provided engine serves algo {service.scheduler.algo!r} but fmin's "
                f"algo maps to {spec.name!r}"
            )
        if root is not None and service.root != str(root):
            raise ValueError(
                f"pass durability through the provided engine's root= (engine root "
                f"{service.root!r} != {root!r})"
            )
    if trials is None:
        trials = Trials()
    try:
        if require_existing:
            from .serve.service import StudyPersistence

            probe = StudyPersistence(service.root, CLIENT_STUDY, None, fs=service.fs)
            found = probe.exists()
            probe.close()
            if not found:
                raise CheckpointError(
                    f"resume_from root {service.root!r} holds no {CLIENT_STUDY!r} study "
                    "artifacts; pass trials_save_file= to start a new recoverable run "
                    "instead"
                )
        # the hook closes over the live store; a restore rebinds it below
        host_algo = _make_host_hook(spec, domain, trials) if spec.name == "atpe" else None
        # two clients of one shared service must not pick the same name
        with _SHARED_LOCK:
            study_name = _alloc_study_name(service)
            handle = service.create_study(study_name, seed=0, host_algo=host_algo)
        study = handle._study
        restored = bool(study.n_tells or study.pending_asks or study.outstanding
                        or study.client_blob or study.n_asks)
        client = EngineClient(service, handle, spec, domain, trials, ask_ahead=ask_ahead, owns_service=owns, max_submits=max_submits,
                              restored=restored, shared_key=shared_key)
        if restored:
            trials = client.rebuild_trials(trials)
            rstate = study.rstate  # the cursor after the last ask
            if spec.name == "atpe":
                study.host_algo = _make_host_hook(spec, domain, trials)
            logger.info("resumed %d trial doc(s) from %r (study %r); the rstate cursor is "
                        "restored, so the stream continues exactly", len(trials),
                        service.root, study_name)
        else:
            # the study's stream IS fmin's: submit-time seeds come off the
            # driver's own rstate
            study.rstate = rstate
        study.fresh_window = 1
        client.arm_durability()
        return client, trials, rstate, restored
    except BaseException:
        if shared_key is not None:
            with _SHARED_LOCK:
                _drop_hold(shared_key, service, shutdown=True)
        raise
