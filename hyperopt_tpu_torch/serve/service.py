"""The in-process service front of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.serve.service`'s
:class:`SuggestService` / :class:`StudyHandle` (``create_study / ask /
tell / best``), over the study-batched
:class:`~hyperopt_tpu_torch.serve.scheduler.BatchScheduler`: concurrent
asks from many studies coalesce into shared device rounds.  The service
runs on the card unless the caller passes ``device="cpu"``
(:func:`~hyperopt_tpu_torch.utils.resolve_device`); without a card it
raises.

Not ported yet, and refused with ``NotImplementedError`` naming the
``ROADMAP.md`` Queue A item that brings them: ``root=`` (per-study
write-ahead log and snapshots, item 12b), ``owner=`` (fleet claims,
item 12d) and ``host_algo=`` (the engine client, item 12a) here;
``mesh=`` (item 15), ``recorder=`` (item 12b), ``device_metrics_every``
(item 16) and ``algo="atpe"`` (item 12a) by the scheduler.  The socket
transport waits for item 12c.
"""

from __future__ import annotations

import re
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout

from ..distributed.faults import REAL_FS
from ..exceptions import DeadlineExpired, Overloaded
from ..obs.expo import render_prometheus
from ..ops.compile import compile_space
from .scheduler import BatchScheduler, ServeStudy

__all__ = ["RETRY_AFTER_CAP", "StudyHandle", "SuggestService"]

_NAME_RE = re.compile(r"[A-Za-z0-9._-]{1,120}")

#: ceiling on any server-provided ``retry_after`` hint a backoff loop
#: will honor (seconds)
RETRY_AFTER_CAP = 5.0


def _not_ported(what, item):
    return NotImplementedError(
        f"SuggestService({what}) is not ported yet: ROADMAP.md Queue A item {item}"
    )


class StudyHandle:
    """One tenant's view of the service: ``ask`` returns ``(tid,
    vals)``; evaluate, then ``tell(tid, loss)`` -- the service remembers
    what it suggested for every outstanding tid."""

    def __init__(self, service, study):
        self._service = service
        self._study = study

    @property
    def name(self):
        return self._study.name

    def ask_async(self):
        """Queue one ask; returns a Future of ``(tid, vals)``.  Raises
        :class:`~hyperopt_tpu_torch.exceptions.Overloaded` when admission
        control refuses the submit."""
        return self._service.scheduler.submit_ask(self._study).future

    def ask(self, timeout=60.0, backoff=False):
        """One suggestion, blocking until its round is served.

        ``timeout`` doubles as the CLIENT DEADLINE the scheduler sheds
        against: an ask still queued when it passes is dropped and raises
        :class:`~hyperopt_tpu_torch.exceptions.DeadlineExpired`.
        ``backoff=True`` turns an :class:`Overloaded` refusal into
        bounded retry under the same deadline (sleeping the refusal's
        ``retry_after``, capped at :data:`RETRY_AFTER_CAP`)."""
        deadline = time.perf_counter() + float(timeout)
        while True:
            remaining = deadline - time.perf_counter()
            try:
                req = self._service.scheduler.submit_ask(
                    self._study, deadline=time.perf_counter() + max(remaining, 0.0))
            except Overloaded as e:
                if not backoff:
                    raise
                wait = min(e.retry_after if e.retry_after else 0.05, RETRY_AFTER_CAP)
                if time.perf_counter() + wait >= deadline:
                    raise DeadlineExpired(
                        f"study {self._study.name!r}: the service stayed overloaded "
                        f"({e.reason}) past the client deadline ({timeout}s); last "
                        f"retry_after hint was {wait}s"
                    ) from e
                time.sleep(wait)
                continue
            return self._service._await(req, max(remaining, 0.0))

    def tell(self, tid, loss, vals=None):
        """Report one evaluation.  ``vals`` defaults to what the service
        served for ``tid``; pass it to tell a trial the service did not
        suggest (a warm start)."""
        study = self._study
        if vals is None:
            vals = study.outstanding.get(tid)
        if vals is None:
            raise ValueError(
                f"study {study.name!r} has no outstanding suggestion for tid "
                f"{tid}; pass vals= explicitly"
            )
        self._service.scheduler.tell(study, tid, vals, loss)

    def fail(self, tid):
        """Report one FAILED evaluation: the suggestion for ``tid`` is
        retired and nothing enters the posterior."""
        self._service.scheduler.tell_failure(self._study, tid)

    def best(self):
        """``{"loss", "vals"}`` of the best completed trial, or None."""
        out = self._study.best()
        if out is None:
            return None
        loss, vals = out
        return {"loss": loss, "vals": vals}

    @property
    def n_tells(self):
        return self._study.n_tells

    def close(self):
        self._service.close_study(self.name)


class SuggestService:
    """The multi-tenant suggestion service over one space.

    ``background=True`` (default) runs the continuous-batching loop on
    a daemon thread: concurrent ``ask()`` calls from many studies
    coalesce into shared device rounds under the ``max_wait_ms``
    latency budget.  ``background=False`` is the deterministic mode:
    submit with ``ask_async`` and serve rounds with :meth:`pump`
    (blocking ``ask`` pumps inline).  ``device`` is where the stacked
    state and every round live (None = the card).  ``algo`` is
    ``"tpe"`` or ``"anneal"``; ``algo_kw`` (``n_cand``, ``gamma``,
    ``lf``, ``prior_weight``, ``n_cand_cat``, ``above_cap`` /
    ``avg_best_idx``, ``shrink_coef``) parameterize its step.
    """

    def __init__(self, space, algo="tpe", root=None, max_batch=64, max_wait_ms=2.0,
                 n_startup_jobs=20, background=True, fs=REAL_FS, max_queue=None,
                 study_queue_cap=None, dispatch_timeout=None, finite_check=True,
                 mesh=None, owner=None, recorder=None, device_metrics_every=0,
                 retry_jitter=0.25, retry_jitter_seed=0, device=None, **algo_kw):
        if root is not None:
            raise _not_ported("root= (per-study write-ahead log and snapshots)", "12b")
        if owner is not None:
            raise _not_ported("owner= (fleet claims)", "12d")
        self.space = space
        self.ps = compile_space(space, device=device)
        self.device = self.ps.device
        self._background = bool(background)
        self._lock = threading.RLock()
        self._handles = {}
        self.scheduler = BatchScheduler(
            self.ps, algo=algo, max_batch=max_batch, max_wait=float(max_wait_ms) / 1000.0,
            n_startup_jobs=n_startup_jobs, fs=fs, max_queue=max_queue,
            study_queue_cap=study_queue_cap, dispatch_timeout=dispatch_timeout,
            finite_check=finite_check, mesh=mesh, recorder=recorder,
            device_metrics_every=device_metrics_every, retry_jitter=retry_jitter,
            retry_jitter_seed=retry_jitter_seed, **algo_kw,
        )
        self.recorder = self.scheduler.recorder
        if self._background:
            self.scheduler.start()

    # -- tenancy -----------------------------------------------------------
    def create_study(self, name, seed=0, host_algo=None):
        """Open (or re-attach to) a study by name."""
        if host_algo is not None:
            raise _not_ported("host_algo= (the engine client's per-study hook)", "12a")
        if not _NAME_RE.fullmatch(name):
            raise ValueError(f"study name {name!r} must match {_NAME_RE.pattern}")
        with self._lock:
            handle = self._handles.get(name)
            if handle is None:
                study = ServeStudy(name, seed, self.ps)
                self.scheduler.open_study(name, seed, study=study)
                handle = self._handles[name] = StudyHandle(self, study)
            return handle

    def close_study(self, name):
        with self._lock:
            if self._handles.pop(name, None) is not None:
                self.scheduler.close_study(name)

    def studies(self):
        with self._lock:
            return sorted(self._handles)

    def _await(self, req, timeout):
        """Block on one admitted ask under its client deadline: pump
        inline in deterministic mode, wait in background mode; on expiry,
        drop the request from the queue or grace-wait a round that
        already picked it."""
        fut = req.future
        if not self._background:
            while not fut.done():
                if self.scheduler.step() == 0 and not fut.done():
                    if req.deadline is not None and time.perf_counter() > req.deadline:
                        break
                    time.sleep(0.001)
            if fut.done():
                return fut.result(timeout=0)
        else:
            try:
                return fut.result(timeout=timeout)
            except FutureTimeout:
                pass
        if self.scheduler.drop_request(req):
            return fut.result(timeout=0)  # raises DeadlineExpired
        grace = self.scheduler.dispatch_timeout or 5.0
        return fut.result(timeout=2.0 * grace + 1.0)

    # -- service-level controls --------------------------------------------
    def pump(self):
        """Serve one coalesced round inline (deterministic mode)."""
        return self.scheduler.step()

    @property
    def counters(self):
        s = self.scheduler
        return {
            "dispatch_count": s.dispatch_count,
            "delta_drain_dispatches": s.delta_drain_dispatches,
            "upload_events": s.upload_events,
            "upload_bytes": s.upload_bytes,
            "joins": s.joins,
            "rebuckets": s.rebuckets,
            "admitted_count": s.admitted_count,
            "shed_count": s.shed_count,
            "guard_checks": s.guard_checks,
            "quarantine_count": s.quarantine_count,
            "evictions": s.evictions,
            "watchdog_timeouts": s.watchdog_timeouts,
            "watchdog_retries": s.watchdog_retries,
            "watchdog_recoveries": s.watchdog_recoveries,
        }

    def metrics_rows(self):
        """Refresh the point-in-time gauges, then one snapshot-consistent
        collect of the scheduler's registry."""
        s = self.scheduler
        m = s.metrics
        with self._lock:
            n_studies = len(self._handles)
        m.gauge("serve_studies", "open studies").set(n_studies)
        m.gauge("serve_queue_depth", "asks queued").set(len(s._asks))
        m.gauge("serve_ready", "1 = accepting asks").set(1 if self.ready() else 0)
        return m.collect()

    def metrics_text(self):
        return render_prometheus(self.metrics_rows())

    def ready(self):
        """False while draining, circuit-broken or stopped."""
        s = self.scheduler
        return not (s.draining or s.circuit_open or s._stopping)

    def health(self):
        """Status, tenancy, queue occupancy and the counters."""
        s = self.scheduler
        if s._stopping:
            status = "stopped"
        elif s.circuit_open:
            status = "circuit_open"
        elif s.draining:
            status = "draining"
        else:
            status = "ok"
        with self._lock:
            n_studies = len(self._handles)
        return {
            "status": status,
            "ready": self.ready(),
            "studies": n_studies,
            "queue_depth": len(s._asks),
            "max_queue": s.max_queue,
            "max_batch": s.max_batch,
            "device": str(self.device),
            "counters": self.counters,
        }

    def drain(self, timeout=30.0, block=True):
        """Refuse new asks with ``Overloaded(reason="draining")``, serve
        what is queued, then shut down (``block=False`` only enters
        draining mode)."""
        self.scheduler.drain(timeout=timeout)
        if not block:
            return
        deadline = time.perf_counter() + float(timeout)
        while self.scheduler._asks and time.perf_counter() < deadline:
            if not self._background:
                self.scheduler.step()
            else:
                time.sleep(0.01)
        self.shutdown()

    def shutdown(self):
        self.scheduler.stop()
        with self._lock:
            for name in list(self._handles):
                self.close_study(name)
        self.recorder.flush()
        self.recorder.close()
