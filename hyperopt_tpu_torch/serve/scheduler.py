"""The continuous-batching scheduler of the PyTorch port: coalesce many
studies' asks into one device step.

The counterpart of :mod:`hyperopt_tpu.serve.scheduler`.  Incoming asks
queue up; a dispatch round picks at most one ask per study, fills a
SLOTTED batch (fixed pow2 slot capacities + an active-slot mask, so
studies join and leave without changing the step's shapes --
:func:`~hyperopt_tpu_torch.serve.batched.slot_capacity`), rides every
slot's staged O(D) tell delta along, and runs ONE
:func:`~hyperopt_tpu_torch.serve.batched.build_batched_step_fn` step for
the whole round.  A background thread drives rounds under a
latency/occupancy budget; tests drive :meth:`BatchScheduler.step`
synchronously instead, so simulated crashes reach the caller.

Determinism: each study draws its per-ask seed from its OWN
``np.random.Generator`` stream at SUBMIT time, so a study's suggestion
sequence is a pure function of its seed and its own tells --
independent of batching order, sibling churn or slot placement.

Tells are absorbed synchronously: the study's write-ahead record (when
the service persists it), host ``ObsBuffer.add``, then an O(D) delta
staged for the slot.  Under group commit (the default) a tell's record is
flushed at once and ONE fsync per touched WAL runs at the next round,
before its dispatch.  A backlog past one delta drains through the
stacked masked-delta write; late tells and bucket growth re-materialize
the stacked state from host truth into new tensors.

One round reads the device twice: the suggestion columns, and the
finite-check verdicts.  Nothing read from the device feeds the step.

The guard (admission control with a per-study fairness cap and jittered
``retry_after``; the finite check with quarantine and eviction; the
dispatch watchdog with one retry and a circuit breaker) is the
reference's, and so are the engine client's two gates: a study's
``fresh_window`` holds a queued ask back until every suggestion served
to it has its tell (so an ask-ahead client's every dispatch sees the
full posterior), and a study with a ``host_algo`` hook (ATPE, whose host
decision layer cannot run across studies) is served by its hook inside
the round, on the round's thread, and holds no slot.  With
``device_metrics_every=k`` a read-only metrics twin
(:func:`~hyperopt_tpu_torch.obs.device.build_device_metrics_fn`) reads
the stacked state every ``k`` rounds, after the round's futures are
resolved; at 0 it is never built.

``mesh=`` (a 1-D ``study`` mesh inside this process) shards the slot
axis: slots stripe over the shards (a new study takes a free slot on the
least occupied shard), a dirty slot rebuilds only its own shard when the
geometry holds (``shard_restacks``), and the finite check and quarantine
stay shard-local.  Every slot's stream is the unsharded engine's.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import math
import random
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np
import torch

from ..distributed._common import is_transient
from ..distributed.faults import REAL_FS
from ..exceptions import (
    DeadlineExpired,
    DispatchTimeout,
    Overloaded,
    StudyPoisoned,
    StudyQuarantined,
)
from ..obs.flightrec import NULL_RECORDER
from ..obs.registry import (
    LATENCY_BUCKETS_MS,
    RATIO_BUCKETS,
    CounterAttr,
    HistogramAttr,
    MetricsRegistry,
)
from ..ops.cuda_build import LaunchTally
from ..ops.gmm_scores import KERNEL
from ..torch_trials import MAX_PENDING_DELTAS, MIN_CAPACITY, ObsBuffer
from .batched import (
    _dummy_delta,
    build_batched_delta_fn,
    build_batched_step_fn,
    build_finite_check_fn,
    mesh_shards,
    restack_shards,
    slot_capacity,
    stack_states,
)

logger = logging.getLogger(__name__)

__all__ = ["BatchScheduler", "ServeStudy", "dense_to_vals", "draw_seed"]

#: ring-buffer length for the timing metrics (``ask_latencies`` /
#: ``occupancy``): plenty for any bench window, bounded for a
#: long-running service
METRICS_WINDOW = 65536

#: consecutive finite-check trips before a poisoned study is EVICTED
QUARANTINE_TRIPS = 3

#: consecutive failed dispatch rounds (after their retry) before the
#: batcher circuit-breaks into reject-with-Overloaded mode
CIRCUIT_THRESHOLD = 3

_KEY_MASK = 0xFFFFFFFF


def draw_seed(rstate):
    """One per-ask seed off ``rstate``'s stream -- the submit-time draw
    (``np.random.Generator`` or the legacy ``RandomState``)."""
    if hasattr(rstate, "integers"):
        return int(rstate.integers(2**31 - 1))
    return int(rstate.randint(2**31 - 1))


def _cat_set(ps):
    """The categorical-dim index set, cached on the PackedSpace."""
    cat = getattr(ps, "_serve_cat_set", None)
    if cat is None:
        cat = ps._serve_cat_set = frozenset(int(d) for d in ps.cat_idx)
    return cat


def dense_to_vals(ps, col_v, col_a):
    """One dense suggestion column -> the {label: value} config dict at
    API types (ints for categorical-family dims, inactive conditional
    dims omitted)."""
    cat = _cat_set(ps)
    labels = ps.labels
    vals = {}
    for d in np.nonzero(np.asarray(col_a))[0]:
        d = int(d)
        v = float(col_v[d])
        vals[labels[d]] = int(round(v)) if d in cat else v
    return vals


class ServeStudy:
    """One tenant: host-truth history + seed stream + slot bookkeeping.
    The host :class:`~hyperopt_tpu_torch.torch_trials.ObsBuffer` is
    authoritative; the device only holds a slot-wise mirror of it.

    The engine client's fields: ``persist`` (the service's
    :class:`~hyperopt_tpu_torch.serve.service.StudyPersistence`, or None),
    ``host_algo`` (``hook(seed) -> (values [D, 1], active [D, 1])``,
    serving this study instead of the stacked step), ``fresh_window``
    (None, or the most served-but-untold suggestions before a queued ask
    may be picked), ``client_state_fn`` (extra durable state for the
    snapshot), ``client_blob``/``restore_records`` (what a restore
    hands back to the client), ``claim`` (a fleet replica's
    :class:`~hyperopt_tpu_torch.serve.fleet.StudyClaim`) and ``ask_keys``
    (the socket client's ask keys and the tids they were served as, the
    most recent ``ASK_KEYS_KEPT``: a resubmitted ask gets its first tid
    again)."""

    def __init__(self, name, seed, ps):
        self.name = name
        self.seed = int(seed)
        self.rstate = np.random.default_rng(self.seed)
        self.buf = ObsBuffer(ps)
        self.slot = None
        self.pending = collections.deque()  # staged (idx, vcol, acol, loss)
        self.dirty = True  # device slot needs re-materialization
        self.closed = False
        self.quarantined = False  # evicted by the finite-check guard
        self.poison_trips = 0  # CONSECUTIVE finite-check trips
        self.next_tid = 0
        self.n_asks = 0
        self.n_tells = 0
        self.outstanding = {}  # tid -> served vals (awaiting their tell)
        self.pending_asks = {}  # tid -> seed: logged, not served yet
        self.persist = None
        self.claim = None  # the fleet's StudyClaim, when the service has an owner
        self.host_algo = None
        self.fresh_window = None
        self.client_state_fn = None
        self.client_blob = None
        self.restore_records = None
        self.ask_keys = collections.OrderedDict()

    def best(self):
        """(loss, vals) of the best finite completed trial, or None."""
        buf = self.buf
        ok = buf.valid[: buf.count] & np.isfinite(buf.losses[: buf.count])
        if not ok.any():
            return None
        i = int(np.argmin(np.where(ok, buf.losses[: buf.count], np.inf)))
        return float(buf.losses[i]), dense_to_vals(buf.space, buf.values[:, i],
                                                   buf.active[:, i])


class _AskRequest:
    __slots__ = ("study", "tid", "seed", "future", "t_submit", "deadline")

    def __init__(self, study, tid, seed, deadline=None):
        self.study = study
        self.tid = tid
        self.seed = seed
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter() instant


class BatchScheduler:
    """The slotted continuous-batching engine for one space.

    ``max_batch`` caps the slot capacity (and so the number of
    concurrently open studies); ``max_wait`` is the latency budget a
    queued ask may wait for co-batching before the background loop
    dispatches anyway.  ``algo`` is ``"tpe"`` or ``"anneal"``;
    ``algo_kw`` passes through to :func:`~hyperopt_tpu_torch.serve.
    batched.build_batched_step_fn`.  ``fs`` is the fault seam: the serve
    crash points fire through it, and a
    :class:`~hyperopt_tpu_torch.distributed.faults.DeviceFaultPlan`
    riding it (``fs.plan.device``) injects device faults.  The device is
    the space's (``ps.device``); every round runs under
    ``torch.cuda.device`` of it, whichever thread drives the round.

    Deterministic counters (never timing): ``dispatch_count``,
    ``delta_drain_dispatches`` (included in ``dispatch_count``),
    ``upload_events`` / ``upload_bytes``, ``joins``, ``rebuckets``,
    ``shard_restacks`` (shard-local re-materializations on a mesh), the
    guard's counters, ``host_algo_served`` (asks a study's hook served;
    not part of ``dispatch_count``), ``group_commit_barriers`` (round
    fsyncs) and ``device_metric_dispatches`` (the metrics twin's runs,
    every ``device_metrics_every`` engine rounds; not part of
    ``dispatch_count``).  ``ask_latencies`` / ``occupancy`` are bounded timing
    windows.  ``recorder`` (a :class:`~hyperopt_tpu_torch.obs.
    FlightRecorder`) records the ask/tell spans; it reads no device
    state and changes no stream.  ``group_commit=False`` fsyncs every
    tell record on its own.

    The guard: a bounded ask queue (``max_queue``, default ``4 *
    max_batch``) with a per-study fairness cap (``study_queue_cap``),
    refused BEFORE the seed draw with :class:`Overloaded` (a jittered
    ``retry_after``) or :class:`DeadlineExpired`; a finite check after
    every step that fails only the poisoned slot's client
    (:class:`StudyPoisoned`), re-materializes it, and evicts it after
    ``quarantine_trips`` consecutive trips (:class:`StudyQuarantined`);
    and, with ``dispatch_timeout`` set, a watchdog that retries a timed
    out or transiently failing round once against newly allocated state
    and opens a circuit breaker after ``circuit_threshold`` failed
    rounds.
    """

    dispatch_count = CounterAttr("serve_dispatch_total", "batched steps run")
    delta_drain_dispatches = CounterAttr(
        "serve_delta_drain_dispatches_total",
        "backlog-drain delta writes (included in serve_dispatch_total)")
    upload_events = CounterAttr("serve_upload_events_total", "stacked re-materializations")
    upload_bytes = CounterAttr("serve_upload_bytes_total", "bytes re-uploaded to device")
    joins = CounterAttr("serve_joins_total", "studies joined")
    rebuckets = CounterAttr("serve_rebuckets_total", "slot/obs geometry growth events")
    shard_restacks = CounterAttr("serve_shard_restacks_total",
                                 "shard-local re-materializations (study mesh)")
    admitted_count = CounterAttr("serve_admitted_total", "asks admitted past admission control")
    shed_count = CounterAttr("serve_shed_total", "Overloaded + DeadlineExpired refusals")
    guard_checks = CounterAttr("serve_guard_checks_total", "finite checks run")
    quarantine_count = CounterAttr("serve_quarantine_trips_total",
                                   "finite-check trips (per slot-round)")
    evictions = CounterAttr("serve_evictions_total", "studies evicted after K trips")
    watchdog_timeouts = CounterAttr("serve_watchdog_timeouts_total",
                                    "dispatch watchdog deadline hits")
    watchdog_retries = CounterAttr("serve_watchdog_retries_total", "watchdog retry rounds")
    watchdog_recoveries = CounterAttr("serve_watchdog_recoveries_total",
                                      "watchdog retries that healed")
    device_metric_dispatches = CounterAttr(
        "serve_device_metric_dispatches_total",
        "device-metrics twin dispatches (cadence-gated; not part of serve_dispatch_total)")
    host_algo_served = CounterAttr(
        "serve_host_algo_served_total",
        "asks served by a per-study host_algo hook (not part of serve_dispatch_total)")
    group_commit_barriers = CounterAttr(
        "serve_group_commit_barriers_total",
        "round fsync barriers (one covers every tell flushed since the previous round)")
    ask_latencies = HistogramAttr("serve_ask_latency_seconds", "submit-to-ack ask latency",
                                  window=METRICS_WINDOW)
    occupancy = HistogramAttr("serve_batch_occupancy", "filled-slot fraction per round",
                              buckets=RATIO_BUCKETS, window=METRICS_WINDOW)
    watchdog_recovery_ms = HistogramAttr("serve_watchdog_recovery_ms",
                                         "watchdog retry-to-heal latency",
                                         buckets=LATENCY_BUCKETS_MS, window=METRICS_WINDOW)

    def __init__(self, ps, algo="tpe", max_batch=64, max_wait=0.002, n_startup_jobs=20,
                 fs=REAL_FS, max_queue=None, study_queue_cap=None, dispatch_timeout=None,
                 finite_check=True, quarantine_trips=QUARANTINE_TRIPS,
                 circuit_threshold=CIRCUIT_THRESHOLD, mesh=None, recorder=None,
                 device_metrics_every=0, retry_jitter=0.25, retry_jitter_seed=0,
                 group_commit=True, **algo_kw):
        self.metrics = MetricsRegistry("serve")
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.span_ids = {}  # stamped on every span (a fleet replica's id)
        # the gmm_llr launches of this scheduler's own rounds, whatever
        # other services of the process launch meanwhile
        self._launch_tally = LaunchTally()
        self.device_metrics_every = int(device_metrics_every)
        self._device_metrics_fn = None  # built at the first dispatch due
        self._device_metrics_due = False
        self.ps = ps
        self.device = ps.device
        self.algo = str(algo)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.n_startup_jobs = int(n_startup_jobs)
        self.fs = fs
        # a 1-D study mesh shards the slot axis: capacity rounds to a
        # multiple of the shard count, and re-materialization and the
        # quarantine stay shard-local
        self.mesh = mesh
        if mesh is not None:
            axes = list(mesh.shape)
            if len(axes) != 1:
                raise ValueError(
                    f"BatchScheduler mesh must be 1-D (the study axis); got axes {axes}")
            self._mesh_axis, self._n_shards = mesh_shards(mesh, axes[0], ps.device)
        else:
            self._mesh_axis = None
            self._n_shards = 1
        self.max_queue = 4 * self.max_batch if max_queue is None else int(max_queue)
        # fairness: one tenant may hold at most this many queued asks
        # (default: an even share, floored at 2)
        self.study_queue_cap = (max(2, self.max_queue // self.max_batch)
                                if study_queue_cap is None else int(study_queue_cap))
        self.dispatch_timeout = None if dispatch_timeout is None else float(dispatch_timeout)
        # queue-based refusals jitter their retry_after from a SEEDED
        # scheduler-private rng, drawn only after admission refused, so
        # no suggestion stream can observe it
        self.retry_jitter = float(retry_jitter)
        self._retry_rng = random.Random(int(retry_jitter_seed))
        self.finite_check = bool(finite_check)
        self.quarantine_trips = int(quarantine_trips)
        self.circuit_threshold = int(circuit_threshold)
        self._device_faults = getattr(getattr(fs, "plan", None), "device", None)
        # group commit: tells append flush-only and ONE fsync per touched
        # WAL runs at the next round, before its dispatch
        self.group_commit = bool(group_commit)
        self._pending_barrier = set()  # TellWALs flushed, not barriered
        self.algo_kw = dict(algo_kw)
        # "atpe" studies are served by their host_algo hook, never by the
        # stacked step: the step family stays TPE's (built, never run)
        self._engine_algo = "tpe" if self.algo == "atpe" else self.algo
        if self._engine_algo == "tpe":
            from ..tpe import _resolve_above_cap

            self._pow2_cap = _resolve_above_cap(self.algo_kw.get("above_cap"))
        else:
            self._pow2_cap = None
        engine_kw = {} if self.algo == "atpe" else self.algo_kw
        mesh_kw = dict(mesh=mesh, mesh_axis=self._mesh_axis)
        self._step_fn = build_batched_step_fn(ps, algo=self._engine_algo, **mesh_kw,
                                              **engine_kw)
        self._delta_fn = build_batched_delta_fn(**mesh_kw)
        self._finite_fn = build_finite_check_fn(**mesh_kw)

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._asks = collections.deque()
        self._studies = {}
        self._slots = {}  # slot index -> ServeStudy
        self._free = []
        self._state = None  # StudyBatchState (device)
        self._slot_cap = 0
        self._bucket = MIN_CAPACITY
        self._materialize = True
        self._thread = None
        self._stopping = False

        self.draining = False
        self.drain_deadline = None  # absolute perf_counter() instant
        self.circuit_open = False
        self._round_failures = 0  # CONSECUTIVE failed dispatch rounds
        self._queued_per_study = collections.Counter()
        self._abandoned = []  # dispatch threads the watchdog gave up on
        # touch every series so a scrape of an idle scheduler is complete
        for attr in ("dispatch_count", "delta_drain_dispatches", "upload_events",
                     "upload_bytes", "joins", "rebuckets", "shard_restacks", "admitted_count",
                     "shed_count",
                     "guard_checks", "quarantine_count", "evictions", "watchdog_timeouts",
                     "watchdog_retries", "watchdog_recoveries", "device_metric_dispatches",
                     "host_algo_served", "group_commit_barriers", "ask_latencies", "occupancy",
                     "watchdog_recovery_ms"):
            getattr(self, attr)
        self._delta_cache = None

    @contextlib.contextmanager
    def _on_device(self):
        """The round's CUDA device context (the background loop and the
        watchdog's worker are threads of their own), with the kernel's
        launches on this thread counted as this scheduler's."""
        device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                  else contextlib.nullcontext())
        with device, KERNEL.counting_into(self._launch_tally):
            yield

    @property
    def kernel_launches(self):
        """``gmm_llr`` launches made by this scheduler's rounds."""
        return self._launch_tally.n

    # -- tenancy -----------------------------------------------------------
    def _alloc_slot(self):
        """The next study's slot (lock held).  Unsharded: the lowest freed
        slot, else the next new one.  On a mesh: the free slot on the
        shard that holds the fewest studies (lowest index on ties), so
        tenants stripe over the shards and each shard's rebuilds stay
        small."""
        if self._n_shards == 1:
            if self._free:
                return self._free.pop()
            return len(self._studies)
        cap = max(self._slot_cap, slot_capacity(len(self._studies) + 1, self.max_batch,
                                                shards=self._n_shards))
        blk = max(1, cap // self._n_shards)
        occ = collections.Counter(s // blk for s in self._slots)
        slot = min((s for s in range(cap) if s not in self._slots),
                   key=lambda s: (occ.get(s // blk, 0), s))
        if slot in self._free:
            self._free.remove(slot)
        return slot

    def open_study(self, name, seed=0, study=None):
        """Join a (new or restored) study to the slotted batch; a study
        with a ``host_algo`` hook takes no slot."""
        with self._lock:
            if name in self._studies:
                raise ValueError(f"study {name!r} already open")
            if len(self._studies) >= self.max_batch:
                raise ValueError(
                    f"batch capacity {self.max_batch} studies reached; "
                    "close a study or raise max_batch"
                )
            st = study if study is not None else ServeStudy(name, seed, self.ps)
            if st.host_algo is None:
                st.slot = self._alloc_slot()
                st.dirty = True  # _maintain re-materializes
                self._slots[st.slot] = st
            else:
                st.slot = None
            self._studies[name] = st
            self.joins += 1
            return st

    def close_study(self, name):
        """Leave: free the slot (its device data becomes garbage behind
        the active-slot mask; siblings are untouched, no re-upload).  An
        evicted study has no slot to free."""
        with self._lock:
            st = self._studies.pop(name)
            st.closed = True
            if st.slot is not None:
                self._slots.pop(st.slot, None)
                self._free.append(st.slot)
                self._free.sort(reverse=True)  # reuse lowest slots first
                st.slot = None
            self._queued_per_study.pop(name, None)
            return st

    def study(self, name):
        with self._lock:
            return self._studies[name]

    # -- tell --------------------------------------------------------------
    def tell(self, study, tid, vals, loss, result=None):  # graftlint: disable=GL503 the WAL append IS the tell's durability barrier and must be ordered inside the study's tell linearization (write-ahead-then-apply); moving it outside the lock reorders tells against dedup and delta staging
        """Absorb one completed trial: WAL record first, host buffer
        second, device delta staged third.  Idempotent by tid: a tell a
        restore already replayed is absorbed once.  ``result`` (JSON-able)
        rides the WAL record."""
        rec = self.recorder
        with self._lock:
            if study.quarantined:
                raise StudyQuarantined(
                    f"study {study.name!r} was evicted by the finite-"
                    "check guard; close it and open a fresh study"
                )
            buf = study.buf
            if (buf.tids[: buf.count] == int(tid)).any():
                study.outstanding.pop(tid, None)
                return
            t0 = time.perf_counter() if rec.enabled else 0.0
            if study.persist is not None:
                study.persist.log_tell(tid, vals, loss, result=result,
                                       sync=not self.group_commit)
                if self.group_commit:
                    self._pending_barrier.add(study.persist.wal)
            if rec.enabled:
                t1 = time.perf_counter()
                rec.record("tell.wal_append", t0, t1, study=study.name, tid=int(tid),
                           **self.span_ids)
            self.fs.crashpoint("serve_after_wal_before_dispatch")
            self._apply_tell(study, tid, vals, loss)
            study.outstanding.pop(tid, None)
            study.pending_asks.pop(int(tid), None)
            if rec.enabled:
                t2 = time.perf_counter()
                rec.record("tell.applied", t1, t2, study=study.name, tid=int(tid),
                           **self.span_ids)
                rec.record("tell", t0, t2, study=study.name, tid=int(tid), loss=float(loss),
                           **self.span_ids)
            # a tell can open a study's fresh_window gate
            self._cond.notify_all()

    def tell_failure(self, study, tid, doc=None):
        """Absorb one FAILED trial: nothing enters the posterior, but the
        outcome (with the JSON-able ``doc``) is logged before the
        outstanding suggestion is retired, so a resumed client neither
        evaluates nor serves it again."""
        with self._lock:
            buf = study.buf
            if (buf.tids[: buf.count] == int(tid)).any():
                return  # already told ok earlier: nothing to fail
            if study.persist is not None:
                study.persist.log_fail(tid, doc=doc)
            study.next_tid = max(study.next_tid, int(tid) + 1)
            study.outstanding.pop(int(tid), None)
            study.pending_asks.pop(int(tid), None)
            self._cond.notify_all()

    def _apply_tell(self, study, tid, vals, loss):
        buf = study.buf
        n = buf.count
        in_order = n == 0 or tid > int(buf.tids[n - 1])
        buf.add(dict(vals), float(loss), tid=int(tid))
        study.n_tells += 1
        study.next_tid = max(study.next_tid, int(tid) + 1)
        if in_order and not study.dirty and len(study.pending) < MAX_PENDING_DELTAS:
            study.pending.append((n, buf.values[:, n].copy(), buf.active[:, n].copy(),
                                  float(loss)))
        else:
            # a late completion shifted the tail (or the backlog is past
            # the crossover): the slot re-materializes from host truth
            study.dirty = True
            study.pending.clear()

    # -- ask ---------------------------------------------------------------
    def retry_after(self):
        """The back-off hint an :class:`Overloaded` refusal carries: the
        rounds pending at current occupancy x the p50 ask latency (10 ms
        with no latency history yet)."""
        with self._lock:
            rounds = max(1, math.ceil((len(self._asks) + 1) / max(1, self.max_batch)))
            lats = sorted(self.ask_latencies)
        p50 = lats[len(lats) // 2] if lats else 0.010
        return round(rounds * p50, 6)

    def _jittered(self, base):
        """Seeded, bounded jitter on a queue-based hint: ``[base, base *
        (1 + retry_jitter)]``.  Draining refusals stay exact."""
        if self.retry_jitter <= 0.0:
            return base
        frac = self.retry_jitter * self._retry_rng.random()
        return round(base * (1.0 + frac), 6)

    def drain_retry_after(self):
        """The hint a ``draining`` refusal carries: time left until the
        drain deadline, floored at one queue-drain estimate."""
        floor = self.retry_after()
        if self.drain_deadline is None:
            return floor
        left = self.drain_deadline - time.perf_counter()  # graftlint: disable=GL307 deadline arithmetic (time left until the published drain deadline), not an ad-hoc latency metric
        return round(max(left, floor, 0.001), 6)

    def _dec_queue(self, req):
        """A request left the queue for good: release its fairness budget."""
        c = self._queued_per_study
        name = req.study.name
        if c.get(name, 0) <= 1:
            c.pop(name, None)
        else:
            c[name] -= 1

    def submit_ask(self, study, deadline=None, replay=None):  # graftlint: disable=GL503 the flush-only (no-fsync) ask record must stay ordered with the seed draw and tid allocation it snapshots -- the restored-cursor bitwise contract; the next tell's fsync is its barrier
        """Queue one ask; returns the queued request (``.tid`` /
        ``.future``).  The per-ask seed is drawn HERE, from the study's
        own stream, and logged (flush-only) with the cursor after it.
        Admission control runs BEFORE the seed draw: a refused submit
        consumes nothing of the study's seed stream or tid space.
        ``replay=(tid, seed)`` queues a restored in-flight ask again with
        its logged seed: nothing is drawn or logged, so it is served
        bitwise as the crashed service would have served it.
        ``deadline`` is an absolute ``time.perf_counter()`` instant; an
        expired one is shed here or at pick time."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("suggestion service shutting down")
            if study.closed:
                raise ValueError(f"study {study.name!r} is closed")
            if study.quarantined:
                raise StudyQuarantined(
                    f"study {study.name!r} was evicted after "
                    f"{self.quarantine_trips} consecutive finite-check "
                    "trips (its history contains non-finite values); "
                    "close it and open a fresh study"
                )
            if self.draining:
                self.shed_count += 1
                raise Overloaded(
                    "service is draining for shutdown; retry against another replica",
                    retry_after=self.drain_retry_after(), reason="draining",
                )
            if self.circuit_open:
                self.shed_count += 1
                raise Overloaded(
                    f"batcher circuit breaker is open after {self.circuit_threshold} "
                    "consecutive failed dispatch rounds; the service needs operator "
                    "attention (reset_circuit)",
                    retry_after=self._jittered(self.retry_after()), reason="circuit_open",
                )
            if deadline is not None and time.perf_counter() >= deadline:
                self.shed_count += 1
                raise DeadlineExpired(
                    f"ask for study {study.name!r} submitted with an "
                    "already-expired deadline; shed before queueing"
                )
            if len(self._asks) >= self.max_queue:
                self.shed_count += 1
                raise Overloaded(
                    f"ask queue at high-water mark ({self.max_queue}); back off and resubmit",
                    retry_after=self._jittered(self.retry_after()), reason="queue_full",
                )
            if self._queued_per_study.get(study.name, 0) >= self.study_queue_cap:
                self.shed_count += 1
                raise Overloaded(
                    f"study {study.name!r} already holds {self.study_queue_cap} queued asks "
                    "(per-study fairness cap); tell or await results first",
                    retry_after=self._jittered(self.retry_after()), reason="study_queue_cap",
                )
            if replay is not None:
                tid, seed = int(replay[0]), int(replay[1])
                study.next_tid = max(study.next_tid, tid + 1)
            else:
                seed = draw_seed(study.rstate)
                tid = study.next_tid
                study.next_tid = tid + 1
                study.n_asks += 1
                if study.persist is not None:
                    study.persist.log_ask(tid, seed, study.rstate)
                # queued-but-unserved asks survive a snapshot that compacts
                # their records away (the bundle carries pending_asks)
                study.pending_asks[int(tid)] = int(seed)
            self.admitted_count += 1
            req = _AskRequest(study, tid, seed, deadline=deadline)
            self._asks.append(req)
            self._queued_per_study[study.name] += 1
            if self.recorder.enabled:
                self.recorder.event("ask.submit", study=study.name, tid=tid,
                                    queue_depth=len(self._asks), **self.span_ids)
            self._cond.notify_all()
            return req

    def drop_request(self, req):
        """Drop a still-queued request (its client stopped waiting):
        True when it was still queued (its future fails with
        :class:`DeadlineExpired`), False when a round already picked it."""
        with self._lock:
            try:
                self._asks.remove(req)
            except ValueError:
                return False
            self._dec_queue(req)
            self.shed_count += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExpired(
                f"ask tid={req.tid} for study {req.study.name!r} "
                "dropped from the queue: its client stopped waiting"
            ))
        return True

    # -- the dispatch round ------------------------------------------------
    def _compute_bucket(self):
        b = MIN_CAPACITY
        for st in self._slots.values():
            b = max(b, st.buf._device_bucket(self._pow2_cap))
        return b

    def _rematerialize(self, slot_cap, bucket):
        buffers = {st.slot: st.buf for st in self._slots.values()}
        if not buffers:
            self._state = None
            return
        self._state, nbytes = stack_states(buffers, slot_cap, bucket, self.device,
                                           mesh=self.mesh, axis=self._mesh_axis)
        self.upload_events += 1
        self.upload_bytes += nbytes
        for st in self._slots.values():
            st.dirty = False
            st.pending.clear()  # host truth already includes them

    def _restack_dirty_shards(self):
        """Shard-local re-materialization (lock held, geometry unchanged):
        only the shards holding a dirty slot are rebuilt from host truth;
        every other shard keeps its tensors, so its slots' bits cannot
        move.  The rebuilt shards' pending deltas clear (host truth holds
        them); other shards keep their staged backlogs."""
        blk = self._slot_cap // self._n_shards
        dirty_shards = {st.slot // blk for st in self._slots.values() if st.dirty}
        buffers = {st.slot: st.buf for st in self._slots.values()}
        self._state, nbytes = restack_shards(
            self._state, buffers, self._slot_cap, self._bucket, self.ps.n_dims, self.mesh,
            self._mesh_axis, dirty_shards)
        self.upload_events += 1
        self.upload_bytes += nbytes
        self.shard_restacks += 1
        for st in self._slots.values():
            if st.slot // blk in dirty_shards:
                st.dirty = False
                st.pending.clear()

    def _maintain(self):
        """Bring the stacked state up to date with tenancy and host
        truth: slot-capacity growth, bucket growth, joins and dirty slots
        are absorbed by ONE re-materialization (shard-local on a mesh when
        the geometry holds); then any multi-delta backlog drains down to
        one staged tell per slot (the step absorbs the last one)."""
        # size from the HIGHEST occupied slot, not the study count:
        # churn can leave survivors on slots >= len(self._studies)
        top_slot = max(self._slots, default=-1)
        slot_cap = max(slot_capacity(top_slot + 1, self.max_batch, shards=self._n_shards),
                       self._slot_cap)
        bucket = self._compute_bucket()
        if slot_cap != self._slot_cap or bucket != self._bucket:
            if self._state is not None:
                self.rebuckets += 1
            self._materialize = True
        dirty = any(st.dirty for st in self._slots.values())
        if dirty and not self._materialize and self._n_shards > 1 and self._state is not None:
            self._restack_dirty_shards()
        elif dirty:
            self._materialize = True
        if self._materialize:
            self._slot_cap, self._bucket = slot_cap, bucket
            self._rematerialize(slot_cap, bucket)
            self._materialize = False
            return
        # backlog drain: one masked delta per slot per write, FIFO
        while any(len(st.pending) > 1 for st in self._slots.values()):
            delta = self._delta_template(self._slot_cap)
            for st in self._slots.values():
                if len(st.pending) > 1:
                    self._stage(delta, st)
            state = self._state
            self._state = self._run_dispatch(lambda: self._delta_fn(*state, *delta))
            self.dispatch_count += 1
            self.delta_drain_dispatches += 1

    @staticmethod
    def _stage(delta, st):
        vcol, acol, dloss, didx, dapply = delta
        n, vc, ac, lo = st.pending.popleft()
        vcol[st.slot] = vc
        acol[st.slot] = ac
        dloss[st.slot] = lo
        didx[st.slot] = n
        dapply[st.slot] = True

    def _delta_template(self, s):
        """The round's delta rows, zeroed (one cached host allocation:
        the step copies them to the device before the next round)."""
        tmpl = self._delta_cache
        if tmpl is None or tmpl[2].shape[0] != s:
            tmpl = self._delta_cache = _dummy_delta(self.ps, s)
        else:
            for arr in tmpl:
                arr.fill(0)
        return tmpl

    def _pick_round(self):  # graftlint: disable=GL505 shed futures resolve under the round lock by design: the service API attaches no done-callbacks to ask futures (clients block in Future.result, which waits on the future's own condition, never this lock)
        """At most one queued ask per study this round, FIFO, capped at
        ``max_batch``.  Expired deadlines and closed/quarantined studies
        are shed here; an ask of a study whose ``fresh_window`` is full
        (that many served suggestions still owe their tell) stays
        queued."""
        now = time.perf_counter()
        if not self._asks:
            return []
        picked, leftover, seen = [], collections.deque(), set()
        for req in self._asks:
            st = req.study
            if st.closed or st.quarantined or (req.deadline is not None
                                               and now >= req.deadline):
                self._dec_queue(req)
                if st.closed:
                    req.future.set_exception(ValueError(f"study {st.name!r} closed"))
                elif st.quarantined:
                    req.future.set_exception(StudyQuarantined(
                        f"study {st.name!r} was evicted by the finite-check "
                        "guard while this ask was queued"
                    ))
                else:
                    self.shed_count += 1
                    req.future.set_exception(DeadlineExpired(
                        f"ask tid={req.tid} for study {st.name!r} expired "
                        "while queued; shed before dispatch"
                    ))
            elif (id(st) not in seen and len(picked) < self.max_batch
                  and (st.fresh_window is None or len(st.outstanding) < st.fresh_window)):
                seen.add(id(st))
                self._dec_queue(req)
                picked.append(req)
            else:
                leftover.append(req)
        self._asks = leftover
        if self.recorder.enabled:
            rec, now2 = self.recorder, time.perf_counter()
            for req in picked:
                rec.record("ask.queued", req.t_submit, now2, study=req.study.name,
                           tid=req.tid, **self.span_ids)
        return picked

    def step(self):  # graftlint: disable=GL505 the BaseException path fails picked futures before re-raising a simulated/real process death -- reordering outside the lock would let a racing submit observe a dying batcher; no done-callbacks exist (see _pick_round)
        """One dispatch round: returns the number of asks served.  The
        background loop calls this; tests call it directly so crashes
        reach them.

        A dispatch that times out or raises a TRANSIENT fault retries
        once against a newly allocated, re-materialized stacked state; a
        failure that survives the retry (or a deterministic one, which
        skips it) fails ONLY the picked requests and counts toward the
        circuit breaker.  :class:`SimulatedCrash` (a BaseException)
        propagates, after failing the picked futures."""
        with self._lock, self._on_device():
            picked = self._pick_round()
            try:
                # the group-commit fsync point: every WAL flushed since the
                # previous round is made durable before this round's
                # dispatch, which is conditioned on those tells
                self._barrier_round()
                if not picked:
                    return 0
                served = self._dispatch_round(picked)
                self._round_failures = 0
            except Exception as e:
                if not picked:
                    raise  # a barrier failure with no picks to contain it
                served = self._recover_round(picked, e)
            except BaseException as e:
                for req in picked:
                    if not req.future.done():
                        req.future.set_exception(e)
                raise
            # the twin reads the card after the round's acks, so its host
            # read never delays the futures it follows
            if self._device_metrics_due:
                self._device_metrics_due = False
                self._dispatch_device_metrics()
            return served

    def _barrier_round(self, fire_crashpoint=True):
        """One fsync per WAL a flush-only tell touched since the last
        round (lock held).  The ``serve_group_commit_after_flush_before_
        barrier`` crash point sits between the flushed records and their
        fsync.  A WAL whose barrier fails stays registered for the next
        round (or :meth:`stop`)."""
        if not self._pending_barrier:
            return
        if fire_crashpoint:
            self.fs.crashpoint("serve_group_commit_after_flush_before_barrier")
        pend = list(self._pending_barrier)
        self._pending_barrier.clear()
        for i, wal in enumerate(pend):
            try:
                if wal.barrier():
                    self.group_commit_barriers += 1
            except BaseException:
                self._pending_barrier.update(pend[i:])
                raise

    def _force_rematerialize(self):
        """Host truth is authoritative: after a failed dispatch the
        stacked state (possibly half-updated, possibly still being
        written by an abandoned dispatch) is rebuilt into new tensors."""
        self._materialize = True
        for st in self._slots.values():
            st.dirty = True

    def _recover_round(self, picked, exc):  # graftlint: disable=GL505 failure futures resolve under the round lock: the retry/circuit decision and the picked set must stay atomic wrt racing submits; no done-callbacks exist (see _pick_round)
        """The watchdog's failure path (lock held): retry once on a
        transient fault, else fail the picked requests; trip the circuit
        breaker on repeated failures."""
        transient = isinstance(exc, DispatchTimeout) or is_transient(exc)
        self._force_rematerialize()
        if transient:
            self.watchdog_retries += 1
            t0 = time.perf_counter()
            try:
                served = self._dispatch_round(picked)
            except Exception as retry_exc:
                self._force_rematerialize()
                exc = retry_exc
            else:
                self._round_failures = 0
                self.watchdog_recoveries += 1
                self.watchdog_recovery_ms.append(1000.0 * (time.perf_counter() - t0))
                return served
        logger.warning("serve dispatch round failed (%s: %s); failing %d picked ask(s)",
                       type(exc).__name__, exc, len(picked))
        for req in picked:
            if not req.future.done():
                req.future.set_exception(exc)
        self._round_failures += 1
        if self._round_failures >= self.circuit_threshold:
            if not self.circuit_open:
                logger.error("serve batcher circuit breaker OPEN after %d consecutive "
                             "failed rounds; rejecting submits with Overloaded until "
                             "reset_circuit()", self._round_failures)
            self.circuit_open = True
        return 0

    def reset_circuit(self):
        """Operator action: close the circuit breaker."""
        with self._lock:
            self.circuit_open = False
            self._round_failures = 0

    def _run_dispatch(self, fn):  # graftlint: disable=GL503 serializing dispatch rounds under the scheduler lock IS the continuous-batching design (one round in flight, ever); the watchdog deadline bounds the blocking result() wait
        """Run one device dispatch under the watchdog deadline: inline
        without ``dispatch_timeout``; else on a disposable worker thread,
        where an overrun raises :class:`DispatchTimeout` and the wedged
        thread is abandoned (it keeps writing the tensors it was given,
        which no later round uses)."""
        if self.dispatch_timeout is None:
            return fn()
        box = Future()

        def work():
            try:
                with self._on_device():
                    box.set_result(fn())
            except BaseException as e:  # ferried across the thread
                box.set_exception(e)   # boundary, re-raised at result()

        t = threading.Thread(target=work, name="serve-dispatch", daemon=True)
        t.start()
        try:
            return box.result(timeout=self.dispatch_timeout)
        except FutureTimeout:
            self._abandoned.append(t)  # stop() waits for it
            self.watchdog_timeouts += 1
            raise DispatchTimeout(
                f"device dispatch exceeded the {self.dispatch_timeout}s watchdog deadline"
            ) from None

    def _dispatch_round(self, picked):  # graftlint: disable=GL505 the round (flush-only served record, acks) is atomic under the lock by design -- acks-last keeps crashes replayable, and no done-callbacks exist (see _pick_round)
        """Serve one picked round (lock held): the stacked step for the
        slotted studies, each ``host_algo`` study's hook for the others,
        then ack every pick -- acks last, so a crash anywhere above
        leaves the round unacked."""
        host_picked = [r for r in picked if r.study.host_algo is not None]
        eng_picked = [r for r in picked if r.study.host_algo is None]
        if eng_picked:
            results = self._dispatch_engine(eng_picked)
            results.extend(self._serve_host_picks(host_picked, False))
        else:
            # a round of hooks only has the engine round's crash windows
            self.fs.crashpoint("serve_mid_batch")
            results = self._serve_host_picks(host_picked, True)
        served = 0
        rec = self.recorder
        blk = max(1, max(self._slot_cap, 1) // self._n_shards)
        now = time.perf_counter()
        for req, vals in results:
            if isinstance(vals, Exception):
                req.future.set_exception(vals)
            else:
                req.future.set_result((req.tid, vals))
                served += 1
                if rec.enabled:
                    slot = req.study.slot
                    rec.record("ask.delivered", req.t_submit, now, study=req.study.name,
                               tid=req.tid, slot=slot,
                               shard=None if slot is None else slot // blk, **self.span_ids)
        return served

    def _serve_host_picks(self, host_picked, fire_crashpoint):
        """Serve the hook studies' picks of one round (lock held): each
        study's ``host_algo(seed)`` draws its suggestion, which is the
        solo host-adaptive dispatch, so the stream is the solo driver's.
        A raising hook fails only its own client."""
        draws = []
        for req in host_picked:
            try:
                draws.append((req, req.study.host_algo(req.seed)))
            except Exception as e:
                draws.append((req, e))
        if fire_crashpoint:
            self.fs.crashpoint("serve_after_dispatch_before_ack")
        results = []
        now = time.perf_counter()
        for req, out in draws:
            if isinstance(out, Exception):
                results.append((req, out))
                continue
            v, a = out
            vals = dense_to_vals(self.ps, np.asarray(v)[:, 0], np.asarray(a)[:, 0])
            self._served(req, vals, now)
            self.host_algo_served += 1
            results.append((req, vals))
        return results

    def _served(self, req, vals, now):  # graftlint: disable=GL503,GL507 same contract as _dispatch_round: the flush-only served record is part of the atomic round under the lock, and a daemon-torn record is re-derived on replay from the ask cursor
        """Record one suggestion as served (lock held, before its ack): the
        flush-only ``served`` record, the outstanding vals its tell may
        default to, and its latency."""
        st = req.study
        if st.persist is not None:
            st.persist.log_served(req.tid, vals)
        st.outstanding[req.tid] = vals
        st.pending_asks.pop(req.tid, None)
        self.ask_latencies.append(now - req.t_submit)

    def _dispatch_engine(self, picked):
        """Maintain the stacked state, run the batched step, build the
        (req, vals) results for the ack phase."""
        self._maintain()
        s = self._slot_cap
        keys = np.zeros((s, 2), dtype=np.int64)  # placeholder key(0) per slot
        warm = np.zeros(s, dtype=bool)
        delta = self._delta_template(s)
        n_slots = len(self._slots)
        if n_slots:
            slot_arr = np.fromiter(self._slots.keys(), np.int64, n_slots)
            counts = np.fromiter((st.buf.count for st in self._slots.values()), np.int64,
                                 n_slots)
            warm[slot_arr] = (counts > 0 if self._engine_algo == "anneal"
                              else counts >= self.n_startup_jobs)
        for st in self._slots.values():
            if st.pending:  # at most one left after _maintain
                self._stage(delta, st)
        for req in picked:
            keys[req.study.slot, 1] = (req.seed % (2**31 - 1)) & _KEY_MASK
        self.fs.crashpoint("serve_mid_batch")
        slot_of = {st.name: st.slot for st in self._slots.values()}
        faults = self._device_faults
        state = self._state

        def run():
            # everything the watchdog deadline covers: the injected
            # device faults, the step and the two reads of the device
            if faults is not None:
                faults.on_dispatch()
            out = self._step_fn(keys, *state, *delta, warm, batch=1)
            new_state = out[:4]
            cols = torch.stack([out[4], out[5].to(out[4].dtype)]).cpu().numpy()
            new_v = np.array(cols[0])  # owned copies
            new_a = cols[1].astype(bool)
            if faults is not None:  # NaN scribbled into the outputs
                faults.corrupt_outputs(new_v, slot_of)
            poisoned = None
            if self.finite_check:
                poisoned = self._finite_fn(*new_state, new_v).cpu().numpy()
            return new_state, new_v, new_a, poisoned

        t_disp = time.perf_counter() if self.recorder.enabled else 0.0
        new_state, new_v, new_a, poisoned = self._run_dispatch(run)
        self._state = type(state)(*new_state)
        self.dispatch_count += 1
        every = self.device_metrics_every
        if every > 0 and self.dispatch_count % every == 0:
            self._device_metrics_due = True
        if self.finite_check:
            self.guard_checks += 1
        if self.recorder.enabled:
            self.recorder.record("serve.dispatch", t_disp, time.perf_counter(),
                                 n_picked=len(picked), slots=s, shards=self._n_shards,
                                 **self.span_ids)
        bad_slots = self._quarantine(poisoned)
        self.fs.crashpoint("serve_after_dispatch_before_ack")
        now = time.perf_counter()
        self.occupancy.append(len(picked) / s)
        results = []
        for req in picked:
            st = req.study
            if st.slot is None or st.slot in bad_slots:
                # the poisoned slot's failure is ITS OWN
                results.append((req, StudyQuarantined(
                    f"study {st.name!r} was evicted by the finite-check guard "
                    "(non-finite history); close it and open a fresh study"
                ) if st.quarantined else StudyPoisoned(
                    f"study {st.name!r} tripped the finite-check guard "
                    f"({st.poison_trips}/{self.quarantine_trips} consecutive trips): "
                    "non-finite values in its slot state or this round's suggestion; "
                    "the slot is re-materializing from host truth"
                )))
                continue
            vals = dense_to_vals(self.ps, new_v[st.slot, :, 0], new_a[st.slot, :, 0])
            self._served(req, vals, now)
            results.append((req, vals))
        return results

    def _dispatch_device_metrics(self):  # graftlint: disable=GL503 the metrics twin runs inside the round serialization point by design (one dispatch in flight, ever -- see _run_dispatch); its cost is cadence-bounded
        """The device-metrics twin (lock held, after the round's acks): the
        read-only :func:`~hyperopt_tpu_torch.obs.device.
        build_device_metrics_fn` reduction over the stacked state lands
        the round's occupancy, trials done and best loss on the registry
        (the ``serve_device_*`` gauges, ``obs_device_events_total``) and,
        with a recorder armed, a ``device.metrics`` event.  It reads the
        card once; at cadence 0 it is never built or run."""
        if self._device_metrics_fn is None:
            from ..obs.device import build_device_metrics_fn

            m = self.metrics
            best = m.gauge("serve_device_best_loss",
                           "best finite loss across the stacked batch (device twin)")
            done = m.gauge("serve_device_trials_done",
                           "valid observations across the stacked batch (device twin)")
            active_g = m.gauge("serve_device_active_slots",
                               "occupied slots this round (device twin)")
            events = m.counter("obs_device_events_total",
                               "device->host metric rows received via declared io_callback")
            rec = self.recorder

            def sink(row):
                best.set(row["best_loss"])
                done.set(row["trials_done"])
                active_g.set(row["active_slots"])
                events.inc()
                if rec.enabled:
                    rec.event("device.metrics", **row)

            self._device_metrics_fn = build_device_metrics_fn(sink)
        state = self._state
        if state is None:
            return
        active = np.zeros(self._slot_cap, dtype=bool)
        active[list(self._slots)] = True
        if self.mesh is None:
            self._device_metrics_fn(state.losses, state.valid, active)
        else:
            self._device_metrics_fn(state.gathered("losses"), state.gathered("valid"), active)
        self.device_metric_dispatches += 1

    def _quarantine(self, poisoned):
        """Apply one round's finite-check verdicts (lock held): trip
        counters, dirty-slot re-materialization and K-trip eviction, for
        slots that hold a study only.  Returns the slots that tripped."""
        if poisoned is None:
            return frozenset()
        bad = {int(i) for i in np.nonzero(poisoned)[0]}
        tripped = set()
        for st in list(self._slots.values()):
            if st.slot in bad:
                tripped.add(st.slot)
                st.poison_trips += 1
                st.dirty = True  # re-materialize from host truth
                self.quarantine_count += 1
                logger.warning("finite-check trip %d/%d for study %r (slot %d)",
                               st.poison_trips, self.quarantine_trips, st.name, st.slot)
                if st.poison_trips >= self.quarantine_trips:
                    self._evict(st)
            else:
                st.poison_trips = 0  # trips must be CONSECUTIVE
        return tripped

    def _evict(self, st):
        """Evict a poisoned study: its slot is freed (garbage behind the
        mask), asks and tells are refused, siblings are untouched."""
        logger.error("evicting study %r after %d consecutive finite-check trips; "
                     "siblings are unaffected", st.name, st.poison_trips)
        st.quarantined = True
        self._slots.pop(st.slot, None)
        self._free.append(st.slot)
        self._free.sort(reverse=True)
        st.slot = None
        self.evictions += 1

    # -- background loop ---------------------------------------------------
    def start(self):
        """Run the continuous-batching loop on a daemon thread."""
        with self._lock:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(target=self._loop, name="serve-batcher",
                                            daemon=True)
            self._thread.start()

    def drain(self, timeout=None):
        """Enter draining mode: new submits are refused with
        ``Overloaded(reason="draining")`` while queued asks are served;
        ``timeout`` publishes a drain deadline that the refusals'
        ``retry_after`` counts down to."""
        with self._lock:
            self.draining = True
            if timeout is not None:
                self.drain_deadline = time.perf_counter() + float(timeout)
            self._cond.notify_all()

    def stop(self):
        """Stop the loop, fail every queued ask promptly (after the lock
        is released), and wait for the loop and any dispatch thread the
        watchdog abandoned."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
            t = self._thread
            self._thread = None
            # no round follows: the last window's flushed tells are made
            # durable here (a failing mount must not hang the shutdown;
            # the records are flushed and the torn-tail rule covers them)
            try:
                self._barrier_round(fire_crashpoint=False)
            except OSError:
                logger.warning("group-commit barrier failed during stop; flushed tells "
                               "remain kernel-visible", exc_info=True)
            stranded = list(self._asks)
            self._asks.clear()
            for req in stranded:
                self._dec_queue(req)
        for req in stranded:
            if not req.future.done():
                req.future.set_exception(RuntimeError("suggestion service shutting down"))
        # a wedged dispatch still writes its (abandoned) tensors: let it
        # finish rather than run on into interpreter shutdown
        for th in [t] + self._abandoned:
            if th is not None:
                th.join(timeout=5.0)
        self._abandoned = [th for th in self._abandoned if th.is_alive()]

    def _ready(self):
        """Dispatch early once every open (non-quarantined) study has an
        ask queued, or the queue fills the batch."""
        active = sum(1 for st in self._studies.values() if not st.quarantined)
        distinct = {id(r.study) for r in self._asks}
        return len(distinct) >= min(max(active, 1), self.max_batch)

    def _loop(self):
        while True:
            with self._cond:
                while not self._asks and not self._stopping:
                    self._cond.wait(timeout=0.05)
                if self._stopping:
                    return
                deadline = self._asks[0].t_submit + self.max_wait
                while (not self._stopping and not self._ready()
                       and (remaining := deadline - time.perf_counter()) > 0):  # graftlint: disable=GL307 max_wait budget arithmetic (how long to keep coalescing), not a metric
                    self._cond.wait(timeout=min(remaining, 0.05))
                if self._stopping:
                    return
            try:
                if self.step() == 0:
                    # every queued ask is gated (a fresh_window study still
                    # owes tells): wait for a tell instead of spinning
                    with self._cond:
                        if self._asks and not self._stopping:
                            self._cond.wait(timeout=0.005)
            except BaseException:
                # a dying batcher must not strand blocked clients: fail
                # the queue after the lock is released, then re-raise
                with self._lock:
                    stranded = list(self._asks)
                    self._asks.clear()
                    for req in stranded:
                        self._dec_queue(req)
                for req in stranded:
                    if not req.future.done():
                        req.future.set_exception(RuntimeError("serve batcher died"))
                raise
