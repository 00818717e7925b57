"""Flight-recorder span logs as replayable traffic, in the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.serve.replay`.  The port's flight
recorder (:mod:`hyperopt_tpu_torch.obs.flightrec`) writes, for a served
study, a ``study.open`` span with its EFFECTIVE seed and a ``tell`` span
with each loss, so a span log is a self-contained workload: which studies
opened with which seeds, every ask in delivery order, every tell with its
loss.  A suggestion is a function of (seed, tell history), so replaying
the workload against a fresh service or fleet gives every stream bitwise,
however the recorded run was batched, placed, failed over or autoscaled;
a faulted run's log replays to the clean streams (a recovery's second
service of an ask is a duplicate (study, tid) span, and only the first
counts).

Record once, replay bitwise: arm ``FlightRecorder(path=...)`` on the
service, run traffic, then::

    ops = load_workload(path)
    streams = replay_workload(ops, ServiceTarget(fresh_service))
    assert stream_hash(streams) == stream_hash(recorded_streams)

``replay_fidelity(a, b)`` is 1.0 when the hashes match, else 0.0.
"""

from __future__ import annotations

import hashlib
import json
import logging

from ..distributed.faults import REAL_FS
from ..obs.flightrec import read_flight_log

logger = logging.getLogger(__name__)

__all__ = [
    "extract_workload", "load_workload", "replay_workload",
    "ServiceTarget", "stream_hash", "replay_fidelity",
    "replay_flight_log",
]


def extract_workload(spans):
    """Distill spans into an ordered op list: ``("open", study, seed)``
    / ``("ask", study, tid)`` / ``("tell", study, tid, loss)``.

    Ordering: exported spans carry the recorder's monotone ``seq``
    (used when present); in-memory ``tail()`` spans replay in list
    order.  Asks anchor on ``ask.delivered`` -- the DISPATCH-side
    span -- because a suggestion is a function of the study's history
    at dispatch time, not at submit time: the per-study interleave of
    delivered asks and applied tells in span order IS the history
    each suggestion saw (per-study delivery is FIFO in tid order, and
    cross-study order cannot matter -- histories are per-study).
    Dedup: only the FIRST span per (study, tid) counts for asks and
    for tells -- a faulted run's recovery re-serves and replayed
    tells collapse onto the clean order.

    Record with ``FlightRecorder(cadence=1)`` (the default): a
    sampled log is missing ops and replays loudly wrong (the tid
    check in :func:`replay_workload`), never silently wrong.
    """
    ordered = sorted(
        enumerate(spans),
        key=lambda pair: (pair[1].get("seq", pair[0]), pair[0]),
    )
    ops = []
    opened = {}
    seen_asks = set()
    seen_tells = set()
    for _i, span in ordered:
        name = span.get("name")
        study = span.get("study")
        if name == "study.open" and study is not None:
            if study not in opened:
                seed = int(span.get("seed", 0))
                opened[study] = seed
                ops.append(("open", study, seed))
        elif name == "ask.delivered" and study is not None:
            key = (study, int(span["tid"]))
            if key not in seen_asks:
                seen_asks.add(key)
                ops.append(("ask", study, key[1]))
        elif name == "tell" and study is not None:
            key = (study, int(span["tid"]))
            if key in seen_tells:
                continue
            seen_tells.add(key)
            if "loss" not in span:
                raise ValueError(
                    f"tell span for {study!r} tid {key[1]} carries no "
                    "loss -- the log predates the replayable-workload "
                    "contract and cannot be replayed"
                )
            ops.append(("tell", study, key[1], float(span["loss"])))
    return ops


def load_workload(path, fs=REAL_FS):
    """The op list of a flight log on disk (torn tail ignored)."""
    return extract_workload(read_flight_log(path, fs=fs))


class ServiceTarget:
    """Adapts a solo :class:`~hyperopt_tpu_torch.serve.service.
    SuggestService` to the replay target protocol (``open`` / ``ask``
    / ``tell`` by study name).  A fleet's in-process
    :class:`~hyperopt_tpu_torch.serve.router.FleetRouter` already speaks
    it natively (``create_study`` / ``ask`` / ``tell``)."""

    def __init__(self, service, timeout=60.0):
        self.service = service
        self.timeout = float(timeout)
        self._handles = {}

    def create_study(self, name, seed=0):
        self._handles[name] = self.service.create_study(name, seed=seed)

    def ask(self, name, timeout=None):
        return self._handles[name].ask(
            timeout=self.timeout if timeout is None else timeout
        )

    def tell(self, name, tid, loss):
        self._handles[name].tell(tid, loss)


def replay_workload(ops, target, timeout=60.0):
    """Drive the recorded ops against ``target`` (a
    :class:`ServiceTarget` or an in-process ``FleetRouter``) in
    arrival order; returns ``{study: [(tid, vals), ...]}`` -- the
    replayed suggestion streams.

    The replayed tids must match the recorded ones (same submit order
    per study => same tid sequence); a mismatch means the log and the
    target disagree about history and is raised, not papered over."""
    streams = {}
    for op in ops:
        kind, study = op[0], op[1]
        if kind == "open":
            target.create_study(study, seed=op[2])
            streams.setdefault(study, [])
        elif kind == "ask":
            tid, vals = target.ask(study, timeout=timeout)
            if int(tid) != int(op[2]):
                raise ValueError(
                    f"replay diverged: study {study!r} served tid "
                    f"{tid}, the recording expected {op[2]}"
                )
            streams.setdefault(study, []).append((int(tid), dict(vals)))
        elif kind == "tell":
            target.tell(study, op[2], op[3])
    return streams


def stream_hash(streams):
    """Canonical digest of suggestion streams ({study: [(tid, vals)]}):
    sorted-key JSON (floats via repr round-trip exactly) -> blake2b.
    Two runs are bitwise-identical iff their hashes match."""
    canon = {
        str(study): [
            [int(tid), {k: float(v) for k, v in sorted(vals.items())}]
            for tid, vals in pairs
        ]
        for study, pairs in sorted(streams.items())
    }
    data = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(data.encode("utf-8"), digest_size=16).hexdigest()


def replay_fidelity(recorded_streams, replayed_streams):
    """The fidelity scalar: 1.0 when the replayed streams hash-match the
    recorded ones, else 0.0."""
    return (
        1.0 if stream_hash(recorded_streams) == stream_hash(replayed_streams)
        else 0.0
    )


def replay_flight_log(path, target, fs=REAL_FS, timeout=60.0):
    """Convenience: load the span log at ``path`` and replay it
    against ``target``; returns the replayed streams."""
    return replay_workload(load_workload(path, fs=fs), target,
                           timeout=timeout)
