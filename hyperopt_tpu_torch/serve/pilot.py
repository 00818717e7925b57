"""The fleet's autoscaler in the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.serve.pilot`: a :class:`FleetPilot`
calls :meth:`~hyperopt_tpu_torch.serve.fleet.Fleet.add_replica` and
``drain_replica`` instead of an operator, and its ONLY input is the scrape
the router already serves (the ask-latency histograms, queue-depth
gauges, shed and admit counters, batch occupancy, ``router_backend_up``),
read by :func:`summarize_rows` under the reference's metric names.  There
is no private channel into the fleet, so every decision is a function of
the scrape that caused it, and the reference's pilot decides the same on
the same rows.

Control discipline:

* **hysteresis** -- pressure must breach for ``breach_ticks`` ticks in a
  row before a scale-out, and the fleet must be quiet for ``clear_ticks``
  before a scale-in;
* **cooldown** -- after an actuation the controller holds for
  ``cooldown_ticks`` ticks, so a migration's own latency spike does not
  trigger the next decision;
* **bounds** -- ``min_replicas``/``max_replicas`` clamp everything;
* **asymmetric caution** -- a backend the router reports down
  (``router_backend_up == 0``) vetoes a scale-in, never a scale-out.

A scale-out is ``Fleet.add_replica(migrate=True)`` (about 1/N of the keys
move; the new replica runs where the fleet's ``service_kw`` say, on the
card by default), a scale-in ``begin_drain`` + ``complete_drain``.  Every
tick and decision is a flight-recorder span and a ``pilot_*`` metric, and
``PILOT_CRASH_POINTS`` cover the window between decision and actuation
and the middle of a scale-out.
"""

from __future__ import annotations

import logging
import threading
import time

from ..distributed.faults import REAL_FS
from ..obs.flightrec import NULL_RECORDER
from ..obs.registry import MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ["PilotConfig", "PilotSample", "PilotDecision", "FleetPilot",
           "summarize_rows"]


class PilotConfig:
    """The autoscaler's thresholds and discipline knobs.

    Pressure (any one sustained for ``breach_ticks`` ticks scales
    out): summed queue depth >= ``queue_high``; estimated ask p99 >=
    ``p99_high_s`` (None disables); refusals observed since the last
    tick >= ``shed_high`` (0 disables).  Quiet (ALL sustained for
    ``clear_ticks`` ticks scales in): queue depth <= ``queue_low``, no
    refusals, and per-tick mean batch occupancy <= ``occupancy_low``
    (idle ticks with no dispatches count as quiet)."""

    def __init__(self, min_replicas=1, max_replicas=8,
                 queue_high=16.0, queue_low=1.0, p99_high_s=None,
                 shed_high=1.0, occupancy_low=0.25,
                 breach_ticks=2, clear_ticks=3, cooldown_ticks=3,
                 drain_timeout=30.0):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.p99_high_s = None if p99_high_s is None else float(p99_high_s)
        self.shed_high = float(shed_high)
        self.occupancy_low = float(occupancy_low)
        self.breach_ticks = max(1, int(breach_ticks))
        self.clear_ticks = max(1, int(clear_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.drain_timeout = float(drain_timeout)


class PilotSample:
    """One tick's view of the fleet, distilled from scraped rows: a
    plain value object so ``decide`` is a function of data, never of
    fleet internals."""

    def __init__(self, replicas, queue_depth, ask_p99_s, shed_total,
                 admitted_total, occupancy_sum, occupancy_count,
                 backends_down):
        self.replicas = tuple(sorted(replicas))
        self.queue_depth = float(queue_depth)
        self.ask_p99_s = float(ask_p99_s)
        self.shed_total = float(shed_total)
        self.admitted_total = float(admitted_total)
        self.occupancy_sum = float(occupancy_sum)
        self.occupancy_count = float(occupancy_count)
        self.backends_down = int(backends_down)

    @property
    def n_replicas(self):
        return len(self.replicas)


class PilotDecision:
    """What one tick concluded: ``action`` in ``{"hold", "scale_out",
    "scale_in"}``, the replica id it targets (None for hold), and the
    human-readable trigger."""

    def __init__(self, action, rid=None, reason=""):
        self.action = action
        self.rid = rid
        self.reason = reason

    def __repr__(self):
        return f"PilotDecision({self.action}, {self.rid!r}, {self.reason!r})"


def _bucket_p99(merged_buckets, total):
    """Upper-bound p99 estimate from per-bucket counts merged across
    replicas ({le: count}); 0.0 with no observations."""
    if total <= 0:
        return 0.0
    target = 0.99 * total
    seen = 0
    for le in sorted(merged_buckets):
        seen += merged_buckets[le]
        if seen >= target:
            return le if le != float("inf") else sorted(merged_buckets)[-2]
    return 0.0


def summarize_rows(rows):
    """Distill one scrape (a list of registry rows, e.g.
    ``Fleet.metrics_rows()`` or the router's aggregated scrape) into a
    :class:`PilotSample`.  Pure: rows in, value object out."""
    replicas = set()
    queue_depth = 0.0
    shed = 0.0
    admitted = 0.0
    occ_sum = 0.0
    occ_count = 0.0
    lat_buckets = {}
    lat_total = 0
    backends_down = 0
    for row in rows:
        name = row.get("name")
        labels = row.get("labels", {})
        rid = labels.get("replica")
        if rid is not None:
            replicas.add(rid)
        if name == "serve_queue_depth" and row.get("value") is not None:
            queue_depth += float(row["value"])
        elif name == "serve_shed_total":
            shed += float(row.get("value") or 0)
        elif name == "serve_admitted_total":
            admitted += float(row.get("value") or 0)
        elif name == "serve_batch_occupancy":
            occ_sum += float(row.get("sum") or 0.0)
            occ_count += float(row.get("count") or 0)
        elif name == "serve_ask_latency_seconds":
            for b in row.get("buckets", ()):
                le = float(b["le"])
                lat_buckets[le] = lat_buckets.get(le, 0) + int(b["count"])
            lat_total += int(row.get("count") or 0)
        elif name == "router_backend_up" and row.get("value") == 0:
            backends_down += 1
    return PilotSample(
        replicas=replicas,
        queue_depth=queue_depth,
        ask_p99_s=_bucket_p99(lat_buckets, lat_total),
        shed_total=shed,
        admitted_total=admitted,
        occupancy_sum=occ_sum,
        occupancy_count=occ_count,
        backends_down=backends_down,
    )


class FleetPilot:
    """The autoscaler: scrape -> summarize -> decide -> actuate.

    ``scrape`` is any zero-arg callable returning registry rows
    (default: the fleet's own in-process exposition -- production
    points it at the router's ``/metrics`` aggregation); ``fleet`` is
    only touched by :meth:`actuate`, through the public membership
    primitives.  Tests drive :meth:`tick` directly; :meth:`run` is the
    production background loop."""

    def __init__(self, fleet, config=None, scrape=None, fs=REAL_FS,
                 recorder=None):
        self.fleet = fleet
        self.config = config if config is not None else PilotConfig()
        self.scrape = scrape if scrape is not None else fleet.metrics_rows
        self.fs = fs
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.metrics = MetricsRegistry("pilot")
        self._decisions = self.metrics.counter(
            "pilot_decisions_total", "autoscaler decisions taken",
            labels=("action",),
        )
        self._scale_outs = self.metrics.counter(
            "pilot_scale_outs_total", "replicas added by the autoscaler",
        )
        self._scale_ins = self.metrics.counter(
            "pilot_scale_ins_total", "replicas drained by the autoscaler",
        )
        self._actuation_errors = self.metrics.counter(
            "pilot_actuation_errors_total",
            "actuations refused by the fleet (decision re-derived next "
            "tick)",
        )
        self._out_ms = self.metrics.gauge(
            "pilot_scale_out_ms", "last scale-out wall-clock (add + "
            "1/N-key migration)",
        )
        self._in_ms = self.metrics.gauge(
            "pilot_scale_in_ms", "last scale-in wall-clock (drain + "
            "migrate + retire)",
        )
        self._obs_replicas = self.metrics.gauge(
            "pilot_replicas_observed", "replicas present in the last "
            "scrape",
        )
        self._obs_queue = self.metrics.gauge(
            "pilot_queue_depth_observed", "summed queue depth in the "
            "last scrape",
        )
        # controller state: streaks, cooldown, the previous sample's
        # counter values (per-tick deltas), and the next replica name
        self._breach = 0
        self._clear = 0
        self._cooldown = 0
        self._prev = None
        self._next_rid = 0
        self._thread = None
        self._running = False

    # -- the loop ----------------------------------------------------------
    def tick(self):
        """One control-loop iteration; returns the
        :class:`PilotDecision` it took (after actuating it)."""
        sample = summarize_rows(self.scrape())
        decision = self.decide(sample)
        self._record_decision(sample, decision)
        self.fs.crashpoint("pilot_after_decision_before_actuate")
        if decision.action != "hold":
            self.actuate(decision)
        return decision

    def decide(self, sample):
        """The policy: hysteresis + cooldown + bounds over one
        sample.  Mutates only controller-local streak state."""
        cfg = self.config
        prev = self._prev
        self._prev = sample
        shed_delta = (
            sample.shed_total - prev.shed_total if prev is not None
            else sample.shed_total
        )
        occ_delta_n = (
            sample.occupancy_count - prev.occupancy_count
            if prev is not None else sample.occupancy_count
        )
        occ_delta_sum = (
            sample.occupancy_sum - prev.occupancy_sum
            if prev is not None else sample.occupancy_sum
        )
        occ_mean = occ_delta_sum / occ_delta_n if occ_delta_n > 0 else 0.0
        pressure = []
        if sample.queue_depth >= cfg.queue_high:
            pressure.append(f"queue_depth {sample.queue_depth:.0f} >= "
                            f"{cfg.queue_high:.0f}")
        if cfg.p99_high_s is not None and sample.ask_p99_s >= cfg.p99_high_s:
            pressure.append(f"ask_p99 {sample.ask_p99_s:.3f}s >= "
                            f"{cfg.p99_high_s:.3f}s")
        if cfg.shed_high > 0 and shed_delta >= cfg.shed_high:
            pressure.append(f"shed {shed_delta:.0f} >= "
                            f"{cfg.shed_high:.0f} this tick")
        quiet = (
            sample.queue_depth <= cfg.queue_low
            and shed_delta <= 0
            and occ_mean <= cfg.occupancy_low
        )
        if pressure:
            self._breach += 1
            self._clear = 0
        elif quiet:
            self._clear += 1
            self._breach = 0
        else:
            self._breach = 0
            self._clear = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return PilotDecision("hold", reason="cooldown")
        if (
            pressure
            and self._breach >= cfg.breach_ticks
            and sample.n_replicas < cfg.max_replicas
        ):
            rid = self._fresh_rid(sample)
            return PilotDecision("scale_out", rid=rid,
                                 reason="; ".join(pressure))
        if (
            quiet
            and self._clear >= cfg.clear_ticks
            and sample.n_replicas > cfg.min_replicas
            and sample.backends_down == 0
        ):
            # deterministic victim: the lexicographically last replica
            # the scrape observed -- pure function of the sample
            return PilotDecision(
                "scale_in", rid=max(sample.replicas),
                reason=f"quiet x{self._clear} (queue "
                f"{sample.queue_depth:.0f}, occupancy {occ_mean:.2f})",
            )
        return PilotDecision("hold", reason="within bounds")

    def _fresh_rid(self, sample):
        """The next pilot-spawned replica name not present in the
        scrape (controller-local counter; a collision with a dead,
        unscraped member surfaces as an actuation error and the
        counter moves past it)."""
        while f"p{self._next_rid}" in sample.replicas:
            self._next_rid += 1
        return f"p{self._next_rid}"

    def _record_decision(self, sample, decision):
        self._obs_replicas.set(sample.n_replicas)
        self._obs_queue.set(sample.queue_depth)
        self._decisions.labels(action=decision.action).inc()
        if self.recorder.enabled:
            self.recorder.event(
                "pilot.tick", action=decision.action,
                rid=decision.rid, reason=decision.reason,
                replicas=sample.n_replicas,
                queue_depth=sample.queue_depth,
                ask_p99_s=sample.ask_p99_s,
                backends_down=sample.backends_down,
            )

    def actuate(self, decision):
        """Execute one non-hold decision through the fleet's public
        membership primitives, timing it into the ``pilot_*`` gauges.
        A fleet refusal (e.g. the rid joined or left by another path
        since the scrape) is counted and absorbed: the next tick
        re-scrapes and re-decides."""
        cfg = self.config
        if decision.action not in ("scale_out", "scale_in"):
            return
        t0 = time.perf_counter()
        rec = self.recorder
        try:
            if decision.action == "scale_out":
                self.fleet.add_replica(decision.rid, migrate=True)
                self._next_rid += 1
                self._out_ms.set_duration_ms(t0)
                self._scale_outs.inc()
            else:
                self.fleet.begin_drain(
                    decision.rid, timeout=cfg.drain_timeout
                )
                self.fleet.complete_drain(decision.rid)
                self._in_ms.set_duration_ms(t0)
                self._scale_ins.inc()
        except (ValueError, KeyError) as e:
            self._actuation_errors.inc()
            self._next_rid += 1  # never retry the same contested name
            logger.warning(
                "pilot: %s %r refused by the fleet (%s); will "
                "re-decide from the next scrape",
                decision.action, decision.rid, e,
            )
            return
        finally:
            self._cooldown = cfg.cooldown_ticks
            self._breach = 0
            self._clear = 0
        if rec.enabled:
            rec.record(
                "pilot.decision", t0, time.perf_counter(),
                action=decision.action, rid=decision.rid,
                reason=decision.reason,
            )
        logger.info(
            "pilot: %s %r (%s)", decision.action, decision.rid,
            decision.reason,
        )

    # -- background loop (production posture) ------------------------------
    def run(self, interval=1.0):
        """Tick on a daemon thread every ``interval`` seconds (tests
        call :meth:`tick` directly for determinism)."""
        if self._thread is not None:
            return
        self._running = True
        interval = float(interval)

        def _loop():
            while self._running:
                try:
                    self.tick()
                except Exception:  # the loop outlives one bad scrape or actuation: the
                    # failure is logged and the next tick decides from a fresh scrape
                    logger.exception("pilot: tick failed; continuing")
                time.sleep(interval)

        self._thread = threading.Thread(
            target=_loop, name="fleet-pilot", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._running = False
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5.0)

    def metrics_rows(self):
        return self.metrics.collect()
