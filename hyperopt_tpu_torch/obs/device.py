"""Device-side metric rows for the registry.

The port's counterpart of :mod:`hyperopt_tpu.obs.device`.  Two seams feed
signals of the card into a :class:`~hyperopt_tpu_torch.obs.registry.
MetricsRegistry` without touching the programs that serve or search:

* :func:`build_device_metrics_fn` -- a separate, read-only reduction over
  the serve engine's stacked history (``losses``/``valid`` with the
  leading study axis) that hands one row of occupancy, trials done and
  best loss to a host sink.  The reference ships the row with one
  ordered ``io_callback``; here it is one small read of the card.  The
  scheduler runs it only every ``device_metrics_every`` rounds, after
  the round's futures are resolved; at cadence 0 it is never built.
* :func:`progress_to_registry` -- the adapter that turns the chunked
  compiled loop's progress rows into registry gauges and a counter
  (``compile_fmin(metrics_registry=...)``).
"""

from __future__ import annotations

import time

import torch

from ..ops.kernels import sum_rows

__all__ = ["build_device_metrics_fn", "progress_to_registry"]


def build_device_metrics_fn(sink):
    """The metrics twin: ``fn(losses [S, N], valid [S, N], active [S])
    -> n_active``, handing ``{"active_slots", "trials_done",
    "best_loss"}`` (Python ``int``, ``int``, ``float``) to ``sink``.

    Read-only: it writes no state tensor, so a round's streams cannot
    change by running it, only its wall time, which the cadence bounds.
    The two counts are integer sums, exact in any order, and go through
    the fixed-order :func:`~hyperopt_tpu_torch.ops.kernels.sum_rows` on
    the card all the same; the best loss is a minimum.  The three values
    cross to the host in one read.
    """

    def metrics_fn(losses, valid, active):
        active = torch.as_tensor(active, dtype=torch.bool, device=losses.device)
        ok = valid & torch.isfinite(losses) & active[:, None]
        best = torch.where(ok, losses, torch.full_like(losses, float("inf"))).amin()
        done = sum_rows(sum_rows(ok.to(torch.int64), dim=-1), dim=-1)
        n_active = sum_rows(active.to(torch.int64), dim=-1)
        row = torch.stack([n_active.to(torch.float64), done.to(torch.float64),
                           best.to(torch.float64)]).cpu().tolist()
        sink({"active_slots": int(row[0]), "trials_done": int(row[1]),
              "best_loss": float(row[2])})
        return int(row[0])

    return metrics_fn


def progress_to_registry(registry, recorder=None, t0=None):
    """A ``progress_callback`` for :func:`hyperopt_tpu_torch.device_loop.
    compile_fmin` that lands each per-chunk row on ``registry``: the
    ``device_loop_best_loss`` / ``device_loop_trials_done`` gauges,
    ``device_loop_trials_per_sec`` (since ``t0``, default the adapter's
    construction) and the ``obs_device_events_total`` counter;
    ``recorder`` (optional) gets a ``device.chunk`` event per row."""
    start = time.perf_counter() if t0 is None else t0
    best = registry.gauge("device_loop_best_loss", "best finite loss so far (per chunk)")
    done_g = registry.gauge("device_loop_trials_done", "trials completed so far")
    rate = registry.gauge("device_loop_trials_per_sec", "trials/sec since the run started")
    events = registry.counter("obs_device_events_total",
                              "device->host metric rows received via declared io_callback")

    def callback(row):
        best.set(row["best_loss"])
        done_g.set(row["trials_done"])
        dt = time.perf_counter() - start  # graftlint: disable=GL307 elapsed-run denominator for the trials/sec gauge (the gauge IS the registry sink)
        if dt > 0:
            rate.set(row["trials_done"] / dt)
        events.inc()
        if recorder is not None:
            recorder.event("device.chunk", **row)

    return callback


# ---------------------------------------------------------------------------
# Program registration (hyperopt-tpu-torch-lint --ir)
# ---------------------------------------------------------------------------

from ..ops.compile import ProgramCapture, register_program  # noqa: E402


@register_program(
    "obs.device_metrics",
    families=("hyperopt_tpu_torch.obs.device:build_device_metrics_fn",),
)
def _registry_device_metrics(p):
    """The serve metrics twin over the stacked study axis: a read-only
    reduction and ONE declared read of its three-value row (the
    reference's ordered ``io_callback``)."""
    values, active, losses, valid = p.study_history_specs()
    return ProgramCapture(
        fn=build_device_metrics_fn(lambda row: None),
        args=(losses, valid, p.study_mask_spec()),
        allowed_syncs=("cpu", "tolist"),
    )
