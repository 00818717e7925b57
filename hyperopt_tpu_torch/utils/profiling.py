"""Timing and tracing hooks of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.utils.profiling`: wall-clock stats
per named step (:class:`StepTimer`, :func:`instrument_algo`), which work
on any device, and :func:`device_trace`, a ``torch.profiler`` capture of
the host and the card written as a Chrome trace that Perfetto opens.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

logger = logging.getLogger(__name__)

__all__ = ["StepTimer", "instrument_algo", "device_trace"]


class StepTimer:
    """Accumulates wall-clock stats per named step.

    >>> timer = StepTimer()
    >>> with timer.measure("suggest"):
    ...     pass
    >>> timer.summary()["suggest"]["count"]
    1
    """

    def __init__(self):
        self._records = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._records[name].append(time.perf_counter() - t0)

    def record(self, name, seconds):
        self._records[name].append(float(seconds))

    def summary(self):
        out = {}
        for name, xs in self._records.items():
            n = len(xs)
            total = sum(xs)
            out[name] = {"count": n, "total_s": total, "mean_s": total / n,
                         "min_s": min(xs), "max_s": max(xs)}
        return out

    def log_summary(self, level=logging.INFO):
        for name, s in sorted(self.summary().items()):
            logger.log(level, "%s: n=%d mean=%.4fs total=%.2fs", name, s["count"], s["mean_s"],
                       s["total_s"])


def instrument_algo(algo, timer, name=None):
    """Wrap a suggest function so every call is timed.

    >>> timed = instrument_algo(tpe.suggest, timer)
    >>> fmin(fn, space, algo=timed, ...)
    """
    label = name or getattr(algo, "__name__", "suggest")

    def timed(new_ids, domain, trials, seed, *args, **kwargs):
        with timer.measure(label):
            return algo(new_ids, domain, trials, seed, *args, **kwargs)

    timed.__name__ = f"timed_{label}"
    return timed


@contextlib.contextmanager
def device_trace(logdir, create_perfetto_link=False):
    """Capture a ``torch.profiler`` trace of the block: host activity, and
    the card's kernels where CUDA is available.  On exit the trace is
    written into ``logdir`` as a Chrome trace (``trace_<pid>_<ns>.json``,
    which Perfetto and ``chrome://tracing`` open); the block receives the
    profiler.

    A profiler that cannot start raises: a trace that was asked for is
    never skipped quietly.  ``create_perfetto_link=True`` raises
    ``NotImplementedError``: the link server belongs to JAX's profiler.
    """
    if create_perfetto_link:
        raise NotImplementedError(
            "device_trace(create_perfetto_link=True): the Perfetto link server is JAX's "
            "profiler's; open the Chrome trace written into logdir in Perfetto instead"
        )
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:  # a profiler that cannot start raises
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
