"""The port's ``ThreadTrials`` and its asynchronous ``fmin`` driver
against the reference's.

Evaluation in threads, error capture, and a timeout that cancels the
queue under a stepping clock.  Streams: random search on ``ThreadTrials``
is the reference's ``ThreadTrials`` stream within the 2-ulp draw rule of
``test_torch_rand.py``; TPE at ``parallelism=4`` asks whole rounds of 4
and waits for each, so its stream is bitwise the port's sequential
``fmin(max_queue_len=4)`` on a plain ``Trials``, and equal up to a
near-tie (the rule of ``test_torch_tpe.py``, at the ask's batch of 4) to
the reference's ``ThreadTrials`` driven one round at a time
(``FMinIter.run(4)``: one ask of 4, then ``block_until_done``).
``run(N, block_until_done=False)``, the reference's refill loop, still
runs every trial once.
"""

import threading
import time
import timeit

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import rand_jax, tpe_jax
from hyperopt_tpu.base import Domain as JDomain
from hyperopt_tpu.distributed import ThreadTrials as JThreadTrials
from hyperopt_tpu.fmin import FMinIter as JFMinIter
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu_torch.base import JOB_STATE_CANCEL, JOB_STATE_DONE, JOB_STATE_ERROR, Domain
from hyperopt_tpu_torch.distributed import ThreadTrials
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from test_torch_rand import _assert_same_draws
from test_torch_tpe import NEAR_TIE, _first_divergence, _ref_margins

K = 4


def streams(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def test_thread_trials_evaluate_in_parallel():
    calls = []

    def slow_quad(x):
        calls.append(threading.get_ident())
        time.sleep(0.15)
        return (x - 3.0) ** 2

    trials = ThreadTrials(parallelism=4)
    t0 = time.perf_counter()
    best = H.fmin(slow_quad, H.hp.uniform("x", -10, 10), algo=H.rand.suggest, max_evals=8,
                  trials=trials, rstate=np.random.default_rng(0), device="cpu",
                  show_progressbar=False)
    wall = time.perf_counter() - t0
    assert len(trials) == 8 and all(t["state"] == JOB_STATE_DONE for t in trials.trials)
    assert wall < 8 * 0.15  # the rounds' evaluations overlapped
    assert len(set(calls)) > 1 and "x" in best
    assert {t["owner"] for t in trials.trials} <= {f"thread:{i}" for i in range(4)}


def test_thread_trials_capture_errors():
    def flaky(x):
        if x > 0:
            raise ValueError("positive!")
        return x

    trials = ThreadTrials(parallelism=2)
    H.fmin(flaky, H.hp.uniform("x", -1, 1), algo=H.rand.suggest, max_evals=10, trials=trials,
           rstate=np.random.default_rng(3), device="cpu", show_progressbar=False,
           return_argmin=False)
    states = {t["state"] for t in trials.trials}
    assert states == {JOB_STATE_DONE, JOB_STATE_ERROR}
    err = next(t for t in trials.trials if t["state"] == JOB_STATE_ERROR)
    assert "positive!" in err["misc"]["error"][1]


def test_thread_trials_timeout_cancels_the_queue(monkeypatch):
    """A clock that advances one second per reading (only the driver's
    thread reads it): at ``timeout=6`` the run is cut within its first
    rounds, every NEW trial left in the queue is cancelled and never run."""
    ticks = iter(range(10**6))
    monkeypatch.setattr(timeit, "default_timer", lambda: float(next(ticks)))
    ran = []

    def quad(x):
        ran.append(x)
        return x

    trials = ThreadTrials(parallelism=1, timeout=6)
    H.fmin(quad, H.hp.uniform("x", 0, 1), algo=H.rand.suggest, max_evals=1000, trials=trials,
           max_queue_len=4, rstate=np.random.default_rng(0), device="cpu",
           show_progressbar=False, return_argmin=False)
    assert trials._fmin_cancelled and trials._fmin_cancelled_reason == "fmin run timeout"
    states = [t["state"] for t in trials.trials]
    assert len(states) < 1000 and JOB_STATE_CANCEL in states
    assert set(states) <= {JOB_STATE_DONE, JOB_STATE_CANCEL}
    assert len(ran) == states.count(JOB_STATE_DONE)


def test_rand_stream_is_the_reference_thread_trials_stream():
    """One ask per round (``max_queue_len=1``): the reference's
    ``ThreadTrials`` draws one seed per trial whatever its threads'
    timing, and so does the port's."""
    jt = JThreadTrials(parallelism=4)
    J.fmin(mixed_space_fn, j_mixed_space(), algo=rand_jax.suggest, max_evals=24, trials=jt,
           rstate=np.random.default_rng(1), show_progressbar=False)
    tt = ThreadTrials(parallelism=4)
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=24, trials=tt,
           max_queue_len=1, rstate=np.random.default_rng(1), device="cpu",
           show_progressbar=False)
    _assert_same_draws(jt, tt)


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_stream_is_the_sequential_twin_and_the_reference(seed):
    n = 40
    tt = ThreadTrials(parallelism=K)
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=tt,
           rstate=np.random.default_rng(seed), device="cpu", show_progressbar=False)
    twin = H.Trials()
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=twin,
           max_queue_len=K, rstate=np.random.default_rng(seed), device="cpu",
           show_progressbar=False)
    assert streams(tt) == streams(twin)

    # the reference's ThreadTrials at the same rounds: its fmin asks again
    # while a round runs (ROADMAP Queue C), so its FMinIter is stepped one
    # round at a time
    jt = JThreadTrials(parallelism=K)
    domain = JDomain(mixed_space_fn, j_mixed_space())
    jt._domain = domain  # the pump's domain, as the reference's ThreadTrials.fmin sets it
    it = JFMinIter(tpe_jax.suggest, domain, jt, rstate=np.random.default_rng(seed),
                   max_queue_len=K, poll_interval_secs=0.01, max_evals=n,
                   show_progressbar=False)
    for _ in range(n // K):
        it.run(K)
    assert {t["owner"] for t in jt.trials} <= {f"thread:{i}" for i in range(K)}
    jps = j_compile(j_mixed_space())
    first, labels = _first_divergence(jps, jt, tt)
    assert first is None or first >= 20, (first, labels)  # startup rounds equal
    if first is None:
        return
    start = first - first % K  # the ask that drew trial `first`
    buf = JObsBuffer(jps)
    hist = J.Trials()
    hist._insert_trial_docs(jt.trials[:start])
    hist.refresh()
    buf.sync(hist)
    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)] for a in buf.arrays())
    rng = np.random.default_rng(seed)
    seeds = [int(rng.integers(2**31 - 1)) for _ in range(start // K + 1)]
    margins = _ref_margins(jps, arrays, host_key(seeds[-1] % (2**31 - 1)), K)[:, first % K]
    for label in labels:
        assert margins[jps.labels.index(label)] < NEAR_TIE, (first, label)


def test_run_without_blocking_runs_every_trial_once():
    """``run(N, block_until_done=False)`` keeps the reference's refill
    loop: it asks whenever fewer than ``max_queue_len`` trials wait,
    sleeping one poll between fills, so its stream depends on the
    threads' timing; what holds is that every trial runs once."""
    ran, lock = [], threading.Lock()

    def quad(x):
        with lock:
            ran.append(x)
        time.sleep(0.01 * (1 + len(ran) % 3))  # unequal evaluation times
        return (x - 0.5) ** 2

    trials = ThreadTrials(parallelism=3)
    domain = Domain(quad, H.hp.uniform("x", 0, 1), device="cpu")
    trials._domain = domain  # the pump's domain, as ThreadTrials.fmin sets it
    it = FMinIter(H.rand.suggest, domain, trials, rstate=np.random.default_rng(2),
                  max_queue_len=2, poll_interval_secs=0.01, max_evals=12,
                  show_progressbar=False)
    it.run(12, block_until_done=False)
    it.block_until_done()
    trials.refresh()
    assert [t["tid"] for t in trials.trials] == list(range(12))
    assert [t["state"] for t in trials.trials] == [JOB_STATE_DONE] * 12
    assert sorted(ran) == sorted(t["misc"]["vals"]["x"][0] for t in trials.trials)
    assert [t["result"]["loss"] for t in trials.trials] == [
        (t["misc"]["vals"]["x"][0] - 0.5) ** 2 for t in trials.trials]
