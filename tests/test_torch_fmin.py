"""The port's stopping rules against the reference's ``fmin``: on the
same stream (random search, whose draws are the reference's within
2 ulp) ``timeout``, ``loss_threshold`` and ``early_stop_fn`` stop at the
same trial."""

import timeit

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import rand_jax
from hyperopt_tpu.early_stop import no_progress_loss as j_no_progress
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu_torch.early_stop import no_progress_loss as t_no_progress
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space

MAX_EVALS = 60


def _both(seed, j_kw, t_kw):
    jt, tt = J.Trials(), H.Trials()
    J.fmin(mixed_space_fn, j_mixed_space(), algo=rand_jax.suggest, max_evals=MAX_EVALS,
           trials=jt, rstate=np.random.default_rng(seed), show_progressbar=False, **j_kw)
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=MAX_EVALS,
           trials=tt, rstate=np.random.default_rng(seed), device="cpu", **t_kw)
    return len(jt.trials), len(tt.trials)


def test_loss_threshold_stops_at_the_same_trial():
    full = H.Trials()
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=MAX_EVALS,
           trials=full, rstate=np.random.default_rng(3), device="cpu")
    best = np.minimum.accumulate(full.losses())
    i = 1 + int(np.flatnonzero(best[1:] < best[:-1])[-1])  # the last gain
    threshold = float(best[i] + best[i - 1]) / 2  # far from either loss's last bits
    nj, nt = _both(3, {"loss_threshold": threshold}, {"loss_threshold": threshold})
    assert nj == nt == i + 1 < MAX_EVALS


def test_early_stop_fn_stops_at_the_same_trial():
    nj, nt = _both(4, {"early_stop_fn": j_no_progress(6)}, {"early_stop_fn": t_no_progress(6)})
    assert nj == nt < MAX_EVALS


def test_timeout_stops_at_the_same_trial(monkeypatch):
    """A clock that advances one second per reading: both drivers read it
    at the start and before each ask, so a 12.5 s timeout stops both
    after the same number of trials."""
    counts = []
    for j_kw, t_kw in (({"timeout": 12.5}, {}), ({}, {"timeout": 12.5})):
        ticks = iter(range(10**6))
        monkeypatch.setattr(timeit, "default_timer", lambda: float(next(ticks)))
        counts.append(_both(5, j_kw, t_kw)[0 if j_kw else 1])
    assert counts[0] == counts[1] < MAX_EVALS


@pytest.mark.parametrize("bad", [{"timeout": -1}, {"timeout": "1"}, {"loss_threshold": "x"}])
def test_bad_stopping_arguments_raise(bad):
    with pytest.raises(ValueError):
        H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=2,
               trials=H.Trials(), device="cpu", **bad)
