"""The port's stopping rules against the reference's ``fmin``: on the
same stream (random search, whose draws are the reference's within
2 ulp) ``timeout``, ``loss_threshold`` and ``early_stop_fn`` stop at the
same trial."""

import threading
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


# -- the reference's fmin arguments (points_to_evaluate, verbose, ...) --------

POINTS = [{"u0": 1.0, "lu0": 0.5, "qu0": 10.0, "ri0": 2, "ch0": 4},
          {"u0": -3.0, "lu0": 2.0, "qu0": 3.0, "ri0": 0, "ch0": 1}]


def _partial_space(hp):
    return {"u0": hp.uniform("u0", -5, 5), "lu0": hp.loguniform("lu0", -5, 2),
            "qu0": hp.quniform("qu0", 0, 20, 1), "ri0": hp.randint("ri0", 8),
            "ch0": hp.choice("ch0", list(range(5)))}


@pytest.mark.parametrize("seeded_store", [False, True])
def test_points_to_evaluate_run_first_as_in_the_reference(seeded_store):
    """The given points are the first trials, then the algo's; with an
    empty store passed in, the points go into it."""
    jt = J.Trials() if seeded_store else None
    tt = H.Trials() if seeded_store else None
    jb = J.fmin(mixed_space_fn, _partial_space(J.hp), algo=rand_jax.suggest, max_evals=6,
                trials=jt, points_to_evaluate=POINTS, rstate=np.random.default_rng(1),
                show_progressbar=False, verbose=True, return_argmin=False)
    tb = H.fmin(mixed_space_fn, _partial_space(H.hp), algo=H.rand.suggest, max_evals=6,
                trials=tt, points_to_evaluate=POINTS, rstate=np.random.default_rng(1),
                device="cpu", verbose=True, return_argmin=False)
    np.testing.assert_allclose(tb, jb, rtol=1e-6)
    if seeded_store:
        assert [t["misc"]["vals"] for t in tt.trials[:2]] == [
            t["misc"]["vals"] for t in jt.trials[:2]]
        assert tt.losses()[:2] == jt.losses()[:2]
        assert len(tt.trials) == len(jt.trials) == 6


def test_allow_trials_fmin_hands_the_call_to_the_store():
    """A store with its own ``fmin`` takes the call, as the reference's
    backends do; ``allow_trials_fmin=False`` keeps it in the driver."""
    calls = []

    class OwnFmin(H.Trials):
        def fmin(self, fn, space, **kw):
            calls.append(kw["algo"])
            return "store"

    store = OwnFmin()
    assert H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=2,
                  trials=store, device="cpu") == "store"
    assert calls == [H.rand.suggest]
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.rand.suggest, max_evals=2, trials=store,
           allow_trials_fmin=False, rstate=np.random.default_rng(0), device="cpu")
    assert len(store.trials) == 2 and len(calls) == 1


def test_async_store_runs_every_trial_once():
    """An asynchronous store (``ThreadTrials``) runs through the port's
    ``fmin``: every trial evaluated exactly once, each round awaited, and
    the pickled Domain published for workers before the first ask."""
    from hyperopt_tpu_torch.distributed import ThreadTrials

    seen = []
    lock = threading.Lock()

    def counted(cfg):
        with lock:
            seen.append(cfg["u0"])
        return mixed_space_fn(cfg)

    trials = ThreadTrials(parallelism=3)
    H.fmin(counted, t_mixed_space(), algo=H.rand.suggest, max_evals=10, trials=trials,
           rstate=np.random.default_rng(0), device="cpu", show_progressbar=False)
    assert len(trials.trials) == 10 == len(seen)
    assert all(t["state"] == H.JOB_STATE_DONE for t in trials.trials)
    assert sorted(seen) == sorted(t["misc"]["vals"]["u0"][0] for t in trials.trials)
    assert "FMinIter_Domain" not in trials.attachments  # a closure does not pickle


def test_space_eval_and_generate_trials_match_the_reference():
    from hyperopt_tpu.fmin import generate_trials_to_calculate as j_gen
    from hyperopt_tpu.fmin import space_eval as j_space_eval
    from hyperopt_tpu_torch.fmin import generate_trials_to_calculate as t_gen

    def nested(hp):
        return {"a": hp.choice("a", [{"k": 0, "w": hp.uniform("w", 0, 1)}, "flat"]),
                "b": hp.quniform("b", 0, 10, 2)}

    for assignment in ({"a": 0, "w": 0.25, "b": 4.0}, {"a": 1, "b": 6.0}):
        assert H.space_eval(nested(H.hp), assignment) == j_space_eval(nested(J.hp), assignment)
    jt, tt = j_gen(POINTS), t_gen(POINTS)
    assert [(t["tid"], t["misc"]["vals"], t["result"]) for t in tt.trials] == [
        (t["tid"], t["misc"]["vals"], t["result"]) for t in jt.trials]


def test_progressbar_is_on_by_default(capsys):
    """``show_progressbar`` defaults to a ``tqdm`` bar on stderr, as the
    reference's; prints of the objective still reach stdout."""
    def noisy(cfg):
        print("evaluating")
        return mixed_space_fn(cfg)

    H.fmin(noisy, t_mixed_space(), algo=H.rand.suggest, max_evals=5,
           rstate=np.random.default_rng(0), device="cpu")
    out, err = capsys.readouterr()
    assert "5/5" in err and "trial" in err and "best loss" in err
    assert out.count("evaluating") == 5


def _recording_progress(log):
    import contextlib

    class Ctx:
        def update(self, n=1, best_loss=None):
            log.append(("update", n, best_loss))

    @contextlib.contextmanager
    def progress(initial, total):
        log.append(("open", initial, total))
        yield Ctx()
        log.append(("close",))

    return progress


@pytest.mark.parametrize("engine", [False, True])
def test_progress_callable_sees_what_the_reference_shows(engine):
    """A callable ``show_progressbar`` gets ``(initial=, total=)`` and the
    same ``update(n, best_loss=)`` calls as under the reference's driver,
    on the same random-search stream (the engine route on the TPE
    startup stream, whose draws are the reference's too)."""
    from hyperopt_tpu import tpe_jax
    from hyperopt_tpu.fmin import partial as jpartial

    jlog, tlog = [], []
    if engine:
        jalgo = jpartial(tpe_jax.suggest, n_startup_jobs=50)
        talgo, kw = H.partial(H.tpe.suggest, n_startup_jobs=50), {"engine": True}
    else:
        jalgo, talgo, kw = rand_jax.suggest, H.rand.suggest, {}
    J.fmin(mixed_space_fn, j_mixed_space(), algo=jalgo, max_evals=12,
           rstate=np.random.default_rng(2), show_progressbar=_recording_progress(jlog), **kw)
    H.fmin(mixed_space_fn, t_mixed_space(), algo=talgo, max_evals=12,
           rstate=np.random.default_rng(2), device="cpu",
           show_progressbar=_recording_progress(tlog), **kw)
    assert tlog[0] == jlog[0] == ("open", 0, 12) and tlog[-1] == ("close",)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    np.testing.assert_allclose([e[2] for e in tlog if e[0] == "update"],
                               [e[2] for e in jlog if e[0] == "update"], rtol=1e-6)
