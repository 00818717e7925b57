"""The port's durable solo driver (``fmin(trials_save_file=,
resume_from=)`` over ``DriverRecovery``) against its own uninterrupted
runs and against the reference's write-ahead log.

A run killed at every ``DRIVER_CRASH_POINTS`` point through ``FaultyFS``
and resumed is bitwise the run that was never killed, with zero lost and
zero duplicated tells (the WAL's tell counter against the trials count,
tids contiguous); its WAL records are the reference's bytes, apart from
the header's guard, over streams where the packages draw the same bits
(random search and TPE's startup trials on a space without log-scaled
dims); ``trial_timeout``/``catch`` failures are durable and never
evaluated again; a missing ``resume_from`` is refused as the reference
refuses it.
"""

import os
import time

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import rand_jax, tpe_jax
from hyperopt_tpu.distributed.faults import FaultPlan as JFaultPlan
from hyperopt_tpu.distributed.faults import SimulatedCrash as JSimulatedCrash
from hyperopt_tpu.fmin import partial as jpartial
from hyperopt_tpu.utils.checkpoint import DriverRecovery as JDriverRecovery
from hyperopt_tpu_torch.base import JOB_STATE_DONE, STATUS_FAIL
from hyperopt_tpu_torch.distributed.faults import DRIVER_CRASH_POINTS, FaultPlan, SimulatedCrash
from hyperopt_tpu_torch.exceptions import CheckpointError
from hyperopt_tpu_torch.fmin import partial
from hyperopt_tpu_torch.utils.checkpoint import DriverRecovery, load_trials

N = 24
TPE = partial(H.tpe.suggest, fused=True, n_EI_candidates=16, n_EI_candidates_cat=8,
              n_startup_jobs=5)
# the hit of each point to kill at: past startup, past a bundle
DEPTH = {
    "before_wal_append": 21,  # fires for an ask and a tell
    "after_wal_append_before_tell": 21,
    "after_tell_before_ask_ahead": 11,
    "after_ckpt_tmp_before_rename": 5,  # twice per bundle (trials, meta)
    "after_ckpt_publish_before_wal_reset": 3,
}


def space(hp):
    return {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -4, 0),
            "q": hp.quniform("q", 0, 10, 1), "c": hp.choice("c", [0, 1, 2])}


def exact_space(hp):
    """No log-scaled dim: the packages' prior draws agree bitwise."""
    return {"x": hp.uniform("x", -5, 5), "q": hp.quniform("q", 0, 10, 1),
            "c": hp.choice("c", [0, 1, 2])}


def quad(cfg):
    return (cfg["x"] - 1) ** 2 + abs(cfg["q"] - 4) / 5 + 0.1 * cfg["c"] + float(
        abs(np.log(cfg["lr"]) + 2) / 3 if "lr" in cfg else 0.0)


def stream_of(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def run(algo=TPE, n=N, seed=0, trials=None, obj=quad, **kw):
    trials = H.TorchTrials(resident=True) if trials is None else trials
    H.fmin(obj, space(H.hp), algo=algo, max_evals=n, trials=trials,
           rstate=np.random.default_rng(seed), device="cpu", show_progressbar=False,
           return_argmin=False, **kw)
    return trials


def crash_then_resume(path, point, at, algo=TPE, n=N, seed=0, cadence=5, obj=quad):
    plan = FaultPlan(seed=11).arm(point, at=at)
    with pytest.raises(SimulatedCrash):
        run(algo, n, seed, obj=obj, resume_from=DriverRecovery(path, fs=plan.fs(),
                                                              cadence=cadence))
    assert plan.stats[f"crash:{point}"] == 1, "the armed point never fired"
    rec = DriverRecovery(path, cadence=cadence)
    run(algo, n, seed, obj=obj, resume_from=rec)
    return load_trials(path), rec


def assert_exactly_once(final, rec, n):
    assert [t["tid"] for t in final.trials] == list(range(n)), "lost or duplicated tids"
    assert all(t["state"] == JOB_STATE_DONE for t in final.trials)
    assert rec.wal.total_tells == n, f"WAL logged {rec.wal.total_tells} tells for {n} trials"


_REF = {}


def reference_stream(algo=TPE, n=N, seed=0):
    key = (id(algo), n, seed)
    if key not in _REF:
        _REF[key] = stream_of(run(algo, n, seed))
    return _REF[key]


@pytest.mark.parametrize("point", DRIVER_CRASH_POINTS)
def test_kill_and_resume_is_bitwise(tmp_path, point):
    """Fused TPE on a resident store: killed past startup and past a
    bundle, resumed from the bundle's history ``.npz`` and the WAL
    suffix, bitwise the uninterrupted run."""
    final, rec = crash_then_resume(str(tmp_path / "ck.pkl"), point, DEPTH[point])
    assert stream_of(final) == reference_stream()
    assert_exactly_once(final, rec, N)


@pytest.mark.slow
@pytest.mark.parametrize("point", DRIVER_CRASH_POINTS)
def test_kill_and_resume_second_seed_and_depth(tmp_path, point):
    for at in (1, DEPTH[point] + 2):
        final, rec = crash_then_resume(str(tmp_path / f"ck{at}.pkl"), point, at, seed=1)
        assert stream_of(final) == reference_stream(seed=1)
        assert_exactly_once(final, rec, N)


def _wal_lines(path):
    with open(path, "rb") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("algos", [
    (rand_jax.suggest, H.rand.suggest),
    (jpartial(tpe_jax.suggest, n_startup_jobs=40),
     partial(H.tpe.suggest, fused=True, n_startup_jobs=40)),
], ids=["rand", "tpe_startup"])
def test_wal_records_equal_the_reference(tmp_path, algos):
    """The same run in both packages, each killed just before its last
    compaction, leaves WALs whose records are the same bytes; only the
    header's guard (which names each package's algo module) differs."""
    jalgo, talgo = algos
    n = 12

    calls = []

    def slow_fifth(cfg):
        # a timed-out trial's record has no traceback (whose file paths
        # name each package), so it compares byte for byte
        calls.append(1)
        if len(calls) in (5, n + 5):
            time.sleep(0.3)
        return quad(cfg)

    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jplan = JFaultPlan(seed=1).arm("after_ckpt_publish_before_wal_reset", at=2)
    tplan = FaultPlan(seed=1).arm("after_ckpt_publish_before_wal_reset", at=2)
    with pytest.raises(JSimulatedCrash):
        J.fmin(slow_fifth, exact_space(J.hp), algo=jalgo, max_evals=n, trials=J.Trials(),
               rstate=np.random.default_rng(4), show_progressbar=False, trial_timeout=0.1,
               resume_from=JDriverRecovery(jpath, fs=jplan.fs(), cadence=100))
    with pytest.raises(SimulatedCrash):
        H.fmin(slow_fifth, exact_space(H.hp), algo=talgo, max_evals=n, trials=H.Trials(),
               rstate=np.random.default_rng(4), show_progressbar=False, trial_timeout=0.1,
               device="cpu", resume_from=DriverRecovery(tpath, fs=tplan.fs(), cadence=100))
    jl, tl = _wal_lines(jpath + ".wal"), _wal_lines(tpath + ".wal")
    assert len(jl) == len(tl) == 1 + 2 * n
    assert jl[1:] == tl[1:]
    jh = H.utils.wal._decode_line(jl[0].decode() + "\n")
    th = H.utils.wal._decode_line(tl[0].decode() + "\n")
    assert {k: v for k, v in jh.items() if k != "guard"} == {
        k: v for k, v in th.items() if k != "guard"}
    assert jh["guard"] != th["guard"] and th["guard"][2].startswith("hyperopt_tpu_torch.")
    failed = [r for r in tl if b'"status":"fail"' in r]
    assert len(failed) == 1 and b"TrialTimeout" in failed[0]


def test_timeout_and_catch_failures_are_durable_and_not_rerun(tmp_path):
    """A raising objective (``catch``) and one past ``trial_timeout`` are
    STATUS_FAIL docs with the reason attached, logged ahead; a resume
    after a kill evaluates neither again."""
    calls = []

    def flaky(cfg):
        calls.append(len(calls))
        if len(calls) % 7 == 0:
            raise ValueError(f"boom at call {len(calls)}")
        if len(calls) == 3:
            time.sleep(0.5)
        return quad(cfg)

    kw = dict(catch=(ValueError,), trial_timeout=0.15)
    algo, n = H.rand.suggest, 16
    path = str(tmp_path / "ck.pkl")
    plan = FaultPlan(seed=2).arm("after_tell_before_ask_ahead", at=12)
    with pytest.raises(SimulatedCrash):
        run(algo, n, obj=flaky, resume_from=DriverRecovery(path, fs=plan.fs(), cadence=4),
            **kw)
    assert len(calls) == 12
    rec = DriverRecovery(path, cadence=4)
    run(algo, n, obj=flaky, resume_from=rec, **kw)
    assert len(calls) == n, "a durable trial was evaluated again"
    final = load_trials(path)
    assert_exactly_once(final, rec, n)
    fails = {t["tid"]: t["result"] for t in final.trials
             if t["result"]["status"] == STATUS_FAIL}
    assert sorted(fails) == [2, 6, 13]
    assert fails[2]["failure"].startswith("TrialTimeout: objective exceeded trial_timeout")
    assert fails[6]["failure"] == "ValueError: boom at call 7"
    assert "Traceback" in fails[6]["traceback"] and fails[6]["loss"] is None


def test_resume_from_missing_checkpoint_refused(tmp_path):
    with pytest.raises(CheckpointError, match="does not exist"):
        run(H.rand.suggest, 5, resume_from=str(tmp_path / "nope.pkl"))


def test_restored_rstate_supersedes_the_passed_one(tmp_path):
    path = str(tmp_path / "ck.pkl")
    run(H.rand.suggest, 10, trials=H.Trials(), trials_save_file=path)
    run(H.rand.suggest, 25, seed=999, trials=H.Trials(), trials_save_file=path)
    assert stream_of(load_trials(path)) == stream_of(run(H.rand.suggest, 25))


def test_guard_mismatch_refused(tmp_path):
    path = str(tmp_path / "ck.pkl")
    run(H.rand.suggest, 5, trials=H.Trials(), trials_save_file=path)
    with pytest.raises(CheckpointError, match="different study"):
        run(H.rand.suggest, 10, obj=lambda cfg: cfg["x"] ** 2, resume_from=path)


def test_bundle_npz_rebuilds_the_resident_buffer(tmp_path):
    """A resumed TorchTrials takes its history from the bundle's
    ``.npz`` (no doc rescan), equal to a rebuild from the docs."""
    path = str(tmp_path / "ck.pkl")
    run(trials_save_file=path)
    trials = DriverRecovery(path).load().trials
    assert len(trials._stashed_obs_npz) == 1
    domain = H.Domain(quad, space(H.hp), device="cpu")
    from hyperopt_tpu_torch.torch_trials import packed_space_for

    buf = trials.obs_buffer(packed_space_for(domain))
    assert not trials._stashed_obs_npz and buf.count == N and buf.resident
    fresh = H.TorchTrials()
    fresh.insert_trial_docs(trials.trials)
    fresh.refresh()
    rebuilt = fresh.obs_buffer(packed_space_for(domain))
    for name in ("values", "active", "losses", "valid", "tids"):
        assert np.array_equal(getattr(buf, name), getattr(rebuilt, name)), name
    assert os.path.exists(path + ".wal") and os.path.exists(path + ".meta")
