"""The port's flight recorder (``hyperopt_tpu_torch.obs.flightrec``)
against the reference's: the same spans read back equal from either
package's export, a tear at ``obs_flight_export_mid_append`` is audited
and repaired as the reference repairs it, and arming a recorder leaves
an ``fmin`` stream bitwise unchanged (the invisibility invariant), solo
and engine-routed."""

import numpy as np
import pytest

import hyperopt_tpu_torch as H
from hyperopt_tpu.obs import flightrec as JF
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.distributed.faults import OBS_CRASH_POINTS, FaultPlan, SimulatedCrash
from hyperopt_tpu_torch.fmin import partial
from hyperopt_tpu_torch.obs import (
    FlightRecorder,
    audit_flight_log,
    read_flight_log,
    repair_flight_log,
)

SPANS = [("ask.submit", None, None, {"study": "a", "tid": 0, "queue_depth": 1}),
         ("serve.dispatch", 1.0, 1.0125, {"n_picked": 2, "slots": 4}),
         ("tell", 2.0, 2.5, {"study": "b", "tid": 7, "loss": 0.25}),
         ("driver.trial", 3.0, 3.001, {"study": "driver", "tid": 1, "status": "ok"})]


def _untimed(spans):
    return [{k: v for k, v in s.items() if k != "ts"} for s in spans]


def test_spans_read_back_equal_to_the_reference(tmp_path):
    """The same spans in both recorders: the exports read back equal (the
    wall-clock ``ts`` aside) by either package's reader, and the ring
    tails agree."""
    tpath, jpath = str(tmp_path / "t.wal"), str(tmp_path / "j.wal")
    trec, jrec = FlightRecorder(capacity=3, path=tpath), JF.FlightRecorder(capacity=3, path=jpath)
    for name, t0, t1, ids in SPANS:
        trec.record(name, t0, t1, **ids)
        jrec.record(name, t0, t1, **ids)
    trec.flush(), jrec.flush()
    trec.close(), jrec.close()
    got = _untimed(read_flight_log(tpath))
    assert got == _untimed(JF.read_flight_log(jpath)) == _untimed(JF.read_flight_log(tpath))
    assert got == _untimed(read_flight_log(jpath))
    assert [s["seq"] for s in got] == [1, 2, 3, 4] and got[2]["dur_ms"] == 500.0
    assert _untimed(trec.tail()) == _untimed(jrec.tail()) and len(trec.tail()) == 3
    assert audit_flight_log(tpath) == JF.audit_flight_log(tpath) == []
    assert (trec.recorded_total, trec.exported_total) == (4, 4)


def test_cadence_samples_as_the_reference():
    trec, jrec = FlightRecorder(cadence=3), JF.FlightRecorder(cadence=3)
    for i in range(10):
        trec.event("e", i=i)
        jrec.event("e", i=i)
    assert [s["i"] for s in trec.tail()] == [s["i"] for s in jrec.tail()] == [0, 3, 6, 9]
    assert trec.sampled_out == jrec.sampled_out == 6


@pytest.mark.parametrize("point", OBS_CRASH_POINTS)
def test_tear_mid_append_is_audited_and_repaired(tmp_path, point):
    """A crash half way through a span line leaves a torn tail: both
    packages' audits report it, the port's repair truncates it to the
    spans before the tear, and a reopened recorder appends on."""
    path = str(tmp_path / "f.wal")
    plan = FaultPlan(seed=0).arm(point, at=3)
    rec = FlightRecorder(path=path, fs=plan.fs())
    rec.record("a", 0.0, 1.0, tid=0)
    rec.record("b", 0.0, 1.0, tid=1)
    with pytest.raises(SimulatedCrash):
        rec.record("c", 0.0, 1.0, tid=2)
    kinds = [i[0] for i in audit_flight_log(path)]
    assert kinds == [i[0] for i in JF.audit_flight_log(path)] == ["obs_torn_tail"]
    assert [s["name"] for s in read_flight_log(path)] == ["a", "b"]
    assert repair_flight_log(path) > 0 and repair_flight_log(path) == 0
    assert audit_flight_log(path) == JF.audit_flight_log(path) == []
    again = FlightRecorder(path=path)
    again.record("d", 0.0, 1.0, tid=3)
    again.close()
    assert [s["name"] for s in read_flight_log(path)] == ["a", "b", "d"]
    assert audit_flight_log(str(tmp_path / "missing.wal"))[0][0] == "obs_missing"


SPACE = {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -5, 0),
         "c": hp.choice("c", [0, 1, 2])}
TPE = dict(n_EI_candidates=16, n_EI_candidates_cat=8, n_startup_jobs=3)


def _losses(algo, recorder=None, **kw):
    trials = H.Trials()
    H.fmin(lambda c: (c["x"] - 1) ** 2 + abs(np.log(c["lr"]) + 2) / 3 + 0.1 * c["c"], SPACE,
           algo=algo, max_evals=20, trials=trials, rstate=np.random.default_rng(5),
           device="cpu", show_progressbar=False, recorder=recorder, **kw)
    return trials.losses(), [t["misc"]["vals"] for t in trials.trials]


@pytest.mark.parametrize("mode", ["solo_durable", "engine"])
def test_an_armed_recorder_changes_no_stream(tmp_path, mode):
    if mode == "engine":
        algo, kw = partial(H.tpe.suggest, **TPE), {"engine": True, "ask_ahead": 2}
        names = {"driver.trial", "ask.submit", "ask.queued", "serve.dispatch", "ask.delivered",
                 "tell.wal_append", "tell.applied", "tell"}
    else:
        algo = partial(H.tpe.suggest, fused=True, **TPE)
        kw = {"trials_save_file": str(tmp_path / "ck.pkl")}
        names = {"driver.trial", "tell.wal_append"}
    plain = _losses(algo, **(kw if mode == "engine" else {}))
    path = str(tmp_path / "flight.wal")
    rec = FlightRecorder(path=path)
    armed = _losses(algo, recorder=rec, **kw)
    rec.close()
    assert armed == plain
    spans = read_flight_log(path)
    assert names <= {s["name"] for s in spans}
    assert sum(s["name"] == "driver.trial" for s in spans) == 20
    assert audit_flight_log(path) == [] and JF.audit_flight_log(path) == []
