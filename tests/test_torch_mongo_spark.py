"""The port's Mongo and Spark backends (``distributed/mongo.py``,
``distributed/spark.py``, ``asha_mongo``/``asha_spark``) over the
in-memory doubles of ``tests/fake_backends.py``, as the reference's
``tests/test_mongo_spark.py`` runs its own: the code under test is the
port's protocol (CAS reservation, reaping, GridFS Domain shipping,
dispatcher threads, job-group cancellation), not the doubles.

``fmin`` through ``MongoTrials`` (two ``MongoWorker`` threads) and
through ``SparkTrials`` gives the TPE stream of the port's sequential
``fmin`` at the same ``max_queue_len``, bitwise.

Against the reference on the same doubles: the stored job docs after
reserve, complete, unreserve, reap and a ``MongoWorker`` evaluation are
the reference's field for field (times and claim tokens by type); random
search through ``MongoTrials`` and ``SparkTrials`` at ``max_queue_len=1``
draws the reference's ``rand_jax`` stream within the 2-ulp draw rule of
``test_torch_rand.py``, with the same GridFS file names; and
``asha_mongo``/``asha_spark`` at ``inflight=1`` record the reference's
configs, budgets and losses from the same rstate, bitwise.
"""

import pickle
import signal
import threading
import time

import numpy as np
import pytest

from fake_backends import FakeSparkSession, install_fake_mongo, install_fake_spark

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import rand_jax
from hyperopt_tpu.base import Domain as JDomain
from hyperopt_tpu.models.synthetic import (
    budgeted_quadratic_space as j_budgeted_quadratic_space,
    mixed_space as j_mixed_space,
)
from hyperopt_tpu_torch.base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    STATUS_OK,
    Domain,
)
from hyperopt_tpu_torch.models.synthetic import (
    budgeted_quadratic_fn,
    budgeted_quadratic_space,
    mixed_space,
    mixed_space_fn,
)

from test_torch_rand import _assert_same_draws

SPACE = H.hp.uniform("x", 0, 1)


@pytest.fixture
def fake_mongo(monkeypatch):
    return install_fake_mongo(monkeypatch)


@pytest.fixture
def fake_spark(monkeypatch):
    return install_fake_spark(monkeypatch)


def _objective_a(x):
    return 10.0 + x


def _objective_b(x):
    return 20.0 + x


def _exploding(x):
    raise RuntimeError("mongo kaboom")


def _slow(x):
    time.sleep(0.6)
    return x


def _domain(fn, space=SPACE):
    return Domain(fn, space, device="cpu")


def _doc(tid, exp_key=None, cmd=None):
    return {
        "tid": tid, "state": JOB_STATE_NEW, "spec": None, "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": cmd, "idxs": {"x": [tid]}, "vals": {"x": [0.5]}},
        "exp_key": exp_key, "owner": None, "version": 0, "book_time": None,
        "refresh_time": None,
    }


def _jobs(db):
    from hyperopt_tpu_torch.distributed.mongo import MongoJobs

    return MongoJobs.new_from_connection_str(f"localhost:27017/{db}")


def _stream(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def _twin(n, seed, k):
    twin = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=twin,
           max_queue_len=k, rstate=np.random.default_rng(seed), device="cpu",
           show_progressbar=False)
    return _stream(twin)


# -- MongoJobs ----------------------------------------------------------------


def test_reserve_is_a_cas_in_insertion_order(fake_mongo):
    jobs = _jobs("db_cas")
    for tid in ("asha-0", 2, 0, "asha-1"):
        jobs.publish(_doc(tid))
    first = jobs.reserve("w1")
    assert first["tid"] == "asha-0" and first["state"] == JOB_STATE_RUNNING
    assert first["owner"] == "w1" and first["book_time"] is not None and first["claim"]
    assert [jobs.reserve(f"w{i}")["tid"] for i in range(3)] == [2, 0, "asha-1"]
    assert jobs.reserve("w") is None


def test_reserve_under_contention_takes_each_job_once(fake_mongo):
    jobs = _jobs("db_race")
    for tid in range(40):
        jobs.publish(_doc(tid))
    taken, lock, start = [], threading.Lock(), threading.Barrier(8)

    def worker(owner):
        start.wait()
        while (doc := jobs.reserve(owner)) is not None:
            with lock:
                taken.append(doc["tid"])
            time.sleep(0.001)

    threads = [threading.Thread(target=worker, args=(f"w{i}",)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(taken) == list(range(40))


def test_exp_key_reap_and_write_back(fake_mongo):
    jobs = _jobs("db_proto")
    jobs.publish(_doc(0, exp_key="A"))
    jobs.publish(_doc(1, exp_key="B"))
    jobs.publish(_doc(2, exp_key="B"))
    assert jobs.reserve("w", exp_key="B")["tid"] == 1
    assert jobs.reap(None) == 0
    time.sleep(0.05)
    assert jobs.reap(0.01) == 1
    assert jobs.coll.find_one({"tid": 1})["state"] == JOB_STATE_NEW
    d1 = jobs.reserve("w", exp_key="B")
    assert jobs.complete(d1, result={"status": STATUS_OK, "loss": 0.5}, require_claim=True)
    d2 = jobs.reserve("w", exp_key="B")
    jobs.complete(d2, error=("<class 'RuntimeError'>", "kaboom"))
    assert jobs.coll.find_one({"tid": 1})["result"]["loss"] == 0.5
    assert jobs.coll.find_one({"tid": 2})["misc"]["error"][1] == "kaboom"
    # a reaped claim's write-back matches nothing
    d0 = jobs.reserve("w")
    time.sleep(0.02)
    jobs.reap(0.01)
    assert not jobs.complete(d0, result={"status": STATUS_OK, "loss": 1.0}, require_claim=True)
    assert jobs.coll.find_one({"tid": 0})["state"] == JOB_STATE_NEW


def test_gridfs_attachments_round_trip_and_replace(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoTrials

    trials = MongoTrials("mongo://localhost:27017/db_att/jobs")
    assert "blob" not in trials.attachments
    trials.attachments["blob"] = b"\x00\x01"
    assert trials.attachments["blob"] == b"\x00\x01"
    trials.attachments["blob"] = "text-replaces"
    assert trials.attachments["blob"] == b"text-replaces"
    with pytest.raises(KeyError):
        trials.attachments["missing"]


def test_trials_ids_refresh_reap_and_delete(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoTrials

    conn = "mongo://localhost:27017/db_ids/jobs"
    t1, t2 = MongoTrials(conn, exp_key="drop"), MongoTrials(conn, reserve_timeout=0.01)
    ids1 = t1.new_trial_ids(3)
    t1.insert_trial_docs(H.rand.suggest(ids1, _domain(_objective_a), t1, 0))
    assert not set(ids1) & set(t2.new_trial_ids(3))
    jobs = _jobs("db_ids")
    jobs.publish(_doc(10, exp_key="keep"))
    jobs.reserve("w-dead", exp_key="keep")
    time.sleep(0.05)
    t2.refresh()  # reaps as it refreshes
    assert jobs.coll.find_one({"tid": 10})["state"] == JOB_STATE_NEW
    t1.delete_all()
    assert [d["exp_key"] for d in jobs.coll.find({})] == ["keep"]


# -- MongoWorker --------------------------------------------------------------


def test_worker_evaluates_fails_and_resolves_each_doc(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoWorker

    jobs = _jobs("db_worker")
    jobs.set_attachment("FMinIter_Domain", pickle.dumps(_domain(_objective_a)))
    jobs.set_attachment("FMinIter_Domain.asha-x1", pickle.dumps(_domain(_objective_b)))
    jobs.set_attachment("FMinIter_Domain.bad", pickle.dumps(_domain(_exploding)))
    for tid, key in ((0, "FMinIter_Domain"), (1, "FMinIter_Domain.asha-x1"),
                     (2, "FMinIter_Domain.bad")):
        jobs.publish(_doc(tid, cmd=("domain_attachment", key)))
    worker = MongoWorker(jobs)
    assert worker.run_one("w:1") and worker.run_one("w:1") and worker.run_one("w:1")
    assert not worker.run_one("w:1")
    assert 10.0 <= jobs.coll.find_one({"tid": 0})["result"]["loss"] < 11.0
    assert 20.0 <= jobs.coll.find_one({"tid": 1})["result"]["loss"] < 21.0
    bad = jobs.coll.find_one({"tid": 2})
    assert bad["state"] == JOB_STATE_ERROR and "mongo kaboom" in bad["misc"]["error"][1]


def test_worker_gives_back_a_job_whose_domain_is_missing(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoWorker

    jobs = _jobs("db_giveback")
    jobs.publish(_doc(0, cmd=("domain_attachment", "FMinIter_Domain.asha-dead")))
    worker = MongoWorker(jobs)
    with pytest.raises(KeyError, match="asha-dead"):
        worker.run_one("w:1")
    stored = jobs.coll.find_one({"tid": 0})
    assert stored["state"] == JOB_STATE_NEW and stored["owner"] is None
    assert not worker.run_one("w:1")  # on this worker's cooldown
    assert jobs.reserve("w:2")["tid"] == 0


def test_worker_heartbeat_and_republished_domain(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoWorker

    jobs = _jobs("db_beat")
    jobs.set_attachment("FMinIter_Domain", pickle.dumps(_domain(_slow)))
    jobs.publish(_doc(0))
    worker = MongoWorker(jobs, heartbeat=0.05)
    th = threading.Thread(target=worker.run_one, args=("w:1",))
    th.start()
    time.sleep(0.35)
    assert jobs.reap(reserve_timeout=0.15) == 0  # the claim stays alive
    th.join(timeout=10)
    assert jobs.coll.find_one({"tid": 0})["state"] == JOB_STATE_DONE
    jobs.set_attachment("FMinIter_Domain", pickle.dumps(_domain(_objective_b)))
    jobs.publish(_doc(1))
    assert worker.run_one("w:1")  # the same worker, the new Domain
    assert 20.0 <= jobs.coll.find_one({"tid": 1})["result"]["loss"] < 21.0


def test_main_worker_runs_max_jobs(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoTrials, main_worker

    conn = "localhost:27017/db_cli"
    trials = MongoTrials(f"mongo://{conn}/jobs")
    trials.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_objective_a))
    trials.insert_trial_docs(H.rand.suggest(trials.new_trial_ids(2), _domain(_objective_a),
                                            trials, 0))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert main_worker(["--mongo", conn, "--max-jobs", "2", "--poll-interval", "0.01"]) == 0
    finally:
        signal.signal(signal.SIGTERM, prev)
    trials.refresh()
    assert [t["state"] for t in trials.trials] == [JOB_STATE_DONE] * 2


# -- fmin through the stores --------------------------------------------------


def _worker_pool(conn, n, stop):
    from hyperopt_tpu_torch.distributed.mongo import MongoJobs, MongoWorker

    threads = []
    for i in range(n):
        worker = MongoWorker(MongoJobs.new_from_connection_str(conn))

        def loop(w=worker, owner=f"host{i}:{1000 + i}"):
            while not stop.is_set():
                if not w.run_one(owner):
                    time.sleep(0.005)

        threads.append(threading.Thread(target=loop, daemon=True))
        threads[-1].start()
    return threads


def test_fmin_through_mongo_trials_is_the_sequential_twin(fake_mongo):
    from hyperopt_tpu_torch.distributed.mongo import MongoTrials

    conn = "localhost:27017/db_fmin"
    trials = MongoTrials(f"mongo://{conn}/jobs", exp_key="exp1")
    stop = threading.Event()
    workers = _worker_pool(conn, 2, stop)
    try:
        H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=28, trials=trials,
               max_queue_len=4, rstate=np.random.default_rng(0), device="cpu",
               show_progressbar=False)
    finally:
        stop.set()
        for th in workers:
            th.join(timeout=10)
    assert _stream(trials) == _twin(28, 0, 4)
    assert {t["owner"] for t in trials.trials} <= {"host0:1000", "host1:1001"}


def test_fmin_through_spark_trials_is_the_sequential_twin(fake_spark):
    from hyperopt_tpu_torch.distributed.spark import SparkTrials

    session = FakeSparkSession()
    trials = SparkTrials(parallelism=4, spark_session=session)
    H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=28, trials=trials,
           rstate=np.random.default_rng(1), device="cpu", show_progressbar=False)
    assert _stream(trials) == _twin(28, 1, 4)
    assert session.sparkContext.parallelize_calls == 28
    assert {t["owner"] for t in trials.trials} == {"spark"}
    default = SparkTrials()  # pyspark.sql.SparkSession.builder.getOrCreate()
    assert default.parallelism == 2 and default._supports_cancel


def test_spark_trials_timeout_cancels_and_errors_are_captured(fake_spark):
    from hyperopt_tpu_torch.distributed.spark import SparkTrials

    def slow(x):
        time.sleep(0.15)
        return x

    session = FakeSparkSession()
    trials = SparkTrials(parallelism=1, timeout=0.5, spark_session=session)
    H.fmin(slow, SPACE, algo=H.rand.suggest, max_evals=500, trials=trials, max_queue_len=1,
           rstate=np.random.default_rng(0), device="cpu", show_progressbar=False,
           return_argmin=False)
    assert trials._fmin_cancelled and trials._fmin_cancelled_reason == "fmin run timeout"
    assert len(trials) < 500 and session.sparkContext.cancel_calls
    states = [t["state"] for t in trials.trials]
    assert JOB_STATE_CANCEL in states or len(states) < 500

    def flaky(x):
        if x > 0.5:
            raise ValueError("positive!")
        return x

    trials = SparkTrials(parallelism=2, spark_session=FakeSparkSession())
    H.fmin(flaky, SPACE, algo=H.rand.suggest, max_evals=10, trials=trials,
           rstate=np.random.default_rng(3), device="cpu", show_progressbar=False,
           return_argmin=False)
    assert {t["state"] for t in trials.trials} == {JOB_STATE_DONE, JOB_STATE_ERROR}
    err = next(t for t in trials.trials if t["state"] == JOB_STATE_ERROR)
    assert "positive!" in err["misc"]["error"][1]


# -- ASHA over Mongo and Spark --------------------------------------------------


def _ladder_ok(out, n):
    trials = out["trials"]
    assert len(trials) == n
    budgets = [t["result"]["budget"] for t in trials.trials]
    assert set(budgets) <= {1, 3, 9} and budgets.count(1) > budgets.count(9) > 0
    x_at = lambda b: {round(t["misc"]["vals"]["x"][0], 9)  # noqa: E731
                      for t in trials.trials if t["result"]["budget"] == b}
    assert x_at(3) <= x_at(1) and x_at(9) <= x_at(3)
    assert np.isfinite(out["best_loss"])


def test_asha_mongo_and_asha_spark(fake_mongo, fake_spark, tmp_path):
    from hyperopt_tpu_torch.distributed import FileTrials, ThreadTrials
    from hyperopt_tpu_torch.distributed.asha_queue import asha_filequeue, asha_mongo, asha_spark
    from hyperopt_tpu_torch.distributed.mongo import MongoTrials

    conn = "localhost:27017/db_asha"
    stop = threading.Event()
    workers = _worker_pool(conn, 2, stop)
    try:
        out = asha_mongo(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=9,
                         mongo=conn, eta=3, max_jobs=30, inflight=4,
                         rstate=np.random.default_rng(0), eval_timeout=120.0,
                         poll_interval=0.02, device="cpu")
    finally:
        stop.set()
        for th in workers:
            th.join(timeout=10)
    _ladder_ok(out, 30)
    done = list(_jobs("db_asha").coll.find({"state": JOB_STATE_DONE}))
    assert len(done) == 30 and {d["owner"] for d in done} <= {"host0:1000", "host1:1001"}
    assert {d["misc"]["budget"] for d in done} <= {1, 3, 9}

    spark = FakeSparkSession()
    out = asha_spark(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=9,
                     spark=spark, eta=3, max_jobs=30, inflight=4,
                     rstate=np.random.default_rng(0), device="cpu")
    _ladder_ok(out, 30)
    assert spark.sparkContext.parallelize_calls == 30

    for store in (FileTrials(str(tmp_path / "other"), reserve_timeout=None),
                  MongoTrials("mongo://localhost:27017/db_guard/jobs"),
                  ThreadTrials(parallelism=2)):
        with pytest.raises(ValueError, match="in-memory Trials"):
            asha_mongo(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=4,
                       mongo="localhost:27017/db_guard2", trials=store, device="cpu")
        with pytest.raises(ValueError, match="in-memory Trials"):
            asha_filequeue(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=4,
                           dirpath=str(tmp_path / "q"), trials=store, device="cpu")


# -- against the reference on the same doubles ----------------------------------


def _normal(doc):
    """A stored job doc with its clock readings and claim token by type:
    the two runs read different clocks and draw different tokens."""
    out = dict(doc)
    for key in ("book_time", "refresh_time"):
        if key in out:
            out[key] = type(out[key]).__name__
    if out.get("claim") is not None:
        assert isinstance(out["claim"], str) and len(out["claim"]) == 32
        out["claim"] = "token"
    return out


def _gridfs_names(jobs):
    return sorted(name for name, _ in jobs.db._gridfs.get("fs", {}).values())


def _protocol_run(pkg, db):
    """One scenario of the job protocol through ``pkg``'s MongoJobs and
    MongoWorker: what each call returned and the docs it left."""
    import importlib

    mongo = importlib.import_module(f"{pkg.__name__}.distributed.mongo")
    jobs = mongo.MongoJobs.new_from_connection_str(f"localhost:27017/{db}")
    for tid, key in ((0, "A"), (1, "B"), ("asha-2", "B"), (3, "B"), (4, None)):
        jobs.publish(_doc(tid, exp_key=key))
    r1 = jobs.reserve("w1", exp_key="B")
    r2 = jobs.reserve("w2", exclude_tids=(0,))
    r3 = jobs.reserve("w3")
    returned = [_normal(r) for r in (r1, r2, r3)]
    calls = [jobs.complete(r1, result={"status": STATUS_OK, "loss": 0.5}, require_claim=True),
             jobs.complete(r2, error=("<class 'RuntimeError'>", "kaboom"))]
    jobs.unreserve(r3)
    r4 = jobs.reserve("w4", exp_key="B")
    returned.append(_normal(r4))
    time.sleep(0.05)
    calls += [jobs.reap(0.01),
              jobs.complete(r4, result={"status": STATUS_OK, "loss": 1.0}, require_claim=True)]
    # a worker evaluates one job through the package's pickled Domain
    domain = (_domain(_objective_a) if pkg is H
              else JDomain(_objective_a, J.hp.uniform("x", 0, 1)))
    jobs.set_attachment("FMinIter_Domain", pickle.dumps(domain))
    jobs.set_attachment("FMinIter_Domain", pickle.dumps(domain))  # replaced, not kept twice
    jobs.publish(_doc(5, exp_key="C", cmd=("domain_attachment", "FMinIter_Domain")))
    calls.append(mongo.MongoWorker(jobs, exp_key="C").run_one("w:5"))
    docs = [_normal(d) for d in jobs.coll.find({}, sort=[("_id", 1)])]
    return returned, calls, docs, _gridfs_names(jobs)


def test_job_docs_are_the_references_through_the_protocol(fake_mongo):
    """Reserve (exp_key filter, exclusion, insertion order), DONE and
    ERROR write-back, unreserve, reap, a reaped claim's write-back and a
    worker's evaluation leave the reference's docs, field for field."""
    got = _protocol_run(H, "port_proto")
    want = _protocol_run(J, "ref_proto")
    assert got == want
    returned, calls, docs, names = got
    assert [r["tid"] for r in returned] == [1, "asha-2", 0, 3]
    assert calls == [True, True, 1, False, True]
    assert docs[-1]["state"] == JOB_STATE_DONE and names == ["FMinIter_Domain"]


def _ref_worker_pool(conn, n, stop):
    from hyperopt_tpu.distributed.mongo import MongoJobs as JMongoJobs, MongoWorker as JWorker

    threads = []
    for i in range(n):
        worker = JWorker(JMongoJobs.new_from_connection_str(conn))

        def loop(w=worker, owner=f"host{i}:{1000 + i}"):
            while not stop.is_set():
                if not w.run_one(owner):
                    time.sleep(0.005)

        threads.append(threading.Thread(target=loop, daemon=True))
        threads[-1].start()
    return threads


def _run_with_pool(pool, conn, run):
    stop = threading.Event()
    workers = pool(conn, 2, stop)
    try:
        return run()
    finally:
        stop.set()
        for th in workers:
            th.join(timeout=10)


def _same_docs_but_draws(jt, tt, owners):
    """The docs of two runs agree in every field but the draws (held by
    ``_assert_same_draws``), the losses computed from them, the clock
    readings and which worker of the pool took the job."""
    _assert_same_draws(jt, tt)
    for a, b in zip(jt.trials, tt.trials, strict=True):
        assert b["owner"] in owners and a["owner"] in owners
        assert b["result"]["loss"] == pytest.approx(a["result"]["loss"], rel=1e-5, abs=1e-6)
        a, b = _normal(a), _normal(b)
        for d in (a, b):
            d.pop("owner")
            d["result"] = {k: v for k, v in d["result"].items() if k != "loss"}
            d["misc"] = {k: v for k, v in d["misc"].items() if k != "vals"}
        assert b == a


def test_rand_through_mongo_trials_draws_the_references_stream(fake_mongo):
    """Random search at ``max_queue_len=1``: one seed per trial whatever
    the workers' timing, so both packages' streams are one stream."""
    from hyperopt_tpu.distributed.mongo import MongoTrials as JMongoTrials

    from hyperopt_tpu_torch.distributed.mongo import MongoTrials

    n = 12
    jt = JMongoTrials("mongo://localhost:27017/ref_rand/jobs", exp_key="e")
    _run_with_pool(_ref_worker_pool, "localhost:27017/ref_rand", lambda: J.fmin(
        mixed_space_fn, j_mixed_space(), algo=rand_jax.suggest, max_evals=n, trials=jt,
        max_queue_len=1, rstate=np.random.default_rng(6), show_progressbar=False))
    tt = MongoTrials("mongo://localhost:27017/port_rand/jobs", exp_key="e")
    _run_with_pool(_worker_pool, "localhost:27017/port_rand", lambda: H.fmin(
        mixed_space_fn, mixed_space(), algo=H.rand.suggest, max_evals=n, trials=tt,
        max_queue_len=1, rstate=np.random.default_rng(6), device="cpu",
        show_progressbar=False))
    assert len(tt) == len(jt) == n
    _same_docs_but_draws(jt, tt, {"host0:1000", "host1:1001"})
    assert _gridfs_names(tt.handle) == _gridfs_names(jt.handle) == ["FMinIter_Domain"]


def test_rand_through_spark_trials_draws_the_references_stream(fake_spark):
    from hyperopt_tpu.distributed.spark import SparkTrials as JSparkTrials

    from hyperopt_tpu_torch.distributed.spark import SparkTrials

    n = 12
    jsession, tsession = FakeSparkSession(), FakeSparkSession()
    jt = JSparkTrials(parallelism=2, spark_session=jsession)
    J.fmin(mixed_space_fn, j_mixed_space(), algo=rand_jax.suggest, max_evals=n, trials=jt,
           max_queue_len=1, rstate=np.random.default_rng(8), show_progressbar=False)
    tt = SparkTrials(parallelism=2, spark_session=tsession)
    H.fmin(mixed_space_fn, mixed_space(), algo=H.rand.suggest, max_evals=n, trials=tt,
           max_queue_len=1, rstate=np.random.default_rng(8), device="cpu",
           show_progressbar=False)
    _same_docs_but_draws(jt, tt, {"spark"})
    assert (tsession.sparkContext.parallelize_calls
            == jsession.sparkContext.parallelize_calls == n)


def _asha_records(out):
    return ([(t["misc"]["vals"], t["result"]) for t in out["trials"].trials],
            out["rungs"], out["best_loss"], out["best"])


def test_asha_mongo_and_asha_spark_record_the_references_runs(fake_mongo, fake_spark):
    """One evaluation in flight: the promotions, configs, budgets and
    losses of each transport's run are the reference's, bitwise."""
    from hyperopt_tpu.distributed.asha_queue import (
        asha_mongo as j_asha_mongo,
        asha_spark as j_asha_spark,
    )
    from hyperopt_tpu.models.synthetic import budgeted_quadratic_fn as j_fn

    from hyperopt_tpu_torch.distributed.asha_queue import asha_mongo, asha_spark

    kw = dict(max_budget=9, eta=3, max_jobs=20, inflight=1, poll_interval=0.002)
    want = _run_with_pool(_ref_worker_pool, "localhost:27017/ref_asha", lambda: j_asha_mongo(
        j_fn, j_budgeted_quadratic_space(), mongo="localhost:27017/ref_asha",
        rstate=np.random.default_rng(2), **kw))
    got = _run_with_pool(_worker_pool, "localhost:27017/port_asha", lambda: asha_mongo(
        budgeted_quadratic_fn, budgeted_quadratic_space(), mongo="localhost:27017/port_asha",
        rstate=np.random.default_rng(2), device="cpu", **kw))
    assert _asha_records(got) == _asha_records(want)
    kw.pop("poll_interval")
    want = j_asha_spark(j_fn, j_budgeted_quadratic_space(), spark=FakeSparkSession(),
                        rstate=np.random.default_rng(3), **kw)
    got = asha_spark(budgeted_quadratic_fn, budgeted_quadratic_space(),
                     spark=FakeSparkSession(), rstate=np.random.default_rng(3), device="cpu",
                     **kw)
    assert _asha_records(got) == _asha_records(want)
