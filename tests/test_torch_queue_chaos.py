"""The port's file job queue under seeded faults (from
``tests/test_chaos.py``): no job is ever lost and none is completed
twice.

Every queue crash point of ``distributed/faults.py`` (``CRASH_POINTS``,
nine) is fired once and recovered exactly once; two workers drain 12
jobs under a 10% transient-error rate with every worker crash point armed;
a lost heartbeat drops the stale result; ``reap`` releases a completed
claim; the worker loop drains on SIGTERM, exits 2 on a crash loop, and
backs off through a transient outage.
"""

import collections
import errno
import os
import pickle
import signal
import threading
import time
import types

import pytest

import hyperopt_tpu_torch as H
from hyperopt_tpu_torch.base import JOB_STATE_DONE, SONify, Domain
from hyperopt_tpu_torch.distributed import FileJobQueue, FileTrials, _common
from hyperopt_tpu_torch.distributed.faults import (
    ALL_CRASH_POINTS,
    CRASH_POINTS,
    FaultPlan,
    FaultyFS,
    SimulatedCrash,
)
from hyperopt_tpu_torch.distributed.filequeue import worker_owner
from hyperopt_tpu_torch.distributed.worker import main_worker_helper, run_one

SPACE = H.hp.uniform("x", 0, 1)
LATE = "FMinIter_Domain.late"


def _objective(x):
    return float(x)


def _domain(fn=_objective):
    return Domain(fn, SPACE, device="cpu")


def make_doc(tid):
    return {
        "tid": tid, "state": 0, "spec": None, "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]}, "vals": {"x": [0.5]}},
        "exp_key": None, "owner": None, "version": 0, "book_time": None,
        "refresh_time": None,
    }


class CountingFS(FaultyFS):
    """Counts the renames that land in ``done/``: a tid renamed there
    twice is a duplicate DONE publish."""

    def __init__(self, plan, done_counter):
        super().__init__(plan)
        self.done_counter = done_counter

    def rename(self, src, dst):
        super().rename(src, dst)
        if os.path.basename(os.path.dirname(dst)) == "done" and dst.endswith(".json"):
            self.done_counter[os.path.basename(dst)] += 1


def _with_restarts(op):
    """Run ``op()`` again after each simulated death (a one-shot point
    fires at most once, so this ends)."""
    while True:
        try:
            return op()
        except SimulatedCrash:
            continue


def _publish_missing(queue, docs, dirpath):
    """A restarted driver publishes exactly the docs that never reached
    the queue."""
    for doc in docs:
        name = f"{doc['tid']}.json"
        if not any(os.path.exists(os.path.join(dirpath, sub, name))
                   for sub in ("new", "running", "done")):
            _with_restarts(lambda d=doc: queue.publish(d))


def test_every_queue_crash_point_is_armable():
    assert len(CRASH_POINTS) == 9 and set(CRASH_POINTS) <= set(ALL_CRASH_POINTS)


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_point_recovered_exactly_once(tmp_path, point):
    """A process killed at ``point`` (the driver publishing a job or the
    Domain, a worker claiming, completing, giving back or reaping) loses
    nothing: after restarts and reaping, both jobs are DONE exactly once."""
    dirpath = str(tmp_path / "q")
    plan = FaultPlan(seed=5).arm(point)
    done_counter = collections.Counter()
    queue = FileJobQueue(dirpath, fs=CountingFS(plan, done_counter))
    _with_restarts(lambda: queue.attachments.__setitem__(
        "FMinIter_Domain", pickle.dumps(_domain())))
    docs = [make_doc(0), make_doc(1)]
    if point == "after_unreserve_utime_before_rename":
        docs[0]["misc"]["cmd"] = ("domain_attachment", LATE)  # given back until published
    try:
        for doc in docs:
            queue.publish(doc)
    except SimulatedCrash:
        _publish_missing(queue, docs, dirpath)
    if point == "after_reap_utime_before_rename":
        assert queue.reserve("abandoner") is not None  # a stale claim to recycle

    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            time.sleep(0.06)
            queue.reap(0.05)
            if not run_one(queue, worker_owner()):
                if queue.counts() == {"new": 0, "running": 0, "done": 2}:
                    break
        except SimulatedCrash:
            queue = FileJobQueue(dirpath, fs=CountingFS(plan, done_counter))  # the restart
        except Exception as e:
            assert getattr(e, "failed_tid", None) == 0, e
            queue.attachments[LATE] = pickle.dumps(_domain())

    assert plan.stats[f"crash:{point}"] == 1, "the armed point never fired"
    assert set(queue.done_docs()) == {0, 1}
    assert dict(done_counter) == {"0.json": 1, "1.json": 1}
    assert queue.counts() == {"new": 0, "running": 0, "done": 2}


def test_attachment_crash_leaves_the_previous_value_whole(tmp_path):
    plan = FaultPlan(seed=7)
    queue = FileJobQueue(str(tmp_path / "q"), fs=plan.fs())
    queue.attachments["blob"] = b"v1" * 100
    ops = [op for op, _, _ in plan.log if op in ("fsync", "rename")]
    assert ops.index("fsync") < ops.index("rename")  # fsynced before published
    plan.arm("after_attach_fsync_before_rename")
    with pytest.raises(SimulatedCrash):
        queue.attachments["blob"] = b"v2" * 100
    assert queue.attachments["blob"] == b"v1" * 100
    queue.attachments["blob"] = b"v2" * 100
    assert queue.attachments["blob"] == b"v2" * 100


def _drain_worker(dirpath, fs, name, stop, reserve_timeout=0.3):
    """A worker process in a loop: a simulated death restarts it (a fresh
    queue, its claim left to the reaper), an outage backs it off, a job
    whose Domain will not load cools down."""
    queue = FileJobQueue(dirpath, fs=fs)
    owner = f"{worker_owner()}/{name}"
    bad_tids = _common.TTLSet(ttl=0.3)
    while not stop.is_set():
        try:
            queue.reap(reserve_timeout)
            ran = run_one(queue, owner, heartbeat=reserve_timeout / 3.0,
                          exclude_tids=bad_tids.current())
        except SimulatedCrash:
            queue = FileJobQueue(dirpath, fs=fs)
            continue
        except OSError:
            time.sleep(0.01)
            continue
        except Exception as e:
            if getattr(e, "failed_tid", None) is None:
                raise
            bad_tids.add(e.failed_tid)
            time.sleep(0.005)
            continue
        if not ran:
            time.sleep(0.005)


def test_two_workers_drain_12_jobs_under_faults_at_every_crash_point(tmp_path):
    dirpath = str(tmp_path / "q")
    root_plan = FaultPlan(seed=99, rate=0.10, errors=(errno.ESTALE, errno.EIO), latency=0.001,
                          partial_rate=0.05, burst=2)
    done_counter = collections.Counter()
    driver_plan = root_plan.split("driver")
    driver_plan.arm("after_publish_tmp_before_rename", at=7)
    driver_plan.arm("after_attach_fsync_before_rename", at=2)  # the late Domain's write
    worker_plans = [root_plan.split(f"worker{i}") for i in range(2)]
    for p in worker_plans:
        for point in CRASH_POINTS:
            if point not in ("after_publish_tmp_before_rename",
                             "after_attach_fsync_before_rename"):
                p.arm(point)
    trials = FileTrials(dirpath, reserve_timeout=0.5, refresh=False,
                        fs=CountingFS(driver_plan, done_counter))
    _with_restarts(lambda: trials.attachments.__setitem__(
        "FMinIter_Domain", pickle.dumps(_domain())))
    docs = H.rand.suggest(trials.new_trial_ids(12), _domain(), trials, 99)
    docs[0]["misc"]["cmd"] = ("domain_attachment", LATE)
    try:
        trials.insert_trial_docs(docs)
    except SimulatedCrash:
        _publish_missing(trials.queue, [SONify(d) for d in docs], dirpath)
    stop = threading.Event()
    workers = [threading.Thread(target=_drain_worker, daemon=True,
                                args=(dirpath, CountingFS(worker_plans[i], done_counter),
                                      f"w{i}", stop))
               for i in range(2)]
    for w in workers:
        w.start()
    check = FileJobQueue(dirpath)
    try:
        # the late Domain appears only once a worker has given job 0 back
        # (its unreserve point fired): a fixed wait raced the workers, and
        # a run whose first claim of job 0 came after the publish never
        # reached that point
        deadline = time.time() + 60
        while time.time() < deadline and not any(
                p.stats.get("crash:after_unreserve_utime_before_rename") for p in worker_plans):
            time.sleep(0.01)
        _with_restarts(lambda: trials.attachments.__setitem__(LATE, pickle.dumps(_domain())))
        deadline = time.time() + 120
        while time.time() < deadline and check.counts() != {"new": 0, "running": 0, "done": 12}:
            time.sleep(0.05)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30)
    done = check.done_docs()
    assert set(done) == set(range(12)), "a job was lost"
    assert done_counter == {f"{tid}.json": 1 for tid in done}, "a DONE doc was published twice"
    trials.refresh()
    assert sum(t["state"] == JOB_STATE_DONE for t in trials.trials) == 12
    fired = collections.Counter()
    for p in [driver_plan] + worker_plans:
        for k, v in p.stats.items():
            if k.startswith("crash:"):
                fired[k.split(":", 1)[1]] += v
    assert all(fired[point] >= 1 for point in CRASH_POINTS), fired


_GATE, _STARTED = threading.Event(), threading.Event()


def _gated_objective(x):
    _STARTED.set()
    assert _GATE.wait(10)
    return float(x)


def test_heartbeat_loss_mid_evaluation_yields_one_done(tmp_path, caplog):
    _GATE.clear()
    _STARTED.clear()
    dirpath = str(tmp_path / "q")
    queue = FileJobQueue(dirpath)
    queue.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_gated_objective))
    queue.publish(make_doc(0))
    worker = threading.Thread(target=run_one, args=(queue, "stale-worker"),
                              kwargs={"heartbeat": 0.02}, daemon=True)
    worker.start()
    assert _STARTED.wait(10)
    running = os.path.join(dirpath, "running", "0.json")
    os.utime(running)
    os.rename(running, os.path.join(dirpath, "new", "0.json"))  # reaped underneath it
    time.sleep(0.08)
    with caplog.at_level("WARNING", logger="hyperopt_tpu_torch.distributed.worker"):
        _GATE.set()
        worker.join(timeout=10)
    assert not worker.is_alive() and queue.counts()["done"] == 0
    assert any("claim lost" in r.message for r in caplog.records)
    assert run_one(queue, "healthy-worker")
    done = queue.done_docs()
    assert set(done) == {0} and done[0]["owner"] == "healthy-worker"
    assert queue.counts() == {"new": 0, "running": 0, "done": 1}


def test_reap_releases_a_completed_claim(tmp_path):
    plan = FaultPlan(seed=8).arm("after_done_rename_before_unlink")
    queue = FileJobQueue(str(tmp_path / "q"), fs=plan.fs())
    queue.attachments["FMinIter_Domain"] = pickle.dumps(_domain())
    queue.publish(make_doc(0))
    with pytest.raises(SimulatedCrash):
        run_one(queue, worker_owner())
    assert queue.counts() == {"new": 0, "running": 1, "done": 1}
    time.sleep(0.06)
    assert queue.reap(0.05) == 0  # released, not recycled
    assert queue.counts() == {"new": 0, "running": 0, "done": 1}


_SIGTERM_SENT = threading.Event()


def _self_sigterm_objective(x):
    if not _SIGTERM_SENT.is_set():
        _SIGTERM_SENT.set()
        os.kill(os.getpid(), signal.SIGTERM)
    return float(x)


def _options(dirpath, **kw):
    base = dict(dir=dirpath, exp_key=None, max_jobs=None, poll_interval=0.01,
                reserve_timeout=5.0, last_job_timeout=10.0, workdir=None, max_crash_loop=5)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _run_loop(options):
    prev = signal.getsignal(signal.SIGTERM)
    try:
        return main_worker_helper(options)
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_sigterm_drains_the_worker_loop(tmp_path):
    _SIGTERM_SENT.clear()
    dirpath = str(tmp_path / "q")
    queue = FileJobQueue(dirpath)
    queue.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_self_sigterm_objective))
    for tid in range(3):
        queue.publish(make_doc(tid))
    assert _run_loop(_options(dirpath)) == 0
    assert _SIGTERM_SENT.is_set()
    assert queue.counts() == {"new": 2, "running": 0, "done": 1}


def test_crash_loop_guard_exits_loudly(tmp_path):
    dirpath = str(tmp_path / "q")
    FileJobQueue(dirpath)
    plan = FaultPlan(seed=1, rate=1.0, errors=(errno.EPERM,), burst=None, ops=("listdir",))
    rc = _run_loop(_options(dirpath, poll_interval=0.002, reserve_timeout=None,
                            max_crash_loop=3, fs=plan.fs()))
    assert rc == 2 and plan.stats["error:listdir"] >= 3


def test_transient_outage_backs_off_then_recovers(tmp_path):
    dirpath = str(tmp_path / "q")
    queue = FileJobQueue(dirpath)
    queue.attachments["FMinIter_Domain"] = pickle.dumps(_domain())
    queue.publish(make_doc(0))
    outage = {"left": 12}  # more consecutive ESTALEs than one operation retries

    class HealingFS(FaultyFS):
        def listdir(self, path):
            if outage["left"] > 0:
                outage["left"] -= 1
                raise OSError(errno.ESTALE, "injected outage")
            return super().listdir(path)

    rc = _run_loop(_options(dirpath, max_jobs=1, poll_interval=0.002, reserve_timeout=None,
                            last_job_timeout=5.0, max_crash_loop=10,
                            fs=HealingFS(FaultPlan(seed=1))))
    assert rc == 0 and outage["left"] == 0 and queue.counts()["done"] == 1
