"""The port's file job queue (``distributed/filequeue.py``), its worker
(``distributed/worker.py``) and ``FileTrials`` under ``fmin``, against
the reference's (``tests/test_distributed.py``).

The queue protocol (exclusive reservation, the ``exp_key`` filter,
complete and reap, attachments), ``run_one`` (evaluation, error capture,
a republished Domain, a Domain per doc, the heartbeat), the job file's
bytes and ``fsck``'s issues against the reference's on one directory,
the TPE stream on ``FileTrials`` bitwise the sequential twin, late
completions, and one worker process (``python -m
hyperopt_tpu_torch.distributed.worker``) that never touches CUDA.
"""

import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as H
from hyperopt_tpu.distributed import fsck as j_fsck
from hyperopt_tpu.distributed.filequeue import FileJobQueue as JFileJobQueue
from hyperopt_tpu_torch.base import JOB_STATE_DONE, JOB_STATE_ERROR, STATUS_OK, Domain
from hyperopt_tpu_torch.distributed import FileJobQueue, FileTrials, fsck
from hyperopt_tpu_torch.distributed.filequeue import worker_owner
from hyperopt_tpu_torch.distributed.worker import WorkerExit, run_one
from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
from hyperopt_tpu_torch.torch_trials import obs_buffer_for
from hyperopt_tpu_torch.utils import coarse_utcnow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = H.hp.uniform("x", 0, 1)


def make_doc(tid, exp_key=None):
    return {
        "tid": tid, "state": 0, "spec": None, "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": None, "idxs": {"x": [tid]}, "vals": {"x": [0.5]}},
        "exp_key": exp_key, "owner": None, "version": 0, "book_time": None,
        "refresh_time": None,
    }


def _objective_a(x):
    return 10.0 + x


def _objective_b(x):
    return 20.0 + x


def _exploding(x):
    raise RuntimeError("kaboom")


def _domain(fn, space=SPACE):
    return Domain(fn, space, device="cpu")


def _queued(dirpath, fn, n, seed=0):
    """A FileTrials with the pickled Domain of ``fn`` and ``n`` random
    jobs."""
    trials = FileTrials(dirpath, reserve_timeout=None)
    domain = _domain(fn)
    trials.attachments["FMinIter_Domain"] = pickle.dumps(domain)
    trials.insert_trial_docs(H.rand.suggest(trials.new_trial_ids(n), domain, trials, seed))
    return trials


# -- the queue protocol -------------------------------------------------------


def test_reserve_is_exclusive_and_filters_by_exp_key(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    q.publish(make_doc(0, exp_key="A"))
    q.publish(make_doc(1, exp_key="B"))
    d = q.reserve("w1", exp_key="B")
    assert d["tid"] == 1 and d["owner"] == "w1" and d["claim"]
    assert q.reserve("w2", exp_key="B") is None
    assert q.reserve("w2")["tid"] == 0
    assert q.reserve("w3") is None
    assert q.counts() == {"new": 0, "running": 2, "done": 0}


def test_complete_and_reap(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    q.publish(make_doc(0))
    q.publish(make_doc(1))
    d0 = q.reserve("w1")
    d0["state"] = JOB_STATE_DONE
    d0["result"] = {"status": STATUS_OK, "loss": 1.0}
    assert q.complete(d0, require_claim=True)
    assert q.counts() == {"new": 1, "running": 0, "done": 1}
    q.reserve("w-dead")
    time.sleep(0.05)
    assert q.reap(reserve_timeout=0.01) == 1
    assert q.counts() == {"new": 1, "running": 0, "done": 1}
    assert q.done_docs()[0]["result"]["loss"] == 1.0


def test_reserve_refreshes_a_stale_mtime_before_its_rename(tmp_path, monkeypatch):
    from hyperopt_tpu_torch.distributed import filequeue

    q = FileJobQueue(str(tmp_path / "q"))
    q.publish(make_doc(0))
    stale = time.time() - 3600
    os.utime(str(tmp_path / "q" / "new" / "0.json"), (stale, stale))
    monkeypatch.setattr(filequeue, "_write_atomic", lambda path, doc, **kw: None)
    assert q.reserve("w1")["tid"] == 0
    assert time.time() - os.path.getmtime(str(tmp_path / "q" / "running" / "0.json")) < 60
    assert q.reap(reserve_timeout=120) == 0


def test_attachments_round_trip(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    q.attachments["blob/with:odd chars"] = b"\x00\x01\x02"
    assert q.attachments["blob/with:odd chars"] == b"\x00\x01\x02"
    assert "blob/with:odd chars" in q.attachments
    del q.attachments["blob/with:odd chars"]
    assert "blob/with:odd chars" not in q.attachments
    with pytest.raises(KeyError):
        q.attachments["missing"]


def test_job_files_are_the_reference_bytes(tmp_path):
    """The same doc (a datetime included) published by both packages'
    queues: the same bytes in ``new/``, and after a reserve both read
    back the same doc."""
    doc = make_doc(7, exp_key="e")
    doc["book_time"] = coarse_utcnow()
    doc["misc"]["cmd"] = ("domain_attachment", "FMinIter_Domain")
    tq, jq = FileJobQueue(str(tmp_path / "t")), JFileJobQueue(str(tmp_path / "j"))
    tq.publish(dict(doc))
    jq.publish(dict(doc))
    read = lambda root: open(os.path.join(root, "new", "7.json"), "rb").read()  # noqa: E731
    assert read(tq.root) == read(jq.root)
    got_t, got_j = tq.reserve("w"), jq.reserve("w")
    for d in (got_t, got_j):
        d.pop("claim")
        d.pop("book_time")
    assert got_t == got_j


def _corrupt_queue(dirpath):
    """Every issue kind of ``fsck --dir``, made by the port's queue."""
    queue = FileJobQueue(dirpath)
    queue.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_objective_a))
    for tid in range(4):
        queue.publish(make_doc(tid))
    assert run_one(queue, worker_owner())
    done0 = os.path.join(dirpath, "done", "0.json")
    assert queue.reserve("dead-worker")["tid"] == 1
    old = time.time() - 3600
    os.utime(os.path.join(dirpath, "running", "1.json"), (old, old))
    shutil.copy(done0, os.path.join(dirpath, "new", "0.json"))
    shutil.copy(done0, os.path.join(dirpath, "running", "0.json"))
    with open(os.path.join(dirpath, "new", "2.json"), "w") as f:
        f.write('{"tid": 2, "state"')
    tmp = os.path.join(dirpath, "done", "9.json.tmp.123")
    with open(tmp, "w") as f:
        f.write("{}")
    os.utime(tmp, (old, old))
    return queue


def test_fsck_issues_equal_the_reference_on_one_queue(tmp_path):
    dirpath = str(tmp_path / "q")
    queue = _corrupt_queue(dirpath)
    key = lambda issues: sorted((i.kind, i.path) for i in issues)  # noqa: E731
    got = fsck.audit(dirpath, reserve_timeout=60.0, tmp_grace=60.0)
    assert key(got) == key(j_fsck.audit(dirpath, reserve_timeout=60.0, tmp_grace=60.0))
    assert {i.kind for i in got} == {"stale_tmp", "half_written", "orphaned_claim",
                                     "completed_claim", "duplicate_tid"}
    assert fsck.main(["--dir", dirpath, "--repair", "--reserve-timeout", "60",
                      "--tmp-grace", "60"]) == 0
    assert j_fsck.audit(dirpath, reserve_timeout=60.0, tmp_grace=60.0) == []
    while run_one(queue, "fresh-worker"):
        pass
    assert set(queue.done_docs()) == {0, 1, 3}


# -- run_one ------------------------------------------------------------------


def test_run_one_evaluates_and_captures_errors(tmp_path):
    trials = _queued(str(tmp_path / "q"), _objective_a, 2)
    assert run_one(trials.queue, worker_owner())
    assert run_one(trials.queue, worker_owner())
    assert not run_one(trials.queue, worker_owner())
    trials.refresh()
    assert [t["state"] for t in trials.trials] == [JOB_STATE_DONE] * 2
    assert all(10.0 <= t["result"]["loss"] < 11.0 for t in trials.trials)

    bad = _queued(str(tmp_path / "bad"), _exploding, 1)
    assert run_one(bad.queue, worker_owner())
    bad.refresh()
    t = bad.trials[0]
    assert t["state"] == JOB_STATE_ERROR and "kaboom" in t["misc"]["error"][1]
    assert "RuntimeError" in t["misc"]["traceback"]


def test_domain_republished_after_asks_reloads_without_its_caches(tmp_path):
    """A domain that served TPE asks (its packed space, history buffer
    with a weakref, built suggest functions and the fused driver's
    ask-ahead hook cached on it) pickles to what ``__init__`` set, and a
    long-lived worker picks the republished objective up."""
    trials = _queued(str(tmp_path / "q"), _objective_a, 1)
    assert run_one(trials.queue, worker_owner())
    used = _domain(_objective_b, mixed_space())
    hist = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.partial(H.tpe.suggest, fused=True),
           max_evals=22, trials=hist, rstate=np.random.default_rng(0), device="cpu",
           show_progressbar=False)
    H.tpe.suggest([22], used, hist, 5)
    H.partial(H.tpe.suggest, fused=True)([23], used, hist, 6)
    assert any(k.startswith("_") for k in vars(used))
    clean = pickle.loads(pickle.dumps(used))
    assert not any(k.startswith("_") for k in vars(clean))
    assert clean.device == torch.device("cpu") and clean.params.keys() == used.params.keys()
    time.sleep(0.02)  # a distinct attachment identity
    trials.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_objective_b))
    trials.insert_trial_docs(H.rand.suggest(trials.new_trial_ids(1), _domain(_objective_b),
                                            trials, 1))
    assert run_one(trials.queue, worker_owner())
    trials.refresh()
    losses = sorted(t["result"]["loss"] for t in trials.trials)
    assert 10.0 <= losses[0] < 11.0 and 20.0 <= losses[1] < 21.0


def test_worker_gives_back_a_job_whose_domain_is_missing(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    doc = make_doc(0)
    doc["misc"]["cmd"] = ("domain_attachment", "FMinIter_Domain.asha-dead")
    q.publish(doc)
    with pytest.raises(WorkerExit, match="asha-dead") as exc:
        run_one(q, worker_owner())
    assert exc.value.failed_tid == 0
    assert q.counts() == {"new": 1, "running": 0, "done": 0}
    assert not run_one(q, worker_owner(), exclude_tids=[0])
    assert q.reserve("w2")["tid"] == 0


def test_worker_resolves_the_domain_per_doc(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    q.attachments["FMinIter_Domain"] = pickle.dumps(_domain(_objective_a))
    q.attachments["FMinIter_Domain.asha-x1"] = pickle.dumps(_domain(_objective_b))
    for tid, key in ((0, "FMinIter_Domain"), (1, "FMinIter_Domain.asha-x1")):
        doc = make_doc(tid)
        doc["misc"]["cmd"] = ("domain_attachment", key)
        q.publish(doc)
    assert run_one(q, worker_owner()) and run_one(q, worker_owner())
    done = q.done_docs()
    assert 10.0 <= done[0]["result"]["loss"] < 11.0
    assert 20.0 <= done[1]["result"]["loss"] < 21.0


_EVALUATING = threading.Event()


def _signalled_slow_objective(x):
    _EVALUATING.set()
    time.sleep(2.0)
    return x


def test_heartbeat_defeats_reaping_of_a_live_job(tmp_path):
    """A claim whose evaluation beats every 0.05 s is not reaped at a 0.15
    s timeout 0.35 s into the evaluation (its claim time is older).  The
    wait starts when the objective runs: the worker's Domain load before
    it is not heartbeated, and under a loaded host it can outlast the
    timeout by itself."""
    _EVALUATING.clear()
    trials = _queued(str(tmp_path / "q"), _signalled_slow_objective, 1)
    t = threading.Thread(target=run_one, args=(trials.queue, worker_owner()),
                         kwargs={"heartbeat": 0.05})
    t.start()
    assert _EVALUATING.wait(30)
    time.sleep(0.35)
    assert trials.queue.counts()["running"] == 1  # still evaluating
    assert trials.queue.reap(reserve_timeout=0.15) == 0
    t.join(timeout=10)
    assert not t.is_alive()
    assert trials.queue.counts() == {"new": 0, "running": 0, "done": 1}


# -- FileTrials under fmin ---------------------------------------------------


def _worker_threads(queue, n, stop):
    def loop(i):
        while not stop.is_set():
            if not run_one(queue, f"thread-worker:{i}"):
                time.sleep(0.005)

    threads = [threading.Thread(target=loop, args=(i,), daemon=True) for i in range(n)]
    for th in threads:
        th.start()
    return threads


def test_tpe_stream_on_file_trials_is_the_sequential_twin(tmp_path):
    """Two in-process workers: each round of 4 asks waits for its results,
    so the stream is bitwise ``fmin(max_queue_len=4)`` on a plain
    ``Trials``; the queue directory is the whole record (a pickled
    ``FileTrials`` revived elsewhere reads it back)."""
    n = 32
    trials = FileTrials(str(tmp_path / "q"), reserve_timeout=None)
    stop = threading.Event()
    threads = _worker_threads(trials.queue, 2, stop)
    try:
        H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=trials,
               max_queue_len=4, rstate=np.random.default_rng(2), device="cpu",
               show_progressbar=False)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    twin = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=n, trials=twin,
           max_queue_len=4, rstate=np.random.default_rng(2), device="cpu",
           show_progressbar=False)
    key = lambda ts: [(t["tid"], t["misc"]["vals"], t["result"]) for t in ts.trials]  # noqa: E731
    assert key(trials) == key(twin)
    assert {t["owner"] for t in trials.trials} <= {"thread-worker:0", "thread-worker:1"}
    revived = pickle.loads(pickle.dumps(trials))
    revived.refresh()
    assert key(revived) == key(twin)


def test_late_completions_reach_the_history_in_tid_order(tmp_path):
    """Results land out of order across refreshes; the history buffer
    (resident too) takes each at its tid position, equal to a buffer
    synced once on the finished store."""
    trials = FileTrials(str(tmp_path / "q"), reserve_timeout=None)
    domain = _domain(mixed_space_fn, mixed_space())
    trials.insert_trial_docs(H.rand.suggest(trials.new_trial_ids(24), domain, trials, 3))
    docs = [trials.queue.reserve("w") for _ in range(24)]
    first = [5, 2, 23, 0, 7, 11, 1, 3]
    order = first + [d for d in range(24) if d not in first]
    live = obs_buffer_for(domain, trials, resident=True)
    for i, tid in enumerate(order):
        doc = docs[tid]
        doc["state"] = JOB_STATE_DONE
        doc["result"] = {"status": STATUS_OK, "loss": float(tid) / 7.0}
        trials.queue.complete(doc, require_claim=True)
        if i % 5 == 0:
            trials.refresh()
            live = obs_buffer_for(domain, trials)
            assert live.count == i + 1
    trials.refresh()
    live = obs_buffer_for(domain, trials)
    fresh = H.Trials()
    fresh._insert_trial_docs([dict(t) for t in trials.trials])
    fresh.refresh()
    want = obs_buffer_for(_domain(mixed_space_fn, mixed_space()), fresh)
    assert live.count == want.count == 24
    assert sorted(live.tids[:24].tolist()) == list(range(24))
    by_tid = lambda b: {int(t): (b.values[:, i].tolist(), float(b.losses[i]))  # noqa: E731
                        for i, t in enumerate(b.tids[:24])}
    assert by_tid(live) == by_tid(want)


def test_worker_process_serves_a_card_domain_without_touching_cuda(tmp_path):
    """``python -m hyperopt_tpu_torch.distributed.worker`` with no CUDA
    device: it evaluates the jobs of a Domain pickled with ``device``
    cuda, never initializes CUDA, and drains on SIGTERM."""
    dirpath = str(tmp_path / "q")
    trials = FileTrials(dirpath, reserve_timeout=30.0)
    domain = _domain(mixed_space_fn, mixed_space())
    trials.insert_trial_docs(H.rand.suggest(trials.new_trial_ids(6), domain, trials, 4))
    domain.device = torch.device("cuda")
    trials.attachments["FMinIter_Domain"] = pickle.dumps(domain)
    probe = str(tmp_path / "probe.py")
    with open(probe, "w") as f:
        f.write("import atexit, sys, torch\n"
                "atexit.register(lambda: print('CUDA_INIT', torch.cuda.is_initialized(), "
                "file=sys.stderr))\n"
                "from hyperopt_tpu_torch.distributed.worker import main\n"
                "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, probe, "--dir", dirpath, "--max-jobs", "6",
                           "--poll-interval", "0.02"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CUDA_INIT False" in proc.stderr
    trials.refresh()
    assert [t["state"] for t in trials.trials] == [JOB_STATE_DONE] * 6
    for t in trials.trials:
        cfg = {k: v[0] for k, v in t["misc"]["vals"].items() if v}
        assert t["result"]["loss"] == mixed_space_fn(H.space_eval(mixed_space(), cfg))
    assert {t["owner"].split(":")[1] for t in trials.trials} != {str(os.getpid())}
    worker = subprocess.Popen([sys.executable, "-m", "hyperopt_tpu_torch.distributed.worker",
                               "--dir", dirpath, "--poll-interval", "0.02"], env=env, cwd=ROOT,
                              stderr=subprocess.PIPE, text=True)
    lines = []
    while not any("serving" in ln for ln in lines):  # the SIGTERM handler is installed
        lines.append(worker.stderr.readline())
        assert lines[-1], "".join(lines)
    worker.terminate()
    assert worker.wait(timeout=60) == 0
    assert "drained after 0 job(s)" in worker.stderr.read()
