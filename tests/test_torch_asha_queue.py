"""The port's ASHA over the file job queue (``distributed/asha_queue.py``)
against the reference's (``tests/test_distributed.py``) and against the
port's in-process ``hyperband.asha``.

The pickled ``BudgetedDomainFn`` hands a worker's objective the job's
budget; a queue-backed scheduler store is refused and a queue nobody
serves times every job out; and with one in-process worker,
``asha_filequeue(inflight=1)`` records the configs and losses of
``asha(workers=1)`` from the same rstate, TPE rung-0 asks included.
"""

import pickle
import threading
import time

import numpy as np
import pytest

import hyperopt_tpu_torch as H
from hyperopt_tpu.distributed.asha_queue import BudgetedDomainFn as JBudgetedDomainFn
from hyperopt_tpu_torch import hyperband as HB
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.distributed import (
    FileJobQueue,
    FileTrials,
    ThreadTrials,
    asha_filequeue,
)
from hyperopt_tpu_torch.distributed.asha_queue import BudgetedDomainFn
from hyperopt_tpu_torch.distributed.filequeue import worker_owner
from hyperopt_tpu_torch.distributed.worker import run_one
from hyperopt_tpu_torch.exceptions import AllTrialsFailed
from hyperopt_tpu_torch.models.synthetic import budgeted_quadratic_fn, budgeted_quadratic_space


def _job(tid, budget, x=0.5):
    return {
        "tid": tid, "state": 0, "spec": None, "result": {"status": "new"},
        "misc": {"tid": tid, "cmd": ("domain_attachment", "FMinIter_Domain"),
                 "idxs": {"x": [tid]}, "vals": {"x": [x]}, "budget": budget},
        "exp_key": None, "owner": None, "version": 0, "book_time": None,
        "refresh_time": None,
    }


def test_budgeted_domain_fn_reaches_the_worker(tmp_path):
    q = FileJobQueue(str(tmp_path / "q"))
    domain = Domain(BudgetedDomainFn(budgeted_quadratic_fn), budgeted_quadratic_space(),
                    device="cpu")
    q.attachments["FMinIter_Domain"] = pickle.dumps(domain)
    for tid, budget in (("t0", 1), ("t1", 9)):
        q.publish(_job(tid, budget))
    assert run_one(q, worker_owner()) and run_one(q, worker_owner())
    done = q.done_docs()
    for tid, budget in (("t0", 1), ("t1", 9)):
        assert done[tid]["result"]["loss"] == budgeted_quadratic_fn({"x": 0.5}, budget)
    assert done["t0"]["result"]["loss"] != done["t1"]["result"]["loss"]
    assert BudgetedDomainFn.fmin_pass_expr_memo_ctrl is JBudgetedDomainFn.fmin_pass_expr_memo_ctrl


def test_queue_backed_scheduler_stores_are_refused(tmp_path):
    for store in (FileTrials(str(tmp_path / "other"), reserve_timeout=None),
                  ThreadTrials(parallelism=2)):
        with pytest.raises(ValueError, match="in-memory Trials"):
            asha_filequeue(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=4,
                           dirpath=str(tmp_path / "q"), trials=store, device="cpu")


def test_a_queue_nobody_serves_times_every_job_out(tmp_path):
    with pytest.raises(AllTrialsFailed):
        asha_filequeue(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=4,
                       dirpath=str(tmp_path / "q"), eta=2, max_jobs=4, inflight=2,
                       rstate=np.random.default_rng(0), eval_timeout=0.3, poll_interval=0.02,
                       device="cpu")
    # the timed-out jobs may still be evaluated later: their Domain stays
    assert [k for k in FileJobQueue(str(tmp_path / "q")).attachments.keys()
            if k.startswith("FMinIter_Domain.asha-")]


def _records(out):
    return [(t["misc"]["vals"], t["result"]["loss"], t["result"]["budget"])
            for t in out["trials"].trials]


def test_one_worker_records_the_in_process_asha(tmp_path):
    """``inflight=1`` against ``workers=1``: the same promotions, configs
    and losses in the same order; rung 0 asks through TPE on the driver
    once 20 evaluations are recorded."""
    dirpath = str(tmp_path / "q")
    queue = FileJobQueue(dirpath)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            if not run_one(queue, "in-process"):
                time.sleep(0.002)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    kw = dict(max_budget=9, eta=3, max_jobs=30, algo=H.tpe.suggest, device="cpu")
    try:
        got = asha_filequeue(budgeted_quadratic_fn, budgeted_quadratic_space(), dirpath=dirpath,
                             inflight=1, rstate=np.random.default_rng(4), poll_interval=0.002,
                             **kw)
    finally:
        stop.set()
        th.join(timeout=10)
    want = HB.asha(budgeted_quadratic_fn, budgeted_quadratic_space(), workers=1,
                   rstate=np.random.default_rng(4), **kw)
    assert _records(got) == _records(want)
    assert got["rungs"] == want["rungs"] and got["best_loss"] == want["best_loss"]
    done = queue.done_docs()
    assert len(done) == 30 and {d["owner"] for d in done.values()} == {"in-process"}
    assert {d["misc"]["budget"] for d in done.values()} == {1, 3, 9}
    # a finished run deletes its Domain attachment
    assert not [k for k in queue.attachments.keys() if k.startswith("FMinIter_Domain.asha-")]
