"""The port's concurrency pack (GL5xx) on the port's own scheduler, and
the runtime lockdep sanitizer's contract.

The mutation kill-checks break ONE concurrency seam of the real
``hyperopt_tpu_torch/serve/scheduler.py`` textually and assert, with
nothing executed, that the named finding appears: a deleted
``with self._lock:`` guard (GL501), two swapped acquisition sites
(GL502), a dispatch moved out of the watchdog seam and under the lock
(GL503).  The lockdep cases are the reference's, on the port's wrapper,
plus the arming seam on the port's ``BatchScheduler``.
"""

import os
import threading

import pytest

from hyperopt_tpu_torch.analysis.engine import lint_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULER = "hyperopt_tpu_torch/serve/scheduler.py"


def _source():
    with open(os.path.join(REPO, SCHEDULER), encoding="utf-8") as f:
        return f.read()


def _trace(source):
    findings, _ = lint_source(source, path=SCHEDULER, pack="trace")
    return findings


def _mutate(src, old, new):
    assert src.count(old) == 1, old
    return src.replace(old, new)


def test_mutation_base_is_clean():
    assert _trace(_source()) == []


def test_mutation_deleted_lock_guard_trips_gl501():
    mutant = _mutate(
        _source(),
        "        with self._lock:\n"
        "            try:\n"
        "                self._asks.remove(req)\n",
        "        if True:\n"
        "            try:\n"
        "                self._asks.remove(req)\n",
    )
    findings = _trace(mutant)
    assert "GL501" in {f.rule for f in findings}
    assert any("_asks" in f.message and "drop_request" in f.message for f in findings)


# a second lock, taken under the scheduler lock at two sites: the clean
# order; swapping one site's order is the mutation
_GATE = ("        self._lock = threading.RLock()\n",
         "        self._lock = threading.RLock()\n"
         "        self._gate = threading.Lock()\n")
_CIRCUIT = ("        with self._lock:\n"
            "            self.circuit_open = False\n",
            "        with self._lock, self._gate:\n"
            "            self.circuit_open = False\n")
_CLOSE = ("        with self._lock:\n"
          "            st = self._studies.pop(name)\n",
          "        with self._lock, self._gate:\n"
          "            st = self._studies.pop(name)\n")


def test_mutation_swapped_acquisition_sites_trips_gl502():
    ordered = _mutate(_mutate(_mutate(_source(), *_GATE), *_CIRCUIT), *_CLOSE)
    assert "GL502" not in {f.rule for f in _trace(ordered)}
    mutant = _mutate(ordered, "        with self._lock, self._gate:\n"
                              "            self.circuit_open = False\n",
                     "        with self._gate, self._lock:\n"
                     "            self.circuit_open = False\n")
    findings = [f for f in _trace(mutant) if f.rule == "GL502"]
    assert findings and all("_gate" in f.message and "_lock" in f.message for f in findings)


def test_mutation_dispatch_moved_under_lock_trips_gl503():
    mutant = _mutate(
        _source(),
        "self._state = self._run_dispatch(lambda: self._delta_fn(*state, *delta))",
        "self._state = self._delta_fn(*state, *delta)",
    )
    findings = _trace(mutant)
    assert [f.rule for f in findings] == ["GL503"], findings
    assert "compiled dispatch self._delta_fn()" in findings[0].message


# -- the runtime lockdep sanitizer ------------------------------------------


def test_lockdep_consistent_order_is_silent():
    from hyperopt_tpu_torch.analysis.lockdep import LockDep

    dep = LockDep()
    a = dep.wrap(threading.Lock(), "a")
    b = dep.wrap(threading.Lock(), "b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert dep.inversions == 0 and not dep.errors
    assert dep.acquisitions == 6 and dep.orders() == [("a", "b")]


def test_lockdep_inversion_raises_and_releases():
    from hyperopt_tpu_torch.analysis.lockdep import LockDep, LockOrderError

    dep = LockDep()
    a = dep.wrap(threading.Lock(), "a")
    b = dep.wrap(threading.Lock(), "b")
    with a:
        with b:
            pass
    with pytest.raises(LockOrderError):
        with b:
            with a:
                pass
    assert dep.inversions == 1
    # the failed acquisition must NOT leak the lock: both reacquire
    with a:
        pass
    with b:
        pass


def test_lockdep_rlock_reentrancy_records_once():
    from hyperopt_tpu_torch.analysis.lockdep import LockDep

    dep = LockDep()
    r = dep.wrap(threading.RLock(), "r")
    with r:
        with r:  # re-entrant: no self-edge, no double bookkeeping
            pass
        assert dep._stack() == ["r"]
    assert dep._stack() == []
    assert dep.acquisitions == 1


def test_lockdep_condition_wait_keeps_stack_exact():
    from hyperopt_tpu_torch.analysis.lockdep import LockDep

    dep = LockDep()
    traced = dep.wrap(threading.RLock(), "sched")
    cond = threading.Condition(traced)
    done = []

    def waiter():
        with cond:
            while not done:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        done.append(True)
        cond.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert dep.inversions == 0 and not dep.errors


def test_arm_scheduler_class_wraps_every_new_scheduler(monkeypatch):
    from hyperopt_tpu_torch.analysis import lockdep
    from hyperopt_tpu_torch.analysis.lockdep import _TracedLock
    from hyperopt_tpu_torch.serve.scheduler import BatchScheduler

    orig = BatchScheduler.__init__
    with monkeypatch.context() as mp:
        dep = lockdep.arm_scheduler_class(mp)
        assert BatchScheduler.__init__ is not orig
        sched = object.__new__(BatchScheduler)
        sched._lock = threading.RLock()
        lockdep.instrument_scheduler(sched, dep)
        assert isinstance(sched._lock, _TracedLock)
        with sched._cond:  # the condition rides the traced lock
            assert dep._stack() == [sched._lock.name]
    assert BatchScheduler.__init__ is orig  # disarmed with the patch
    assert dep.inversions == 0 and dep.acquisitions == 1
