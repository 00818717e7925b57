"""Runtime lockdep: the observed lock-order sanitizer (graftrace's
dynamic half).

GL502 proves acquisition order statically for what the AST can see;
this wrapper catches the rest at TEST time.  It records the order in
which wrapped locks are acquired, per thread, into a process-wide
order graph, and raises :class:`LockOrderError` at the FIRST
acquisition that inverts an order some thread already established --
no deadlock has to actually happen (the interleaving that would
deadlock is exactly the one the test schedule rarely runs).

Opt-in by design -- production code never pays the bookkeeping.  The
port's serve, serve-chaos, client and fleet-chaos suites arm it via
:func:`arm_scheduler_class` (an autouse fixture wraps every
:class:`~hyperopt_tpu_torch.serve.scheduler.BatchScheduler`'s lock and
rebuilds its condition over the wrapped lock), and assert zero observed
inversions at teardown; ``chip_smoke.py`` arms it the same way around
its serve and burst runs on the card.

stdlib-only at import (no torch): importable anywhere the engine is.
"""

from __future__ import annotations

import threading

__all__ = [
    "LockDep",
    "LockOrderError",
    "arm_scheduler_class",
    "instrument_scheduler",
]


class LockOrderError(RuntimeError):
    """Two locks were observed acquired in both orders."""


class LockDep:
    """One acquisition-order graph plus per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges = {}  # (held_name, acquired_name) -> first thread
        self._tls = threading.local()
        self.inversions = 0
        self.acquisitions = 0  # outermost acquisitions recorded
        self.errors = []

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def wrap(self, lock, name):
        """An order-recording proxy over ``lock`` (Lock or RLock)."""
        return _TracedLock(self, lock, name)

    # -- bookkeeping (called by the proxies) -------------------------------

    def note_acquired(self, name, check=True):
        """Record edges held->name for everything this thread holds;
        with ``check`` (the normal acquire path) raise on an observed
        inversion.  ``check=False`` (the Condition.wait re-acquire
        path, where raising would corrupt the Condition's state) still
        counts and records the inversion for the teardown assert."""
        st = self._stack()
        tname = threading.current_thread().name
        with self._mu:
            self.acquisitions += 1
            for held in st:
                if held == name:
                    continue
                self._edges.setdefault((held, name), tname)
                first = self._edges.get((name, held))
                if first is None:
                    continue
                self.inversions += 1
                msg = (
                    f"lock-order inversion: thread {tname!r} acquired "
                    f"{name!r} while holding {held!r}, but thread "
                    f"{first!r} established the opposite order "
                    f"({name!r} before {held!r})"
                )
                self.errors.append(msg)
                if check:
                    raise LockOrderError(msg)
        st.append(name)

    def orders(self):
        """Every distinct ``(held, acquired)`` order observed so far."""
        with self._mu:
            return sorted(self._edges)

    def note_released(self, name):
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                break


class _TracedLock:
    """Order-recording proxy over a Lock/RLock.

    Duck-types the full protocol ``threading.Condition`` binds off its
    lock (``_release_save`` / ``_acquire_restore`` / ``_is_owned``), so
    ``threading.Condition(dep.wrap(rlock, name))`` keeps the held
    stack exact across ``wait()`` -- the lock leaves the stack while
    the thread sleeps and re-enters it on wakeup."""

    def __init__(self, dep, inner, name):
        self._dep = dep
        self._inner = inner
        self.name = name
        self._depth = threading.local()

    def _get_depth(self):
        return getattr(self._depth, "n", 0)

    def _set_depth(self, n):
        self._depth.n = n

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            return ok
        d = self._get_depth()
        if d == 0:
            try:
                self._dep.note_acquired(self.name)
            except BaseException:
                self._inner.release()
                raise
        self._set_depth(d + 1)
        return ok

    def release(self):
        self._inner.release()
        d = self._get_depth() - 1
        self._set_depth(d)
        if d == 0:
            self._dep.note_released(self.name)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    # -- the Condition lock protocol ---------------------------------------

    def _release_save(self):
        d = self._get_depth()
        self._set_depth(0)
        self._dep.note_released(self.name)
        if hasattr(self._inner, "_release_save"):
            return (d, self._inner._release_save())
        self._inner.release()
        return (d, None)

    def _acquire_restore(self, saved):
        d, state = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._set_depth(d)
        self._dep.note_acquired(self.name, check=False)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def locked(self):
        if hasattr(self._inner, "locked"):
            return self._inner.locked()
        return self._get_depth() > 0


def instrument_scheduler(sched, dep=None):
    """Wrap an already-constructed BatchScheduler's ``_lock`` with a
    traced proxy and rebuild ``_cond`` over it.  Must run before the
    scheduler's threads start (i.e. right after ``__init__``)."""
    if dep is None:
        dep = LockDep()
    traced = dep.wrap(
        sched._lock, f"BatchScheduler._lock@{id(sched):#x}"
    )
    sched._lock = traced
    sched._cond = threading.Condition(traced)
    return dep


def arm_scheduler_class(monkeypatch, dep=None):
    """Arm lockdep for every BatchScheduler a test constructs: patches
    ``BatchScheduler.__init__`` through ``monkeypatch.setattr`` (the
    pytest fixture unwinds it automatically; any object with a
    ``setattr(target, name, value)`` that restores it later will do) to
    instrument each instance into the shared ``dep``.  Returns the
    :class:`LockDep`; assert ``dep.inversions == 0`` at teardown."""
    from ..serve.scheduler import BatchScheduler

    if dep is None:
        dep = LockDep()
    orig_init = BatchScheduler.__init__

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        instrument_scheduler(self, dep)

    monkeypatch.setattr(BatchScheduler, "__init__", __init__)
    return dep
