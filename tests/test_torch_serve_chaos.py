"""The port's durable service (``SuggestService(root=)``) under injected
crashes, as ``tests/test_serve_chaos.py`` holds the reference's.

Seeded ``FaultPlan``s arm each ``SERVE_CRASH_POINTS`` point; the harness
catches the simulated death, opens a new service over the same root and
finishes the workload.  Zero lost and zero duplicated tells (exact
per-study counts, unique tids, the WAL's tell totals), and every study's
final history bitwise the history of the run that never crashed.  Also
here: a storm of injected transient file errors and partial writes
(``FaultPlan(rate=, partial_rate=)``, whose decisions are the
reference's), ``ask(recover=True)``, a retell after a lost ack, the
guard, the counters against the reference service on one scenario, and
that what
the WAL and the snapshot hold is a copy of host truth, never a view of
device state (on the CPU a device tensor's ``.numpy()`` would alias it).
"""

import os

import numpy as np
import pytest

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.distributed import faults as JF
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.distributed.faults import (
    ALL_CRASH_POINTS,
    SERVE_CRASH_POINTS,
    FaultPlan,
    SimulatedCrash,
)
from hyperopt_tpu_torch.exceptions import CheckpointError
from hyperopt_tpu_torch.serve import SuggestService
from hyperopt_tpu_torch.utils.checkpoint import load_obs_buffer_bytes, load_pickle_guarded
from hyperopt_tpu_torch.utils.wal import TellWAL


@pytest.fixture(autouse=True)
def _lockdep_armed(monkeypatch):
    # the runtime lockdep sanitizer rides every scenario here: each
    # BatchScheduler built runs with its lock and condition wrapped, an
    # observed lock-order inversion raises where it is acquired, and the
    # teardown assert catches the non-raising (Condition re-acquire) path
    from hyperopt_tpu_torch.analysis import lockdep

    dep = lockdep.arm_scheduler_class(monkeypatch)
    yield dep
    assert dep.inversions == 0, dep.errors


def space(h):
    return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -5, 0),
            "c": h.choice("c", [0, 1])}


ALGO_KW = dict(n_cand=16, n_cand_cat=8)
NAMES = ("a", "b", "c")
R = 5  # tells per study the workload ends with, exactly


def loss_fn(vals):
    return vals["x"] ** 2 / 10 + abs(float(np.log(vals["lr"])) + 2) / 3


def make_service(root, fs, cadence=4):
    return SuggestService(space(hp), root=root, fs=fs, background=False, n_startup_jobs=2,
                          snapshot_cadence=cadence, max_batch=4, device="cpu", **ALGO_KW)


def drive(svc, handles):
    """Ask, pump, tell until every study holds R tells; a restored study
    first takes back what a crash left undelivered (``recover=True``),
    as a client that lost its replies does."""
    for h in handles.values():
        st = h._study
        while st.pending_asks or st.outstanding:
            tid, vals = h.ask(timeout=10, recover=True)
            h.tell(tid, loss_fn(vals))
    while True:
        live = [(n, h) for n, h in handles.items() if svc.scheduler.study(n).buf.count < R]
        if not live:
            return
        futs = [(h, h.ask_async()) for _, h in live]
        svc.pump()
        for h, fut in futs:
            tid, vals = fut.result(timeout=10)
            h.tell(tid, loss_fn(vals))


def run_scenario(root, crash_point=None, crash_at=2, cadence=4, plan=None):
    plan = FaultPlan(seed=0) if plan is None else plan
    if crash_point is not None:
        plan.arm(crash_point, at=crash_at)
    n_crashes = 0
    for _attempt in range(10):  # bounded: each crash point is one-shot
        svc = make_service(root, plan.fs(), cadence=cadence)
        try:
            drive(svc, {n: svc.create_study(n, seed=30 + i) for i, n in enumerate(NAMES)})
        except SimulatedCrash:
            n_crashes += 1
            continue  # a dead service publishes nothing more; restart
        break
    out = {}
    for n in NAMES:
        st = svc.scheduler.study(n)
        buf = st.buf
        out[n] = {"count": buf.count, "tids": buf.tids[: buf.count].tolist(),
                  "losses": buf.losses[: buf.count].tolist(),
                  "values": buf.values[:, : buf.count].copy(),
                  "wal_total_tells": st.persist.wal.total_tells}
    svc.shutdown()
    return out, n_crashes


_CLEAN = {}


def clean_run(tmp_path_factory, cadence=4):
    if cadence not in _CLEAN:
        _CLEAN[cadence] = run_scenario(str(tmp_path_factory.mktemp("clean")),
                                       cadence=cadence)[0]
    return _CLEAN[cadence]


def assert_exact(out, ref, tag):
    for n, st in out.items():
        assert st["count"] == R and len(set(st["tids"])) == R, (tag, n, st["tids"])
        assert st["wal_total_tells"] == R, (tag, n, st["wal_total_tells"])
        assert st["tids"] == ref[n]["tids"] and st["losses"] == ref[n]["losses"], (tag, n)
        np.testing.assert_array_equal(st["values"], ref[n]["values"])


@pytest.mark.parametrize("point", SERVE_CRASH_POINTS)
def test_crash_point_zero_lost_zero_duplicate(tmp_path, tmp_path_factory, point):
    """Each serve crash point: after the restart the workload ends with
    exactly R tells per study, and every study's history is bitwise the
    uninterrupted run's."""
    out, n_crashes = run_scenario(str(tmp_path / "root"), crash_point=point)
    assert n_crashes == 1, f"{point} never fired"
    assert_exact(out, clean_run(tmp_path_factory), point)


def test_file_fault_storm_is_exact_and_bitwise_the_clean_run(tmp_path, tmp_path_factory):
    """Transient ``ESTALE``/``EIO`` on every gated fs primitive at rate
    0.1, and partial writes, burst-bounded: the retries absorb them, every
    study ends with exactly R tells logged once, and the histories are
    bitwise the run without faults."""
    plan = FaultPlan(seed=7, rate=0.10, partial_rate=0.05)
    out, n_crashes = run_scenario(str(tmp_path / "storm"), plan=plan)
    assert n_crashes == 0
    assert plan.stats["error:partial_write"] > 0
    assert sum(v for k, v in plan.stats.items() if k.startswith("error:")) > 10
    assert_exact(out, clean_run(tmp_path_factory), "file storm")


def _fs_script(plan, tmp):
    """One scripted sequence of fs operations through ``plan.fs()``: what
    each raised, and the plan's log."""
    fs, raised = plan.fs(), []
    for i in range(40):
        path = os.path.join(tmp, f"f{i % 3}")
        for op in (lambda: fs.open(path, "w").close(), lambda: fs.exists(path),
                   lambda: fs.rename(path, path + ".r") or fs.rename(path + ".r", path),
                   lambda: fs.stat(path), lambda: fs.listdir(tmp)):
            try:
                op()
                raised.append(None)
            except OSError as e:
                raised.append(e.errno)
        with open(path, "w") as f:
            f.write("x")  # a file for the next round, whatever was injected
    return raised, [entry for entry in plan.log], dict(plan.stats)


def test_fault_plan_makes_the_reference_decisions(tmp_path):
    kw = dict(seed=5, rate=0.2, partial_rate=0.3, latency=0.0005, burst=2)
    for side in ("t", "j"):
        (tmp_path / side / "d").mkdir(parents=True)  # the same names: the log keys them
    mine = _fs_script(FaultPlan(**kw), str(tmp_path / "t" / "d"))
    ref = _fs_script(JF.FaultPlan(**kw), str(tmp_path / "j" / "d"))
    assert mine == ref
    assert sum(x is not None for x in mine[0]) > 10
    assert FaultPlan(**kw).split("w").seed == JF.FaultPlan(**kw).split("w").seed
    assert JF.DEFAULT_ERRORS == FaultPlan().errors


def test_crash_mid_batch_late_arm(tmp_path, tmp_path_factory):
    """Armed after snapshots compacted the WAL: replay crosses a snapshot."""
    out, n_crashes = run_scenario(str(tmp_path / "late"), crash_point="serve_mid_batch",
                                  crash_at=4, cadence=3)
    assert n_crashes == 1
    assert_exact(out, clean_run(tmp_path_factory, cadence=3), "late")


def test_restore_from_wal_only(tmp_path, tmp_path_factory):
    out, n_crashes = run_scenario(str(tmp_path / "walonly"),
                                  crash_point="serve_after_wal_before_dispatch", crash_at=3,
                                  cadence=10_000)
    assert n_crashes == 1
    assert_exact(out, clean_run(tmp_path_factory, cadence=10_000), "wal-only")


def test_restore_refuses_a_foreign_study_guard(tmp_path):
    root = str(tmp_path / "guard")
    svc = make_service(root, FaultPlan(seed=0).fs())
    svc.create_study("a", seed=1).tell(0, 1.0, vals={"x": 0.5, "lr": 0.1, "c": 0})
    svc.shutdown()
    svc2 = SuggestService({"x": hp.uniform("x", -1, 1)}, root=root, background=False,
                          max_batch=4, device="cpu")
    with pytest.raises(CheckpointError):
        svc2.create_study("a", seed=1)
    svc2.shutdown()


def test_retell_after_lost_ack_not_duplicated(tmp_path):
    root = str(tmp_path / "retell")
    plan = FaultPlan(seed=0).arm("serve_after_wal_before_dispatch", at=1)
    svc = make_service(root, plan.fs())
    h = svc.create_study("a", seed=9)
    fut = h.ask_async()
    svc.pump()
    tid, vals = fut.result(timeout=10)
    with pytest.raises(SimulatedCrash):
        h.tell(tid, loss_fn(vals))  # durable, applied only on restore
    svc2 = make_service(root, FaultPlan(seed=1).fs())
    h2 = svc2.create_study("a", seed=9)
    st = svc2.scheduler.study("a")
    assert st.buf.count == 1
    h2.tell(tid, loss_fn(vals), vals=vals)  # the client retries its lost ack
    assert st.buf.count == 1 and st.persist.wal.total_tells == 1
    svc2.shutdown()


def test_ask_recover_returns_the_outstanding_suggestion(tmp_path):
    """After a crash, ``ask(recover=True)`` serves the undelivered asks
    again: one served before the crash (its recorded vals) and one
    logged but never served (its logged seed, bitwise what the crashed
    service would have served); then a new ask draws on."""
    root = str(tmp_path / "recover")
    ref_svc = make_service(str(tmp_path / "ref"), FaultPlan(seed=0).fs())
    rh = ref_svc.create_study("a", seed=4)
    f0, f1 = rh.ask_async(), None
    ref_svc.pump()
    f1 = rh.ask_async()
    ref_svc.pump()
    want = [f0.result(timeout=10), f1.result(timeout=10)]
    ref_svc.shutdown()

    plan = FaultPlan(seed=0).arm("serve_mid_batch", at=2)
    svc = make_service(root, plan.fs())
    h = svc.create_study("a", seed=4)
    fut = h.ask_async()
    svc.pump()
    assert fut.result(timeout=10) == want[0]
    h.ask_async()
    with pytest.raises(SimulatedCrash):
        svc.pump()  # the second ask is logged, never served
    svc2 = make_service(root, FaultPlan(seed=1).fs())
    h2 = svc2.create_study("a", seed=4)
    st = svc2.scheduler.study("a")
    assert sorted(st.outstanding) == [0] and sorted(st.pending_asks) == [1]
    assert h2.ask(timeout=10, recover=True) == want[0]
    h2.tell(0, loss_fn(want[0][1]))
    assert h2.ask(timeout=10, recover=True) == want[1]
    assert not st.pending_asks and sorted(st.outstanding) == [1]
    h2.tell(1, loss_fn(want[1][1]))
    assert h2.ask(timeout=10, recover=True)[0] == 2  # nothing left: a new draw
    svc2.shutdown()


def _counter_scenario(svc):
    """Six rounds of three studies; study "a" fails its fourth trial."""
    hs = [svc.create_study(n, seed=50 + i) for i, n in enumerate(NAMES)]
    for r in range(6):
        futs = [(h, h.ask_async()) for h in hs]
        svc.pump()
        for h, f in futs:
            tid, vals = f.result(timeout=30)
            if r == 3 and h.name == "a":
                h.fail(tid, doc={"error": "boom"})
            else:
                h.tell(tid, loss_fn(vals))
    c = dict(svc.counters)
    svc.shutdown()
    return c


def test_counters_equal_the_reference_service(tmp_path):
    """One durable scenario on both packages' services (group commit on,
    a snapshot every 4 tells): the deterministic counters agree, the
    WAL's fsyncs and tells included."""
    jc = _counter_scenario(JService(space(jhp), root=str(tmp_path / "j"), background=False,
                                    n_startup_jobs=2, snapshot_cadence=4, max_batch=4,
                                    **ALGO_KW))
    tc = _counter_scenario(SuggestService(space(hp), root=str(tmp_path / "t"),
                                          background=False, n_startup_jobs=2,
                                          snapshot_cadence=4, max_batch=4, device="cpu",
                                          **ALGO_KW))
    keys = ("dispatch_count", "upload_events", "upload_bytes", "joins", "rebuckets",
            "admitted_count", "group_commit_barriers", "wal_fsyncs", "wal_tells",
            "host_algo_served")
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}
    assert tc["wal_tells"] == 17 and tc["group_commit_barriers"] > 0


def test_wal_and_snapshot_hold_copies_of_host_truth(tmp_path):
    """On the CPU, scribble over the scheduler's stacked state and the
    round's delta rows after a round: the WAL's served and tell records
    and the snapshot's history read back unchanged."""
    root = str(tmp_path / "alias")
    svc = make_service(root, FaultPlan(seed=0).fs(), cadence=10_000)
    h = svc.create_study("a", seed=3)
    for _ in range(4):
        fut = h.ask_async()
        svc.pump()
        tid, vals = fut.result(timeout=10)
        h.tell(tid, loss_fn(vals))
    sched = svc.scheduler
    for t in sched._state:
        t.fill_(float("nan")) if t.is_floating_point() else t.zero_()
    for arr in sched._delta_cache:
        arr.fill(0)
    st = sched.study("a")
    before = st.buf.values[:, : st.buf.count].copy()
    svc.close_study("a")  # the durable close publishes the snapshot
    recs = TellWAL(st.persist.wal.path).replay()
    assert recs == []  # compacted into the snapshot
    snap = load_pickle_guarded(st.persist.snap_path)
    buf = load_obs_buffer_bytes(svc.ps, snap["obs_npz"])
    np.testing.assert_array_equal(buf.values[:, : buf.count], before)
    assert buf.count == 4 and np.isfinite(buf.values[:, :4][buf.active[:, :4]]).all()
    svc.shutdown()


def test_wal_records_are_not_views_of_the_round(tmp_path):
    """Before any compaction: the WAL's served vals equal what the client
    got, after the round's output buffers were scribbled over."""
    root = str(tmp_path / "alias2")
    svc = make_service(root, FaultPlan(seed=0).fs(), cadence=10_000)
    h = svc.create_study("a", seed=3)
    got = []
    for _ in range(3):
        fut = h.ask_async()
        svc.pump()
        got.append(fut.result(timeout=10))
        h.tell(got[-1][0], loss_fn(got[-1][1]))
    for t in svc.scheduler._state:
        if t.is_floating_point():
            t.fill_(-1.0)
    recs = TellWAL(svc.scheduler.study("a").persist.wal.path).replay()
    served = {r["tid"]: r["vals"] for r in recs if r["kind"] == "served"}
    told = {r["tid"]: r["vals"] for r in recs if r["kind"] == "tell"}
    assert served == told == {tid: vals for tid, vals in got}
    svc.shutdown()


def test_serve_points_registered():
    assert set(SERVE_CRASH_POINTS) <= set(ALL_CRASH_POINTS)
    assert set(SERVE_CRASH_POINTS) == {
        "serve_after_wal_before_dispatch", "serve_mid_batch",
        "serve_after_dispatch_before_ack", "serve_group_commit_after_flush_before_barrier",
    }


def test_snapshots_never_race_a_round_on_one_wal(tmp_path):
    """A background service snapshotting after every tell while its loop
    serves other studies: the snapshot compacts a WAL that the next round
    barriers (group commit), so the two must not interleave.  Sixteen
    client threads (more than the cores), a short switch interval: every
    ask and tell succeeds, every tell is logged once and restores."""
    import sys
    import threading

    root = str(tmp_path / "root")
    svc = SuggestService({"x": hp.uniform("x", -5, 5), "c": hp.choice("c", [0, 1, 2])},
                         root=root, background=True, max_batch=16, n_startup_jobs=2,
                         n_cand=8, n_cand_cat=4, snapshot_cadence=1, device="cpu")
    errors, n_tells = [], 30

    def client(i):
        h = svc.create_study(f"s{i}", seed=i)
        try:
            for _ in range(n_tells):
                tid, vals = h.ask(timeout=60)
                h.tell(tid, vals["x"] ** 2)
        except Exception as e:  # ferried to the assert below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a client hung"
    finally:
        sys.setswitchinterval(interval)
        svc.shutdown()
    assert not errors, errors[:3]
    again = SuggestService({"x": hp.uniform("x", -5, 5), "c": hp.choice("c", [0, 1, 2])},
                           root=root, background=False, device="cpu", n_cand=8, n_cand_cat=4)
    for i in range(16):
        assert again.create_study(f"s{i}").n_tells == n_tells
    again.shutdown()
