"""``fmin(engine=True, ask_ahead=k)``: the port's engine client
(``hyperopt_tpu_torch.client``) against the port's solo driver and the
reference's engine client, as ``tests/test_client.py`` holds the
reference.

* the stream of an engine-routed ``fmin`` is bitwise the port's solo
  fused stream at ``ask_ahead`` 1, 2 and 4 (submit-time seeds and the
  study's ``fresh_window`` gate), for TPE and anneal, and ATPE through
  its ``host_algo`` hook is bitwise the solo ATPE;
* it equals the reference's engine-routed stream up to the first
  divergence, which must be a near-tie of the reference's own ask (llr
  margin < 1e-3, the rule of ``test_torch_serve_batched.py``);
* ``resolve_engine_algo`` maps the port's algos and refuses the rest
  with the reference's messages; two concurrent clients share one
  service; ``Overloaded`` backoff ends in ``DeadlineExpired``, never a
  hang; containment, ``points_to_evaluate``, durable failures, the
  refused roots and the recorder's spans behave as the reference's.
"""

import functools
import threading
import time

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import tpe_jax
from hyperopt_tpu.fmin import partial as jpartial
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer
from hyperopt_tpu.jax_trials import host_key
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu_torch import client as C
from hyperopt_tpu_torch.base import STATUS_FAIL
from hyperopt_tpu_torch.client import CLIENT_STUDY, resolve_engine_algo
from hyperopt_tpu_torch.exceptions import CheckpointError, DeadlineExpired, Overloaded
from hyperopt_tpu_torch.fmin import partial
from hyperopt_tpu_torch.obs import FlightRecorder
from hyperopt_tpu_torch.serve import SuggestService

from test_torch_serve import ALGO_KW, N_STARTUP, NEAR_TIE, SPACE, loss_fn
from test_torch_serve_batched import J_SPACE, PRIOR_LOG_RTOL, picks_differ, ref_margins


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


TPE_KW = dict(n_EI_candidates=ALGO_KW["n_cand"], n_EI_candidates_cat=ALGO_KW["n_cand_cat"],
              n_startup_jobs=N_STARTUP)
CLIENT_TPE = partial(H.tpe.suggest, **TPE_KW)
N_FAST = 30  # past the warm boundary (3) and ATPE's judged-at-20 gate


def objective(cfg):
    return loss_fn(cfg)


def run_fmin(algo, n=N_FAST, seed=7, obj=objective, trials=None, **kw):
    trials = H.Trials() if trials is None else trials
    H.fmin(obj, SPACE, algo=algo, max_evals=n, trials=trials,
           rstate=np.random.default_rng(seed), show_progressbar=False, return_argmin=False,
           device="cpu", **kw)
    return trials


def stream(trials):
    """Everything deterministic about a doc."""
    return [(t["tid"], t["state"], t["misc"]["idxs"], t["misc"]["vals"], t["result"])
            for t in trials._dynamic_trials]


_REF = {}


def solo_reference(key, algo, **kw):
    if key not in _REF:
        _REF[key] = stream(run_fmin(algo, **kw))
    return _REF[key]


def fused_reference():
    return solo_reference("tpe-fused", partial(H.tpe.suggest, fused=True, **TPE_KW))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_engine_stream_is_the_solo_fused_stream_at_any_depth(k):
    got = stream(run_fmin(CLIENT_TPE, engine=True, ask_ahead=k))
    assert got == fused_reference()


def test_anneal_engine_stream_is_the_solo_resident_stream():
    ref = solo_reference("anneal", partial(H.anneal.suggest, resident=True))
    assert stream(run_fmin(H.anneal.suggest, engine=True)) == ref
    assert stream(run_fmin(H.anneal.suggest, ask_ahead=3)) == ref


def test_atpe_hook_stream_is_the_solo_atpe_stream():
    """ATPE rides its study's host_algo hook (its host decision layer
    cannot run across studies): bitwise the solo adaptive driver."""
    algo = partial(H.atpe.suggest, n_startup_jobs=N_STARTUP)
    ref = solo_reference("atpe", algo)
    svc = SuggestService(SPACE, algo="atpe", max_batch=2, background=False,
                         n_startup_jobs=N_STARTUP, device="cpu")
    assert stream(run_fmin(algo, engine=svc)) == ref
    assert svc.counters["host_algo_served"] == N_FAST and svc.counters["dispatch_count"] == 0
    svc.shutdown()


def test_engine_stream_matches_the_reference_engine_up_to_a_near_tie():
    """The reference's ``fmin(engine=True)`` with ``tpe_jax`` and the
    port's with ``tpe``: prior draws equal (log-space dims within 1e-6),
    warm picks equal until the first divergence, which is a near-tie of
    the reference's own ask on the reference's history."""
    n, seed = 40, 7
    jt = J.Trials()
    J.fmin(loss_fn, J_SPACE, algo=jpartial(tpe_jax.suggest, **TPE_KW), max_evals=n, trials=jt,
           rstate=np.random.default_rng(seed), show_progressbar=False, engine=True)
    tt = run_fmin(CLIENT_TPE, n=n, seed=seed, engine=True)
    from hyperopt_tpu.ops.compile import compile_space as jcompile
    from hyperopt_tpu_torch.ops.compile import compile_space as tcompile

    jps, tps = jcompile(J_SPACE), tcompile(SPACE, device="cpu")
    rng = np.random.default_rng(seed)
    told = []
    n_checked = 0
    for k, (jd, td) in enumerate(zip(jt.trials, tt.trials, strict=True)):
        s = int(rng.integers(2**31 - 1))
        jvals = {lab: v[0] for lab, v in jd["misc"]["vals"].items() if v}
        tvals = {lab: v[0] for lab, v in td["misc"]["vals"].items() if v}
        if k < N_STARTUP:
            assert {lab: v for lab, v in jvals.items() if lab != "lr"} == \
                   {lab: v for lab, v in tvals.items() if lab != "lr"}
            assert np.isclose(jvals["lr"], tvals["lr"], rtol=PRIOR_LOG_RTOL, atol=0)
        else:
            jv = np.array([jvals[lab] for lab in jps.labels], np.float32)
            tv = np.array([tvals[lab] for lab in jps.labels], np.float32)
            differ = picks_differ(tps, jv, tv)
            n_checked += 1
            if differ.any():
                buf = JObsBuffer(jps)
                for vals, loss in told:
                    buf.add(dict(vals), loss)
                arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)]
                               for a in buf.arrays())
                margins = ref_margins(jps, arrays, host_key(s % (2**31 - 1)))
                assert np.all(margins[differ] < NEAR_TIE), (k, margins, differ)
                break
        told.append((jvals, jd["result"]["loss"]))
    assert n_checked > 10


@pytest.mark.parametrize("algo, name, kw", [
    (H.tpe.suggest, "tpe", {"n_cand": 128, "n_cand_cat": 24, "gamma": 0.25}),
    (partial(H.tpe.suggest, fused=True, n_EI_candidates=16, gamma=0.3), "tpe",
     {"n_cand": 16, "gamma": 0.3}),
    (functools.partial(H.anneal.suggest, shrink_coef=0.2), "anneal", {"shrink_coef": 0.2}),
    (partial(H.atpe.suggest, n_startup_jobs=5), "atpe", {}),
])
def test_resolve_engine_algo_maps_the_ports_algos(algo, name, kw):
    spec = resolve_engine_algo(algo)
    assert spec.name == name
    assert {k: spec.algo_kw[k] for k in kw} == kw
    if name == "atpe":
        assert spec.hook_kw["n_startup_jobs"] == 5 == spec.n_startup_jobs


@pytest.mark.parametrize("algo, match", [
    (H.rand.suggest, "cannot route"),
    (J.tpe.suggest, "cannot route"),  # the reference's module of the same short name
    (partial(H.tpe.suggest, speculative=8), "speculative"),
    (partial(H.tpe.suggest, joint_ei=True), "joint_ei"),
    (partial(H.tpe.suggest, bogus=1), "cannot map algo keyword"),
])
def test_resolve_engine_algo_refuses_the_rest(algo, match):
    with pytest.raises(ValueError, match=match):
        resolve_engine_algo(algo)


def test_remote_study_raises_naming_its_item():
    """The socket client is ported (item 12c): with nothing listening it
    raises ``PeerUnreachable`` naming its target after bounded retries
    (``tests/test_torch_transport.py`` drives it against live servers)."""
    import socket

    from hyperopt_tpu_torch.exceptions import PeerUnreachable

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    lsock.close()  # nobody listens here now
    with pytest.raises(PeerUnreachable, match=f"127.0.0.1:{port}"):
        C.RemoteStudy("127.0.0.1", port, "s0", connect_timeout=0.5, max_retries=1)


def test_engine_argument_refusals(tmp_path):
    with pytest.raises(ValueError, match="max_queue_len"):
        run_fmin(CLIENT_TPE, n=2, engine=True, max_queue_len=4)
    legacy = tmp_path / "ckpt.pkl"
    legacy.write_bytes(b"not a study root")
    with pytest.raises(CheckpointError, match="DIRECTORY"):
        run_fmin(CLIENT_TPE, n=2, engine=True, trials_save_file=str(legacy))
    with pytest.raises(CheckpointError, match="no .* study artifacts"):
        run_fmin(CLIENT_TPE, n=2, engine=True, resume_from=str(tmp_path / "nowhere"))
    with pytest.raises(ValueError, match="compiled=True"):
        run_fmin(CLIENT_TPE, n=2, engine=True, compiled=True)
    assert not C._SHARED_SERVICES  # no refused call left a registry hold


def test_two_concurrent_clients_share_one_service():
    """Two fmin calls of one study family at once: one service, two
    studies (``fmin`` and ``fmin-2``), each stream its solo stream."""
    gate = threading.Barrier(2, timeout=30)
    seen = []

    def obj(cfg):
        if len(seen) < 2:  # the first trial of each client meets the other's
            try:
                gate.wait()
            except threading.BrokenBarrierError:
                pass
        seen.append([(v[1], sorted(v[0].studies())) for v in C._SHARED_SERVICES.values()])
        return objective(cfg)

    out = {}

    def client(seed):
        out[seed] = stream(run_fmin(CLIENT_TPE, n=12, seed=seed, obj=obj, engine=True))

    threads = [threading.Thread(target=client, args=(s,)) for s in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    shared = [studies for snap in seen for refs, studies in snap if refs == 2]
    assert shared, "the two clients never shared a service"
    assert shared[0] == [CLIENT_STUDY, f"{CLIENT_STUDY}-2"]
    assert not C._SHARED_SERVICES  # the last client out shut it down
    for seed in (7, 8):
        ref = stream(run_fmin(partial(H.tpe.suggest, fused=True, **TPE_KW), n=12, seed=seed))
        assert out[seed] == ref


def _tiny_service(**kw):
    return SuggestService(SPACE, background=False, n_startup_jobs=2, n_cand=8, n_cand_cat=8,
                          device="cpu", **kw)


def test_overloaded_backoff_retries_until_served():
    svc = _tiny_service(max_queue=1)
    a, b = svc.create_study("a", seed=1), svc.create_study("b", seed=2)
    a.ask_async()  # fills the bounded queue
    with pytest.raises(Overloaded):
        b.ask(timeout=0.2)
    drained = threading.Event()

    def drain():
        time.sleep(0.1)
        svc.pump()
        drained.set()

    t = threading.Thread(target=drain)
    t.start()
    tid, vals = b.ask(timeout=10.0, backoff=True)
    t.join(timeout=10)
    assert drained.is_set() and tid == 0 and vals
    assert svc.scheduler.shed_count >= 1
    svc.shutdown()


def test_overloaded_backoff_ends_in_deadline_expired():
    """Nothing ever drains: the handle's and the client's bounded retries
    both escalate with DeadlineExpired at the deadline, never a hang."""
    svc = _tiny_service(max_queue=1)
    svc.create_study("a", seed=1).ask_async()
    b = svc.create_study("b", seed=2)
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExpired):
        b.ask(timeout=0.3, backoff=True)
    assert time.perf_counter() - t0 < 5.0
    domain = H.Domain(objective, SPACE, device="cpu")
    client, _, _, _ = C.connect(svc, CLIENT_TPE, domain, H.Trials(),
                                np.random.default_rng(0))
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExpired, match="overloaded|deadline"):
        client.next_suggestion(timeout=0.3)
    assert time.perf_counter() - t0 < 5.0
    client.finalize()
    svc.shutdown()


def test_containment_through_the_client_matches_solo():
    def flaky(cfg):
        if cfg["c"] == 2:
            raise ValueError("boom")
        if cfg["q"] == 0.0:
            return float("nan")
        return objective(cfg)

    kw = dict(obj=flaky, catch=(ValueError,))
    ref = stream(run_fmin(partial(H.tpe.suggest, fused=True, **TPE_KW), **kw))
    got = stream(run_fmin(CLIENT_TPE, engine=True, **kw))
    assert got == ref
    assert any(t[4].get("status") == STATUS_FAIL for t in got)


def test_points_to_evaluate_ride_the_client_path():
    pts = [{"x": 1.0, "lr": 0.1, "q": 4.0, "c": 1}]
    ref = stream(run_fmin(partial(H.tpe.suggest, fused=True, **TPE_KW), n=10,
                          points_to_evaluate=pts))
    got = stream(run_fmin(CLIENT_TPE, n=10, engine=True, points_to_evaluate=pts))
    assert got == ref and got[0][3]["x"] == [1.0]


def test_durable_failures_never_rerun_on_resume(tmp_path):
    root = str(tmp_path / "fails")
    calls = []

    def flaky(cfg):
        calls.append(dict(cfg))
        if len(calls) == 5:
            raise ValueError("boom at call 5")
        return objective(cfg)

    t1 = run_fmin(CLIENT_TPE, n=10, seed=3, obj=flaky, catch=(ValueError,), engine=True,
                  trials_save_file=root)
    fail_docs = [t for t in t1._dynamic_trials if t["result"].get("status") == STATUS_FAIL]
    assert len(fail_docs) == 1
    before = len(calls)
    t2 = run_fmin(CLIENT_TPE, n=14, seed=0, obj=flaky, catch=(ValueError,), engine=True,
                  resume_from=root)
    assert len(calls) == before + 4  # only the 4 new trials ran
    assert stream(t1) == stream(t2)[:10]
    assert [t["tid"] for t in t2._dynamic_trials
            if t["result"].get("status") == STATUS_FAIL] == [fail_docs[0]["tid"]]


def test_driver_spans_carry_the_client_study_id():
    rec = FlightRecorder(capacity=4096)
    run_fmin(CLIENT_TPE, n=6, engine=True, recorder=rec)
    by_name = {}
    for s in rec.tail():
        by_name.setdefault(s["name"], []).append(s)
    assert {"driver.trial", "ask.delivered", "tell", "ask.submit"} <= set(by_name)
    for name in ("driver.trial", "ask.delivered", "tell"):
        assert all(s.get("study") == CLIENT_STUDY for s in by_name[name]), name
    assert {s["tid"] for s in by_name["driver.trial"]} <= {
        s["tid"] for s in by_name["ask.delivered"]}
