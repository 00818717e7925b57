"""The port's study-batched serve engine against the port's own solo path.

Every study served out of a batched round must produce exactly the
suggestion stream its SOLO fused run produces: the port's
``tpe._state_dispatch`` on a resident ``ObsBuffer`` with the per-ask
seeds drawn from the study's own rstate stream, one tell per ask -- at
16 studies, across join/leave churn at two capacities, across a
sibling's bucket growth, and through a multi-tell backlog.  All on the
CPU (``device="cpu"``), where the ``gmm_llr`` wrapper takes its plain
version on the folded study axis.

Also here: the study axis of the building blocks (random bits, prior
draws, activity, the stacked delta write, the stacked kernel wrapper),
the guard (poisoned-slot quarantine and eviction, admission control,
deadlines, the watchdog), the background loop, and the options that are
not ported yet (``root=``, ``recorder=`` and ``algo="atpe"`` are held in
``tests/test_torch_serve_chaos.py`` and ``tests/test_torch_client.py``).  ``tests/test_torch_serve_batched.py`` holds the engine
against the JAX reference.
"""

import threading

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import anneal as A
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch import tpe as T
from hyperopt_tpu_torch.distributed.faults import DeviceFaultPlan, FaultPlan, SimulatedCrash
from hyperopt_tpu_torch.exceptions import (
    DeadlineExpired,
    Overloaded,
    StudyPoisoned,
    StudyQuarantined,
)
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.ops import kernels as K
from hyperopt_tpu_torch.ops.compile import compile_space
from hyperopt_tpu_torch.parallel.mesh import STUDY_AXIS, RankMesh, virtual_mesh
from hyperopt_tpu_torch.serve import SuggestService
from hyperopt_tpu_torch.serve.batched import MIN_SLOTS, slot_capacity
from hyperopt_tpu_torch.serve.scheduler import QUARANTINE_TRIPS, dense_to_vals
from hyperopt_tpu_torch.torch_trials import MIN_CAPACITY, ObsBuffer


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


SPACE = {
    "x": hp.uniform("x", -5, 5),
    "lr": hp.loguniform("lr", -5, 0),
    "q": hp.quniform("q", 0, 10, 1),
    "c": hp.choice("c", [0, 1, 2]),
}
ALGO_KW = dict(n_cand=16, n_cand_cat=8)
N_STARTUP = 3
NEAR_TIE = 1e-3


def loss_fn(vals):
    return ((vals["x"] - 1) ** 2 / 10 + abs(float(np.log(vals["lr"])) + 2) / 3
            + abs(vals["q"] - 4) / 5 + 0.1 * vals["c"])


def service(**kw):
    kw = {"max_batch": 4, "background": False, "n_startup_jobs": N_STARTUP,
          "device": "cpu", **ALGO_KW, **kw}
    return SuggestService(SPACE, **kw)


_SOLO = {}


def solo_fns(ps):
    """The port's solo plain and fused TPE steps at the serve parameters."""
    if id(ps) not in _SOLO:
        _SOLO[id(ps)] = tuple(
            T.build_suggest_fn(ps, ALGO_KW["n_cand"], 0.25, 25.0, 1.0,
                               n_cand_cat=ALGO_KW["n_cand_cat"], state_io=sio)
            for sio in (False, True))
    return _SOLO[id(ps)]


def solo_stream(ps, seed, n_asks, prefill=(), extra=None, extra_at=None):
    """One study alone through the port's fused sequential path: the
    seeds of its own rstate stream, a resident mirror, one tell per ask;
    ``extra`` tells land before ask ``extra_at``."""
    plain, fused = solo_fns(ps)
    a_cap = T._resolve_above_cap(None)
    buf = ObsBuffer(ps, resident=True)
    for vals, loss in prefill:
        buf.add(dict(vals), float(loss))
    rstate = np.random.default_rng(seed)
    stream = []
    for i in range(n_asks):
        if i == extra_at:
            for vals, loss in extra:
                buf.add(dict(vals), loss)
        s = int(rstate.integers(2**31 - 1))
        key = R.key(s % (2**31 - 1), device=ps.device)
        if buf.count < N_STARTUP:
            out = ps.sample_prior(key, 1)
        else:
            out = T._state_dispatch(buf, key, 1, a_cap, plain, fused)
        v, a = (t.numpy() for t in out)
        vals = dense_to_vals(ps, v[:, 0], a[:, 0])
        stream.append(vals)
        buf.add(dict(vals), loss_fn(vals))
    return stream


def drive_rounds(svc, handles, streams, n_rounds):
    """n_rounds of (ask every open handle, pump once, tell its loss)."""
    for _ in range(n_rounds):
        futs = [(h, h.ask_async()) for h in handles]
        svc.pump()
        for h, f in futs:
            tid, vals = f.result(timeout=10)
            streams.setdefault(h.name, []).append(vals)
            h.tell(tid, loss_fn(vals))


def prefill_history(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        vals = {"x": float(rng.uniform(-5, 5)), "lr": float(np.exp(rng.uniform(-5, 0))),
                "q": float(rng.integers(0, 11)), "c": int(rng.integers(0, 3))}
        out.append((vals, loss_fn(vals)))
    return out


# ---------------------------------------------------------------------------
# the study axis of the building blocks
# ---------------------------------------------------------------------------


def test_random_bits_broadcast_over_a_stack_of_keys():
    """split/uniform/normal/categorical on keys [N, 2]: slice i is
    bitwise the draw of key i alone."""
    keys = torch.stack([R.key(s) for s in (0, 7, 2**31 - 2, 123456)])
    logits = torch.log(torch.tensor([[0.2, 0.3, 0.5], [0.6, 0.4, 1e-30]]))[:, None, :]
    draws = {
        "split": lambda k: R.split(k, 5),
        "uniform": lambda k: R.uniform(k, (3, 17)),
        "uniform_minval": lambda k: R.uniform(k, (9,), 1e-12, 1.0),
        "normal": lambda k: R.normal(k, (4, 5)),
        "categorical": lambda k: R.categorical(k, logits, (2, 6)),
    }
    for name, fn in draws.items():
        stacked = fn(keys)
        for i in range(keys.shape[0]):
            assert torch.equal(stacked[i], fn(keys[i])), (name, i)


def test_prior_and_activity_over_a_study_axis():
    """sample_prior_fn on [N, 2] keys and active_fn on [N, D, n] values
    (a conditional space): study i's slice is bitwise its solo call."""
    space = {"c": hp.choice("c", [{"a": hp.uniform("a", 0, 1)},
                                  {"b": hp.normal("b", 0, 2), "k": hp.randint("k", 4)}]),
             "lr": hp.qloguniform("lr", -3, 0, 0.01)}
    ps = compile_space(space, device="cpu")
    keys = torch.stack([R.key(s) for s in (3, 4, 5)])
    v, a = ps.sample_prior_fn(keys, 11)
    assert v.shape == (3, ps.n_dims, 11)
    for i in range(3):
        sv, sa = ps.sample_prior_fn(keys[i], 11)
        assert torch.equal(v[i], sv) and torch.equal(a[i], sa)
        assert torch.equal(ps.active_fn(v)[i], ps.active_fn(v[i]))
    assert not a.all() and a.any()  # the conditional branches are exercised


def test_apply_delta_stacked_is_apply_delta_or_identity():
    """Slot i takes apply_delta at its own index where apply[i] holds and
    keeps its bits elsewhere."""
    rng = np.random.default_rng(0)
    s, d, cap = 5, 4, 16
    host = (rng.normal(size=(s, d, cap)).astype(np.float32), rng.random((s, d, cap)) < 0.5,
            rng.normal(size=(s, cap)).astype(np.float32), rng.random((s, cap)) < 0.5)
    vcol = rng.normal(size=(s, d)).astype(np.float32)
    acol = rng.random((s, d)) < 0.5
    loss = rng.normal(size=s).astype(np.float32)
    idx = np.array([3, 0, 15, 7, 7])
    apply = np.array([True, False, True, True, False])
    got = K.apply_delta_stacked(*(torch.tensor(a) for a in host), vcol, acol, loss, idx, apply)
    for i in range(s):
        want = [torch.tensor(a[i]) for a in host]
        if apply[i]:
            want = K.apply_delta(*want, vcol[i], acol[i], float(loss[i]), int(idx[i]))
        for g, w in zip(got, want):
            assert torch.equal(g[i], w), i


def test_gmm_llr_stacked_is_per_study_gmm_llr():
    """The folded study axis on the CPU (the plain version on [B, N*Dg,
    S]) gives each study bitwise its own gmm_llr, at B = 1 and B = 3."""
    rng = np.random.default_rng(1)
    n, dg, s, kb, ka = 4, 3, 16, 5, 9
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    low, high = t(np.full(dg, -2.0)), t(np.full(dg, 3.0))
    logspace = torch.tensor([False, True, False])

    def mixtures(k):
        w = rng.uniform(0.1, 1.0, (n, dg, k))
        pre = K.gmm_precompute(t(w / w.sum(-1, keepdims=True)),
                               t(rng.uniform(-2, 3, (n, dg, k))),
                               t(rng.uniform(0.1, 2, (n, dg, k))), low, high)
        return {k_: pre[k_] for k_ in ("c1", "inv_s", "mu_inv_s", "c1max")}

    pb, pa = mixtures(kb), mixtures(ka)
    for b in (1, 3):
        x = t(rng.uniform(0.1, 3.0, (n, b, dg, s)))
        got = G.gmm_llr_stacked(x, logspace, pb, pa)
        assert got.shape == (n, b, dg, s)
        for i in range(n):
            one = G.gmm_llr(x[i], logspace, {k: v[i] for k, v in pb.items()},
                            {k: v[i] for k, v in pa.items()})
            assert torch.equal(got[i], one), (b, i)


def test_slot_capacity_schedule():
    assert MIN_SLOTS == 4
    assert slot_capacity(1, 64) == 4
    assert slot_capacity(4, 64) == 4
    assert slot_capacity(5, 64) == 8
    assert slot_capacity(33, 64) == 64
    assert slot_capacity(100, 64) == 64
    assert slot_capacity(3, 2) == 2


# ---------------------------------------------------------------------------
# streams: bitwise the port's solo fused path
# ---------------------------------------------------------------------------


def test_16_study_parity_with_the_solo_path():
    """16 studies, 6 rounds, one slotted batch: every stream bitwise its
    solo fused stream; one step per round, one upload, full occupancy."""
    svc = service(max_batch=16)
    handles = [svc.create_study(f"s{i:02d}", seed=100 + i) for i in range(16)]
    streams = {}
    drive_rounds(svc, handles, streams, 6)
    for i, h in enumerate(handles):
        assert streams[h.name] == solo_stream(svc.ps, 100 + i, 6), h.name
    c = svc.counters
    assert (c["dispatch_count"], c["delta_drain_dispatches"], c["upload_events"]) == (6, 0, 1)
    assert list(svc.scheduler.occupancy) == [1.0] * 6
    # the last three rounds drew TPE suggestions for every study
    assert all(h._study.buf.count == 6 for h in handles)


@pytest.mark.parametrize("max_batch", [8, 16])
def test_churn_parity_two_capacities(max_batch):
    """Studies join mid-run, leave mid-run and their slots are reused:
    every stream stays bitwise its solo fused stream."""
    svc = service(max_batch=max_batch)
    streams, seeds = {}, {}

    def open_wave(tag, n, base_seed):
        hs = []
        for i in range(n):
            seeds[f"{tag}{i:02d}"] = base_seed + i
            hs.append(svc.create_study(f"{tag}{i:02d}", seed=base_seed + i))
        return hs

    wave_a = open_wave("a", max_batch // 2, 500)
    drive_rounds(svc, wave_a, streams, 2)
    wave_b = open_wave("b", max_batch // 2, 700)  # join mid-run
    drive_rounds(svc, wave_a + wave_b, streams, 2)
    for h in wave_a[: max_batch // 4]:  # leave mid-run
        h.close()
    survivors = wave_a[max_batch // 4:] + wave_b
    drive_rounds(svc, survivors, streams, 2)
    wave_c = open_wave("c", max_batch // 4, 900)  # reuse the freed slots
    drive_rounds(svc, survivors + wave_c, streams, 2)
    for name, stream in streams.items():
        assert stream == solo_stream(svc.ps, seeds[name], len(stream)), (name, max_batch)
    assert svc.counters["joins"] == max_batch + max_batch // 4
    assert sorted(h._study.slot for h in wave_c) == list(range(max_batch // 4))


def test_churn_before_first_dispatch_keeps_high_slots():
    """A study closed before the first round leaves a survivor on slot 4
    of five: the batch is sized from the highest occupied slot."""
    svc = service(max_batch=8)
    handles = [svc.create_study(f"r{i}", seed=200 + i) for i in range(5)]
    handles[0].close()
    streams = {}
    drive_rounds(svc, handles[1:], streams, 4)
    for i, h in enumerate(handles[1:], start=1):
        assert streams[h.name] == solo_stream(svc.ps, 200 + i, 4), h.name


def test_bucket_boundary_rebucket_keeps_the_sibling():
    """A study crossing its pow2 bucket (126 -> 132 obs: 128 -> 256)
    re-buckets the whole stacked state; the small sibling now runs at
    width 256 where its solo run stays at 128.  Its stream must stay its
    solo stream: bitwise, or diverging first at a near-tie.  On the CPU
    it stays bitwise: the sums over the padded axis (parzen_fit's
    normalisation, forgetting_weights' cumsum) add the same nonzero terms
    in the same order at either width."""
    svc = service()
    big = svc.create_study("big", seed=11)
    small = svc.create_study("small", seed=22)
    prefill = prefill_history(MIN_CAPACITY - 2, 5)
    for tid, (vals, loss) in enumerate(prefill):
        big.tell(tid, loss, vals=vals)
    streams = {}
    drive_rounds(svc, [big, small], streams, 6)
    assert big._study.buf.count > MIN_CAPACITY
    assert svc.counters["rebuckets"] >= 1
    assert svc.scheduler._bucket == 2 * MIN_CAPACITY
    assert streams["small"] == solo_stream(svc.ps, 22, 6)
    assert streams["big"] == solo_stream(svc.ps, 11, 6, prefill=prefill)


def test_multi_tell_backlog_drains_and_stays_bitwise():
    """Three extra tells between two asks: the backlog drains through the
    stacked delta write (counted), the last delta fuses into the step,
    and the stream is the solo path's on the same interleaving."""
    svc = service()
    h = svc.create_study("m", seed=77)
    streams = {}
    drive_rounds(svc, [h], streams, 4)
    extra = [({"x": 0.5, "lr": 0.1, "q": 2.0, "c": 1}, 0.9),
             ({"x": -1.5, "lr": 0.05, "q": 7.0, "c": 0}, 1.7),
             ({"x": 2.5, "lr": 0.3, "q": 1.0, "c": 2}, 0.4)]
    base = h._study.next_tid
    for k, (vals, loss) in enumerate(extra):
        h.tell(base + k, loss, vals=vals)
    drive_rounds(svc, [h], streams, 2)
    assert svc.counters["delta_drain_dispatches"] == 3
    assert streams["m"] == solo_stream(svc.ps, 77, 6, extra=extra, extra_at=4)


def test_anneal_serve_parity_with_the_solo_path():
    """algo="anneal": the prior below one observation, annealing after;
    every stream bitwise the port's solo anneal steps."""
    svc = service(algo="anneal", n_startup_jobs=20)
    handles = [svc.create_study(f"an{i}", seed=40 + i) for i in range(3)]
    streams = {}
    drive_rounds(svc, handles, streams, 5)
    plain = A.build_anneal_fn(svc.ps, 2.0, 0.1)
    fused = A.build_anneal_fn(svc.ps, 2.0, 0.1, state_io=True)
    for i, h in enumerate(handles):
        buf = ObsBuffer(svc.ps, resident=True)
        rstate = np.random.default_rng(40 + i)
        for vals in streams[h.name]:
            key = R.key(int(rstate.integers(2**31 - 1)) % (2**31 - 1))
            out = (svc.ps.sample_prior(key, 1) if buf.count == 0
                   else T._state_dispatch(buf, key, 1, None, plain, fused))
            got = dense_to_vals(svc.ps, out[0][:, 0].numpy(), out[1][:, 0].numpy())
            assert got == vals, h.name
            buf.add(dict(got), loss_fn(got))


def test_background_loop_serves_concurrent_clients_bitwise():
    """The background loop under more client threads than cores, with a
    short thread switch interval: rounds coalesce, every study's tells
    land, and every stream is still its solo stream."""
    import sys

    n = 12
    svc = service(background=True, max_batch=16, max_wait_ms=20.0)
    streams = {}

    def client(i):
        h = svc.create_study(f"bg{i}", seed=300 + i)
        out = streams.setdefault(h.name, [])
        for _ in range(4):
            tid, vals = h.ask(timeout=60)
            out.append(vals)
            h.tell(tid, loss_fn(vals))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    svc.shutdown()
    for i in range(n):
        assert streams[f"bg{i}"] == solo_stream(svc.ps, 300 + i, 4)
    assert svc.counters["admitted_count"] == 4 * n
    assert svc.counters["dispatch_count"] < 4 * n  # rounds served several studies


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


def test_nan_loss_quarantines_only_its_slot():
    """A study told a NaN loss trips the finite check every round: its
    client gets StudyPoisoned, then StudyQuarantined at the K-th trip
    (evicted, slot freed); its siblings' streams stay bitwise solo."""
    svc = service()
    good = [svc.create_study(f"g{i}", seed=60 + i) for i in range(3)]
    bad = svc.create_study("bad", seed=99)
    streams = {}
    drive_rounds(svc, good + [bad], streams, 3)
    fut = bad.ask_async()
    svc.pump()
    tid, vals = fut.result(timeout=0)
    bad.tell(tid, float("nan"))
    errors = []
    for _ in range(QUARANTINE_TRIPS):
        futs = [(h, h.ask_async()) for h in good + [bad]]
        svc.pump()
        for h, f in futs:
            if h is bad:
                errors.append(type(f.exception(timeout=0)))
            else:
                t2, v2 = f.result(timeout=0)
                streams[h.name].append(v2)
                h.tell(t2, loss_fn(v2))
    assert errors == [StudyPoisoned] * (QUARANTINE_TRIPS - 1) + [StudyQuarantined]
    c = svc.counters
    assert (c["quarantine_count"], c["evictions"]) == (QUARANTINE_TRIPS, 1)
    assert bad._study.quarantined and bad._study.slot is None
    with pytest.raises(StudyQuarantined):
        bad.ask_async()
    drive_rounds(svc, good, streams, 1)
    for i, h in enumerate(good):
        assert streams[h.name] == solo_stream(svc.ps, 60 + i, 3 + QUARANTINE_TRIPS + 1)


def test_device_nan_outputs_trip_only_their_slot():
    """A DeviceFaultPlan scribbling NaN into one study's output column
    once: that client gets StudyPoisoned, the slot re-materializes, and
    every stream (the victim's next ask included) is bitwise solo."""
    plan = FaultPlan(device=DeviceFaultPlan(nan_study="v", nan_at=3, nan_count=1))
    svc = service(fs=plan.fs())
    hs = [svc.create_study(n, seed=s) for n, s in (("v", 1), ("w", 2))]
    streams, failed = {}, 0
    for _ in range(6):
        futs = [(h, h.ask_async()) for h in hs]
        svc.pump()
        for h, f in futs:
            if f.exception(timeout=0) is not None:
                assert isinstance(f.exception(), StudyPoisoned) and h.name == "v"
                failed += 1
                streams.setdefault(h.name, []).append(None)
                continue
            tid, vals = f.result()
            streams.setdefault(h.name, []).append(vals)
            h.tell(tid, loss_fn(vals))
    assert failed == 1 and svc.counters["quarantine_count"] == 1
    assert streams["w"] == solo_stream(svc.ps, 2, 6)
    # the victim lost ask 3's suggestion (never told): its later asks are
    # the solo stream of the same seeds without that trial
    want = solo_stream_skipping(svc.ps, 1, 6, skip=2)
    assert streams["v"] == want


def solo_stream_skipping(ps, seed, n_asks, skip):
    """The solo stream where ask ``skip`` is drawn but never told."""
    plain, fused = solo_fns(ps)
    buf = ObsBuffer(ps, resident=True)
    rstate = np.random.default_rng(seed)
    out = []
    for i in range(n_asks):
        key = R.key(int(rstate.integers(2**31 - 1)) % (2**31 - 1))
        res = (ps.sample_prior(key, 1) if buf.count < N_STARTUP
               else T._state_dispatch(buf, key, 1, T._resolve_above_cap(None), plain, fused))
        vals = dense_to_vals(ps, res[0][:, 0].numpy(), res[1][:, 0].numpy())
        if i == skip:
            out.append(None)
            continue
        out.append(vals)
        buf.add(dict(vals), loss_fn(vals))
    return out


def test_admission_control_and_deadlines():
    """Overloaded past max_queue and past the per-study cap, with a
    retry_after hint; DeadlineExpired for an ask whose deadline passed
    before its round.  Refusals consume nothing of the seed stream."""
    svc = service(max_queue=3, study_queue_cap=2)
    a, b = svc.create_study("a", seed=5), svc.create_study("b", seed=6)
    a.ask_async()
    a.ask_async()
    with pytest.raises(Overloaded) as e:
        a.ask_async()
    assert e.value.reason == "study_queue_cap" and e.value.retry_after > 0
    b.ask_async()
    with pytest.raises(Overloaded) as e:
        b.ask_async()
    assert e.value.reason == "queue_full"
    assert svc.counters["shed_count"] == 2 and svc.counters["admitted_count"] == 3
    svc.pump()
    svc.pump()
    # an ask queued with a deadline already in the past is shed
    stale = svc.scheduler.submit_ask(b._study, deadline=10**9)
    stale.deadline = 0.0
    svc.pump()
    with pytest.raises(DeadlineExpired):
        stale.future.result(timeout=0)
    assert a._study.n_asks == 2 and b._study.n_asks == 2


def test_watchdog_retries_a_hung_dispatch_on_new_tensors():
    """A dispatch that hangs past dispatch_timeout is abandoned and the
    round retried once against newly allocated state (the abandoned
    worker keeps writing the old tensors); the streams stay solo."""
    plan = FaultPlan(device=DeviceFaultPlan(hang_at=3, hang_s=0.5))
    svc = service(fs=plan.fs(), dispatch_timeout=0.3)
    hs = [svc.create_study(f"h{i}", seed=20 + i) for i in range(2)]
    streams = {}
    drive_rounds(svc, hs, streams, 2)
    old = svc.scheduler._state
    drive_rounds(svc, hs, streams, 3)
    new = svc.scheduler._state
    assert all(o.data_ptr() != n.data_ptr() for o, n in zip(old, new))
    c = svc.counters
    assert (c["watchdog_timeouts"], c["watchdog_retries"], c["watchdog_recoveries"]) == (1, 1, 1)
    for i, h in enumerate(hs):
        assert streams[h.name] == solo_stream(svc.ps, 20 + i, 5)
    svc.shutdown()  # waits for the abandoned dispatch
    assert not svc.scheduler._abandoned


def test_deterministic_failures_open_the_circuit():
    """A deterministic failure is not retried: it fails the round's asks;
    three in a row open the circuit breaker."""
    plan = FaultPlan(device=DeviceFaultPlan(fatal_at=1))
    svc = service(fs=plan.fs(), circuit_threshold=1)
    h = svc.create_study("f", seed=1)
    fut = h.ask_async()
    svc.pump()
    with pytest.raises(RuntimeError, match="deterministic program bug"):
        fut.result(timeout=0)
    assert svc.counters["watchdog_retries"] == 0 and not svc.ready()
    with pytest.raises(Overloaded) as e:
        h.ask_async()
    assert e.value.reason == "circuit_open"
    svc.scheduler.reset_circuit()
    tid, vals = h.ask(timeout=10)
    assert set(vals) >= {"x", "lr", "q", "c"}


def test_crash_mid_batch_fails_picked_futures():
    plan = FaultPlan().arm("serve_mid_batch", at=1)
    svc = service(fs=plan.fs())
    fut = svc.create_study("f", seed=1).ask_async()
    with pytest.raises(SimulatedCrash):
        svc.pump()
    with pytest.raises(SimulatedCrash):
        fut.result(timeout=0)


def test_front_health_metrics_and_shutdown():
    svc = service()
    h = svc.create_study("m", seed=3)
    tid, vals = h.ask()
    h.tell(tid, loss_fn(vals))
    assert h.best()["vals"] == vals and h.n_tells == 1
    health = svc.health()
    assert health["status"] == "ok" and health["studies"] == 1
    text = svc.metrics_text()
    assert "serve_dispatch_total 1" in text and "serve_ask_latency_seconds_count 1" in text
    fut = h.ask_async()
    svc.shutdown()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=0)
    assert svc.health()["status"] == "stopped"


@pytest.mark.parametrize("kw, item", [
    ({"owner": "r0"}, "12d"), ({"mesh": virtual_mesh(2, STUDY_AXIS)}, "15"),
    ({"device_metrics_every": 1}, "16"),
])
def test_unported_options_raise(kw, item):
    """What waits for a later slice raises naming its item; item 16's
    ``device_metrics_every`` is ported, and its service runs the twin
    (``tests/test_torch_obs_device.py`` holds it to the reference), and
    so is item 12d's ``owner=``: its series and spans carry the replica's
    id (``tests/test_torch_fleet.py`` holds the claims to the
    reference's).  Item 15's ``mesh=`` inside one process is ported
    (``tests/test_torch_graftmesh.py``); a study mesh over several
    processes still names its item."""
    if item == "15":
        svc = service(**kw)
        h = svc.create_study("s0", seed=1)
        tid, vals = h.ask()
        h.tell(tid, loss_fn(vals))
        assert svc.counters["mesh_shards"] == 2
        svc.shutdown()
        kw = {"mesh": RankMesh((2,), (STUDY_AXIS,), (0, 1))}
    if item == "12d":
        svc = service(**kw)
        h = svc.create_study("s0", seed=1)
        tid, vals = h.ask()
        h.tell(tid, loss_fn(vals))
        assert svc.health()["owner"] == "r0"
        rows = svc.metrics_rows()
        assert rows and all(r["labels"].get("replica") == "r0" for r in rows)
        svc.shutdown()
        return
    if item == "16":
        svc = service(**kw)
        h = svc.create_study("s0", seed=1)
        tid, vals = h.ask()
        assert svc.scheduler.device_metric_dispatches == 1
        svc.shutdown()
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        service(**kw)


def test_no_cuda_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuggestService(SPACE, background=False)
