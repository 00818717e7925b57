"""The port's study-batched serve engine against the JAX reference's.

Teacher-forced steps: one stacked state (four numpy arrays, carried to
the port with ``convert.study_batch_from_numpy``), the same per-slot
keys and the same staged deltas go through the reference's
``serve.batched.build_batched_step_fn`` and the port's, one case per
regime mix (all cold, all warm, mixed, a pending delta on some slots).
The state the step leaves is bitwise equal; prior (cold) columns are the
reference's bits but for log-space dims, which go through PyTorch's
``exp`` (within 1e-6, as ``test_torch_compile.py`` holds prior draws);
warm columns agree except at picks where the reference's own llr margin
is below NEAR_TIE, the rule ``test_torch_tpe.py`` holds solo asks to.
The finite check and the backlog drain are held the same way.

Services: the reference's ``SuggestService`` and the port's (on the
CPU), same seeds and same tells, with churn, a bucket crossing and then
a multi-tell backlog: their counters are equal, and before the backlog
every study's stream is equal (startup draws as above) up to a first
divergence that is a near-tie of the reference's own ask.  ``algo="anneal"`` streams are held
as ``test_torch_anneal.py`` holds solo streams.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu.serve import batched as JB
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile
from hyperopt_tpu_torch.serve import SuggestService as TService
from hyperopt_tpu_torch.serve import batched as TB

from test_torch_serve import ALGO_KW, N_STARTUP, NEAR_TIE, SPACE, loss_fn, prefill_history

J_SPACE = {
    "x": jhp.uniform("x", -5, 5),
    "lr": jhp.loguniform("lr", -5, 0),
    "q": jhp.quniform("q", 0, 10, 1),
    "c": jhp.choice("c", [0, 1, 2]),
}
# as test_torch_tpe.py: a few float32 roundings of the candidate draw
CONT_RTOL, CONT_ATOL = 5e-5, 1e-6
PRIOR_LOG_RTOL = 1e-6  # PyTorch's exp against XLA's on log-space dims
ANNEAL_RTOL, ANNEAL_ATOL = 2e-6, 1e-7  # as test_torch_anneal.py
SLOTS, CAP = 4, 128


@pytest.fixture(scope="module")
def spaces():
    jps = j_compile(J_SPACE)
    tps = t_compile(SPACE, device="cpu")
    assert jps.labels == tps.labels
    return jps, tps


_CANDS = {}


def ref_candidates(jps):
    """Jitted reference: every candidate of one ask (batch 1) and its llr,
    continuous [1, Dc, S] and categorical [1, Dk, S]."""
    if id(jps) not in _CANDS:
        c = jps._consts
        dc, dk = len(jps.cont_idx), len(jps.cat_idx)

        def fn(key, values, active, losses, valid):
            fits = JK.fit_all_dims(c, values, active, losses, valid, 0.25, 25.0, 1.0,
                                   above_cap=JK.DEFAULT_ABOVE_CAP)
            keys = jax.random.split(key, dc + dk)
            cv, cl = JK.ei_sweep_cont_scores(jps.q, c, keys[:dc].reshape(1, dc),
                                             fits["cont"], ALGO_KW["n_cand"])
            kv, kl = JK.ei_sweep_cat_scores(keys[dc:].reshape(1, dk), *fits["cat"],
                                            ALGO_KW["n_cand_cat"])
            return cv, cl, kv, kl

        _CANDS[id(jps)] = jax.jit(fn)
    return _CANDS[id(jps)]


def ref_margins(jps, arrays, key):
    """The reference's margin [D] of every pick of one ask: its winning
    llr minus the best llr of a candidate with another value."""
    cv, cl, kv, kl = (np.asarray(a)[0] for a in ref_candidates(jps)(key, *arrays))

    def margins(vals, llr):
        best = llr.argmax(-1)
        win_v = np.take_along_axis(vals, best[:, None], -1)
        other = np.where(vals != win_v, llr, -np.inf).max(-1)
        return np.take_along_axis(llr, best[:, None], -1)[:, 0] - other

    out = np.empty(jps.n_dims)
    out[jps.cont_idx] = margins(cv, cl)
    out[jps.cat_idx] = margins(kv, kl)
    return out


def _kinds(ps):
    cat = np.zeros(ps.n_dims, bool)
    cat[ps.cat_idx] = True
    log = np.zeros(ps.n_dims, bool)
    log[ps.cont_idx[ps.logspace]] = True
    return cat, log


def assert_prior_columns(ps, jv, tv):
    """Prior draws: the reference's bits, log-space dims within 1e-6."""
    _, log = _kinds(ps)
    assert np.array_equal(jv[~log], tv[~log])
    np.testing.assert_allclose(tv[log], jv[log], rtol=PRIOR_LOG_RTOL)


def picks_differ(ps, jv, tv):
    """[D] mask of warm picks that differ (categorical unequal, continuous
    outside CONT_RTOL/CONT_ATOL)."""
    cat, _ = _kinds(ps)
    return ~np.where(cat, jv == tv, np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL))


# ---------------------------------------------------------------------------
# teacher-forced steps on one stacked state
# ---------------------------------------------------------------------------

CASES = {
    # name: (observations per slot, warm slots, slots with a pending delta)
    "all_cold": ((0, 1, 2, 0), (False,) * 4, ()),
    "all_warm": ((10, 20, 40, 60), (True,) * 4, ()),
    "mixed": ((0, 30, 2, 50), (False, True, False, True), ()),
    "pending_delta": ((10, 20, 40, 60), (True,) * 4, (0, 2)),
}


def stacked_history(jps, counts, seed):
    """Host arrays [S, D, CAP] / [S, CAP] of the reference's ObsBuffers,
    slot i holding counts[i] prefill observations, plus one more trial
    per slot to stage as a delta."""
    arrays = [np.zeros((SLOTS, jps.n_dims, CAP), np.float32),
              np.zeros((SLOTS, jps.n_dims, CAP), bool),
              np.zeros((SLOTS, CAP), np.float32), np.zeros((SLOTS, CAP), bool)]
    extra = []
    for i, n in enumerate(counts):
        buf = JObsBuffer(jps)
        hist = prefill_history(n + 1, seed + i)
        for vals, loss in hist[:n]:
            buf.add(dict(vals), loss)
        for a, b in zip(arrays, buf.arrays()):
            a[i] = b[..., :CAP]
        buf.add(dict(hist[n][0]), hist[n][1])
        extra.append((buf.values[:, n].copy(), buf.active[:, n].copy(), np.float32(hist[n][1])))
    return arrays, extra


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_step(case, spaces):
    jps, tps = spaces
    counts, warm, delta_slots = CASES[case]
    arrays, extra = stacked_history(jps, counts, seed=sorted(CASES).index(case) * 10)
    vcol, acol, loss, idx, apply = TB._dummy_delta(tps, SLOTS)
    for i in delta_slots:
        vcol[i], acol[i], loss[i] = extra[i]
        idx[i], apply[i] = counts[i], True
    warm = np.array(warm)
    seeds = [1000 + 37 * i for i in range(SLOTS)]
    keys = jnp.stack([host_key(s) for s in seeds])

    jfn = JB.build_batched_step_fn(jps, algo="tpe", **ALGO_KW)
    jout = [np.asarray(a) for a in jfn(
        keys, *(jnp.asarray(a) for a in arrays), vcol, acol, loss, idx.astype(np.int32),
        apply, warm, batch=1)]
    tfn = TB.build_batched_step_fn(tps, algo="tpe", **ALGO_KW)
    tstate = convert.study_batch_from_numpy(*arrays, device="cpu")
    tkeys = convert.key_from_numpy(jax.random.key_data(keys), device="cpu")
    tout = [t.numpy() for t in tfn(tkeys, *tstate, vcol, acol, loss, idx, apply, warm,
                                   batch=1)]

    for j, t in zip(jout[:4], tout[:4]):  # the state after the delta write
        assert np.array_equal(j, t)
    assert np.array_equal(jout[5], tout[5])  # active (an unconditional space)
    n_differ = 0
    for i in range(SLOTS):
        jv, tv = jout[4][i, :, 0], tout[4][i, :, 0]
        if not warm[i]:
            assert_prior_columns(tps, jv, tv)
            continue
        differ = picks_differ(tps, jv, tv)
        if differ.any():
            slot_state = tuple(a[i, ..., : CAP] for a in jout[:4])
            margins = ref_margins(jps, slot_state, keys[i])
            assert np.all(margins[differ] < NEAR_TIE), (case, i, margins, differ)
            n_differ += int(differ.sum())
    assert n_differ <= 1  # near-ties are rare: the check is not vacuous


def test_finite_check_and_backlog_drain_match(spaces):
    jps, tps = spaces
    arrays, extra = stacked_history(jps, (5, 6, 7, 8), seed=50)
    arrays[0][1, 0, 2] = np.nan   # slot 1: an active history value
    arrays[1][1, 0, 2] = True
    arrays[2][2, 3] = np.inf      # slot 2: a valid loss
    arrays[0][3, 1, 100] = np.nan  # slot 3: garbage behind the masks
    arrays[1][3, 1, 100] = False
    new_v = np.zeros((SLOTS, jps.n_dims, 1), np.float32)
    new_v[0, 2, 0] = np.nan       # slot 0: this round's suggestion
    want = np.array([True, True, True, False])
    jverdict = np.asarray(JB.build_finite_check_fn()(*(jnp.asarray(a) for a in arrays), new_v))
    tstate = convert.study_batch_from_numpy(*arrays, device="cpu")
    tverdict = TB.build_finite_check_fn()(*tstate, torch.from_numpy(new_v)).numpy()
    assert np.array_equal(jverdict, want) and np.array_equal(tverdict, want)

    vcol, acol, loss, idx, apply = TB._dummy_delta(tps, SLOTS)
    for i in (1, 3):
        vcol[i], acol[i], loss[i] = extra[i]
        idx[i], apply[i] = (5, 6, 7, 8)[i], True
    jout = JB.build_batched_delta_fn()(*(jnp.asarray(a) for a in arrays), vcol, acol, loss,
                                       idx.astype(np.int32), apply)
    tout = TB.build_batched_delta_fn()(*tstate, vcol, acol, loss, idx, apply)
    for j, t in zip(jout, tout):
        assert np.array_equal(np.asarray(j), t.numpy(), equal_nan=True)


# ---------------------------------------------------------------------------
# the two services, same seeds, same tells
# ---------------------------------------------------------------------------


#: rounds of :func:`scenario` before its backlog drain.  The streams are
#: compared over these only: in a loaded test process the reference's
#: own drained rounds sometimes part from its solo streams (its
#: ``tests/test_serve.py::test_multi_tell_backlog_drains_and_stays_bitwise``
#: fails the same way; ROADMAP.md Queue C), so past the drain the
#: reference is no judge.  The counters cover every round.
ROUNDS_BEFORE_DRAIN = 5


def scenario(svc):
    """Churn, a multi-tell backlog and a bucket crossing at max_batch 4:
    returns each study's seed, (history count, suggestion) per ask before
    the drain, the counters and the occupancy."""
    seeds, log = {}, {}
    n_rounds = [0]

    def open_(name, seed):
        seeds[name] = seed
        return svc.create_study(name, seed=seed)

    def rounds(handles, n):
        for _ in range(n):
            before = {h.name: h._study.buf.count for h in handles}
            futs = [(h, h.ask_async()) for h in handles]
            svc.pump()
            n_rounds[0] += 1
            for h, f in futs:
                tid, vals = f.result(timeout=30)
                if n_rounds[0] <= ROUNDS_BEFORE_DRAIN:
                    log.setdefault(h.name, []).append((before[h.name], vals))
                h.tell(tid, loss_fn(vals))

    hs = [open_(f"a{i}", 30 + i) for i in range(3)]
    big = open_("big", 9)
    for tid, (vals, loss) in enumerate(prefill_history(126, 8)):
        big.tell(tid, loss, vals=vals)
    rounds(hs + [big], 3)  # big crosses 128 observations
    hs[0].close()
    hs = hs[1:] + [open_("a3", 40)]  # joins on the freed slot
    rounds(hs + [big], 2)
    assert n_rounds[0] == ROUNDS_BEFORE_DRAIN
    base = hs[0]._study.next_tid
    for k, (vals, loss) in enumerate(prefill_history(3, 77)):
        hs[0].tell(base + k, loss, vals=vals)  # a backlog of three
    rounds(hs + [big], 1)  # the drain round, last
    return seeds, log, svc.counters, list(svc.scheduler.occupancy)


def test_service_streams_and_counters_match_the_reference(spaces):
    jps, tps = spaces
    jseeds, jlog, jc, jocc = scenario(JService(J_SPACE, max_batch=4, background=False,
                                               n_startup_jobs=N_STARTUP, **ALGO_KW))
    tsvc = TService(SPACE, max_batch=4, background=False, n_startup_jobs=N_STARTUP,
                    device="cpu", **ALGO_KW)
    tseeds, tlog, tc, tocc = scenario(tsvc)
    keys = ("dispatch_count", "upload_events", "upload_bytes", "delta_drain_dispatches",
            "joins", "rebuckets")
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}
    assert tocc == jocc
    assert (tc["rebuckets"], tc["delta_drain_dispatches"]) == (1, 3)

    a_cap = JK.DEFAULT_ABOVE_CAP
    for name, jstream in jlog.items():
        tstream = tlog[name]
        rng = np.random.default_rng(jseeds[name])
        for k, ((n, jvals), (_, tvals)) in enumerate(zip(jstream, tstream)):
            seed = int(rng.integers(2**31 - 1))
            if n < N_STARTUP:  # a prior draw
                assert {l: v for l, v in jvals.items() if l != "lr"} == \
                       {l: v for l, v in tvals.items() if l != "lr"}, (name, k)
                assert math.isclose(jvals["lr"], tvals["lr"], rel_tol=PRIOR_LOG_RTOL)
                continue
            jv = np.array([jvals[l] for l in jps.labels], np.float32)
            tv = np.array([tvals[l] for l in jps.labels], np.float32)
            differ = picks_differ(tps, jv, tv)
            if not differ.any():
                continue
            # the first divergence: the reference's own ask must be a near-tie
            hist = _history_at(name, jlog, n)
            buf = JObsBuffer(jps)
            for vals, loss in hist:
                buf.add(dict(vals), loss)
            arrays = tuple(a[..., : buf._device_bucket(a_cap)] for a in buf.arrays())
            margins = ref_margins(jps, arrays, host_key(seed % (2**31 - 1)))
            assert np.all(margins[differ] < NEAR_TIE), (name, k, margins, differ)
            break


def _history_at(name, log, n):
    """The first n observations a study of :func:`scenario` was told."""
    told = prefill_history(126, 8) if name == "big" else []
    told += [(vals, loss_fn(vals)) for _, vals in log[name]]
    return told[:n]


def test_anneal_service_streams_match_the_reference(spaces):
    jps, _ = spaces
    streams = []
    for svc in (JService(J_SPACE, algo="anneal", max_batch=4, background=False),
                TService(SPACE, algo="anneal", max_batch=4, background=False, device="cpu")):
        hs = [svc.create_study(f"an{i}", seed=40 + i) for i in range(3)]
        out = {}
        for _ in range(5):
            futs = [(h, h.ask_async()) for h in hs]
            svc.pump()
            for h, f in futs:
                tid, vals = f.result(timeout=30)
                out.setdefault(h.name, []).append(vals)
                h.tell(tid, loss_fn(vals))
        streams.append(out)
    cat, _ = _kinds(jps)
    for name, jstream in streams[0].items():
        for jvals, tvals in zip(jstream, streams[1][name]):
            assert set(jvals) == set(tvals)
            for d, label in enumerate(jps.labels):
                if cat[d]:
                    assert jvals[label] == tvals[label], (name, label)
                else:
                    assert math.isclose(tvals[label], jvals[label], rel_tol=ANNEAL_RTOL,
                                        abs_tol=ANNEAL_ATOL), (name, label)
