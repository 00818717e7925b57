"""The port's TPE suggest path and sequential fmin against the reference.

Per ask (teacher-forced): the same 200-obs history of ``mixed_space()``,
carried across with ``convert``, and the same key go through the
reference's ``tpe_jax.build_suggest_fn`` and the port's at B=8.
``active`` and every categorical pick must be equal, continuous picks
within CONT_RTOL/CONT_ATOL -- except where the reference's own margin
between its winning llr and its best llr at a different value is below
NEAR_TIE: there, the last-bit differences of the two libraries (XLA's FMA
contraction and exp/log/ndtr/ndtri, see test_torch_kernels.py) may
rightly pick the other candidate.

The slice as a whole: ``fmin`` on ``mixed_space()`` for 40 trials at two
seeds, once with ``tpe_jax.suggest`` and once with the port's
``tpe.suggest`` on the CPU, equal ``rstate``s.  The 20 startup trials
are equal; the first trial at which the streams diverge is recorded and
must be one where the reference's argmax was a near-tie.

The other modes: joint EI teacher-forced the same way (a differing
configuration column must be a near-tie of the reference's joint score),
the per-candidate categorical sweep bitwise, a ``speculative=4`` stream
held like the plain one, the saturated-categorical guard, and the seeds
the fused ask-ahead driver hands the algo.
"""

import math

import numpy as np
import pytest

import jax
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import tpe_jax
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu_torch import convert, tpe as T
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from hyperopt_tpu_torch.ops import kernels as TK
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile
from hyperopt_tpu_torch.fmin import FMinIter as TFMinIter
from hyperopt_tpu_torch.torch_trials import ObsBuffer as TObsBuffer

# a few float32 roundings of the candidate draw, amplified by ndtri's
# slope near the truncation edges and by exp on log dims (measured max
# 1.6e-5 relative)
CONT_RTOL, CONT_ATOL = 5e-5, 1e-6
# an llr gap the two libraries' last-bit differences cannot close:
# test_teacher_forced_ask asserts the measured llr differences stay 10x
# below it
NEAR_TIE = 1e-3
N_CAND, N_CAT = 128, 24


def _history(jps, n_obs, cap, seed):
    """A reference-shaped history: prior draws scored by mixed_space_fn."""
    values, active = (np.asarray(a) for a in jps.sample_prior(jax.random.key(seed), cap))
    cat = set(jps.cat_idx.tolist())
    losses = np.array([
        mixed_space_fn({
            label: int(values[d, i]) if d in cat else float(values[d, i])
            for d, label in enumerate(jps.labels)
        }) for i in range(cap)
    ], np.float32)
    return values, active, losses, np.arange(cap) < n_obs


def _ref_candidates(jps, batch):
    """Jitted reference: every candidate and its llr, continuous
    [B, Dc, S] and categorical [B, Dk, S], on the reference's key tree."""
    c = jps._consts
    dc, dk = len(jps.cont_idx), len(jps.cat_idx)

    def fn(key, values, active, losses, valid):
        fits = JK.fit_all_dims(c, values, active, losses, valid, 0.25, 25.0, 1.0,
                               above_cap=JK.DEFAULT_ABOVE_CAP)
        keys = jax.random.split(key, batch * (dc + dk))
        cv, cl = JK.ei_sweep_cont_scores(
            jps.q, c, keys[: batch * dc].reshape(batch, dc), fits["cont"], N_CAND)
        kv, kl = JK.ei_sweep_cat_scores(
            keys[batch * dc:].reshape(batch, dk), *fits["cat"], N_CAT)
        return cv, cl, kv, kl, fits["cat"]

    return jax.jit(fn)


def _margins(vals, llr):
    """[B, D, S] candidates -> [B, D]: winning llr minus the best llr of a
    candidate with a different value (inf where every candidate agrees)."""
    best = llr.argmax(-1)
    win_v = np.take_along_axis(vals, best[..., None], -1)
    win_l = np.take_along_axis(llr, best[..., None], -1)[..., 0]
    other = np.where(vals != win_v, llr, -np.inf).max(-1)
    return win_l - other


def _ref_margins(jps, arrays, key, batch, cands=None):
    """The reference's near-tie margin of every (dim, trial) pick, [D, B]."""
    cands = cands or _ref_candidates(jps, batch)
    cv, cl, kv, kl = (np.asarray(a) for a in cands(key, *arrays)[:4])
    out = np.empty((jps.n_dims, batch))
    out[jps.cont_idx] = _margins(cv, cl).T
    out[jps.cat_idx] = _margins(kv, kl).T
    return out


def _check_picks(jps, jv, tv, margins):
    """Every pick whose reference margin is >= NEAR_TIE agrees; returns
    the boolean [D, B] mask of picks that differ."""
    cat = np.zeros(jps.n_dims, bool)
    cat[jps.cat_idx] = True
    cont_ok = np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL)
    same = np.where(cat[:, None], tv == jv, cont_ok)
    assert np.all(same | (margins < NEAR_TIE)), np.argwhere(~same & (margins >= NEAR_TIE))
    return ~same


BATCH = 8


@pytest.fixture(scope="module")
def spaces():
    """Both compiled spaces and the jitted reference programs, built
    once so the parametrized asks share one compile."""
    jps = j_compile(j_mixed_space())
    return {
        "jps": jps,
        "tps": t_compile(t_mixed_space(), device="cpu"),
        "jfn": tpe_jax.build_suggest_fn(jps, N_CAND, 0.25, 25, 1.0, n_cand_cat=N_CAT),
        "cands": _ref_candidates(jps, BATCH),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_ask(seed, spaces):
    batch = BATCH
    jps, tps, jfn = spaces["jps"], spaces["tps"], spaces["jfn"]
    arrays = _history(jps, 200, 256, seed)
    key = jax.random.key(1000 + seed)
    jv, ja = (np.asarray(a) for a in jfn(key, *arrays, batch=batch))
    state = convert.history_from_numpy(*arrays, device="cpu")
    tkey = convert.key_from_numpy(jax.random.key_data(key), device="cpu")
    tfn = T.build_suggest_fn(tps, N_CAND, 0.25, 25, 1.0, n_cand_cat=N_CAT)
    tv, ta = (a.numpy() for a in tfn(tkey, *state, batch))

    assert np.array_equal(ja, ta)
    margins = _ref_margins(jps, arrays, key, batch, spaces["cands"])
    differ = _check_picks(jps, jv, tv, margins)
    assert differ.sum() <= 2  # near-ties are rare; the check is not vacuous

    # the threshold is justified: candidate llrs differ 10x less than it
    cv, cl, _, _, (pb, pa) = spaces["cands"](key, *arrays)
    fits = TK.fit_all_dims(tps.consts, *state, 0.25, 25.0, 1.0, above_cap=TK.DEFAULT_ABOVE_CAP)
    keys = R.split(tkey, batch * 20)
    samples, llr = TK.ei_sweep_cont_candidates(
        tps.q, tps.consts, keys[: batch * 14].reshape(batch, 14, 2), fits["cont"], N_CAND)
    np.testing.assert_allclose(samples.numpy(), np.asarray(cv), rtol=CONT_RTOL, atol=CONT_ATOL)
    # at the reference's winner and its best differently-valued rival,
    # the llrs of the two packages agree 10x closer than NEAR_TIE, so a
    # margin above it cannot flip (far-tail candidates, whose log
    # densities are large, carry larger absolute differences and never win)
    cv, cl, err = np.asarray(cv), np.asarray(cl), np.abs(llr.numpy() - np.asarray(cl))
    win = cl.argmax(-1)[..., None]
    rival = np.where(cv != np.take_along_axis(cv, win, -1), cl, -np.inf).argmax(-1)[..., None]
    flip = np.take_along_axis(err, win, -1) + np.take_along_axis(err, rival, -1)
    assert flip.max() < NEAR_TIE / 10, flip.max()
    tpb, tpa = fits["cat"]
    cat_llr = lambda b, a: np.log(np.maximum(b, 1e-30)) - np.log(np.maximum(a, 1e-30))
    assert np.abs(cat_llr(tpb.numpy(), tpa.numpy())
                  - cat_llr(np.asarray(pb), np.asarray(pa))).max() < NEAR_TIE / 10


def _first_divergence(jps, jtrials, ttrials):
    """Index of the first trial whose picks differ (categorical unequal or
    continuous outside CONT_RTOL/CONT_ATOL), with the differing labels."""
    for i, (a, b) in enumerate(zip(jtrials.trials, ttrials.trials)):
        bad = []
        for label, va in a["misc"]["vals"].items():
            vb = b["misc"]["vals"][label]
            if len(va) != len(vb):
                bad.append(label)
            elif va and not (va[0] == vb[0] if isinstance(va[0], int) else
                             math.isclose(vb[0], va[0], rel_tol=CONT_RTOL, abs_tol=CONT_ATOL)):
                bad.append(label)
        if bad:
            return i, bad
    return None, []


@pytest.mark.parametrize("seed", [0, 3])
def test_fmin_stream_matches_reference(seed, record_property):
    n = 40
    jt = J.Trials()
    J.fmin(mixed_space_fn, j_mixed_space(), algo=tpe_jax.suggest, max_evals=n,
           trials=jt, rstate=np.random.default_rng(seed), show_progressbar=False)
    tt = H.Trials()
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.tpe.suggest, max_evals=n,
           trials=tt, rstate=np.random.default_rng(seed), device="cpu")
    assert len(tt.trials) == n

    jps = j_compile(j_mixed_space())
    first, labels = _first_divergence(jps, jt, tt)
    record_property("first_divergence", first)
    assert first is None or first >= 20, (first, labels)  # startup trials equal
    if first is None:
        return
    # the reference's own ask at `first`: its history and its seed
    buf = JObsBuffer(jps)
    hist = J.Trials()
    hist._insert_trial_docs(jt.trials[:first])
    hist.refresh()
    buf.sync(hist)
    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)] for a in buf.arrays())
    rng = np.random.default_rng(seed)
    seeds = [int(rng.integers(2**31 - 1)) for _ in range(first + 1)]
    margins = _ref_margins(jps, arrays, host_key(seeds[first] % (2**31 - 1)), 1)[:, 0]
    for label in labels:
        d = jps.labels.index(label)
        assert margins[d] < NEAR_TIE, (first, label, margins[d])


def _docs(trials, rng, n, labels, tid0=0):
    docs = []
    for tid in range(tid0, tid0 + n):
        vals = {label: [float(rng.normal())] for label in labels}
        status = "ok" if rng.random() > 0.1 else "fail"
        result = {"status": status, "loss": float(rng.normal()) if status == "ok" else None}
        misc = {"tid": tid, "cmd": None, "workdir": None,
                "idxs": {k: [tid] for k in labels}, "vals": vals}
        doc = trials.new_trial_docs([tid], [None], [result], [misc])[0]
        doc["state"] = 2  # JOB_STATE_DONE
        docs.append(doc)
    return docs


def test_obs_buffer_matches_reference():
    """Bucketing, 4x growth, tid order and the traffic counters."""
    labels = ["a", "b"]
    space = {"a": J.hp.uniform("a", -1, 1), "b": J.hp.uniform("b", -1, 1)}
    tspace = {"a": H.hp.uniform("a", -1, 1), "b": H.hp.uniform("b", -1, 1)}
    jb, tb = JObsBuffer(j_compile(space)), TObsBuffer(t_compile(tspace, device="cpu"))
    jt, tt = J.Trials(), H.Trials()
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    for n in (50, 100, 300, 200):
        jt._insert_trial_docs(_docs(jt, rng_j, n, labels, len(jt._dynamic_trials)))
        tt._insert_trial_docs(_docs(tt, rng_t, n, labels, len(tt._dynamic_trials)))
        jt.refresh()
        tt.refresh()
        assert jb.sync(jt) == tb.sync(tt)
        assert (jb.count, jb.capacity) == (tb.count, tb.capacity)
        for cap in (None, 512):
            assert jb._device_bucket(cap) == tb._device_bucket(cap)
            ja = jb.device_arrays(pow2_cap=cap)
            ta = tb.device_arrays(pow2_cap=cap)
            for a, b in zip(ja, ta):
                assert np.array_equal(np.asarray(a), b.numpy())
        assert (jb.transfer_bytes_total, jb.full_uploads) == (tb.transfer_bytes_total, tb.full_uploads)
    tb.device_arrays(pow2_cap=512)  # unchanged history: cached, nothing moves
    assert (jb.transfer_bytes_total, jb.full_uploads) == (tb.transfer_bytes_total, tb.full_uploads)


@pytest.mark.parametrize("kw", [{"show_progressbar": True}, {"trial_timeout": 1.0},
                                {"recorder": "armed"},
                                {"engine": True}, {"trials_save_file": "fmin.ckpt"}])
def test_driver_modes_run(kw, tmp_path):
    """The driver's modes that came with the durability slice run with
    the port's tpe.suggest (their parity with the reference is held in
    test_torch_resume_parity.py, test_torch_client.py and
    test_torch_flightrec.py)."""
    from hyperopt_tpu_torch.obs import FlightRecorder

    if "recorder" in kw:
        kw = {"recorder": FlightRecorder()}
    if "trials_save_file" in kw:
        kw = {"trials_save_file": str(tmp_path / kw["trials_save_file"])}
    trials = H.Trials()
    H.fmin(lambda cfg: 0.0, t_mixed_space(), algo=T.suggest, max_evals=2,
           trials=trials, device="cpu", **kw)
    assert len(trials.trials) == 2 and trials.losses() == [0.0, 0.0]


@pytest.mark.parametrize("kw", [{"joint_ei": True}, {"speculative": 4}, {"fused": True},
                                {"resident": True}, {"ask_ahead": False, "fused": True},
                                {"speculative": 2, "max_stale": 0}])
def test_every_suggest_mode_runs(kw):
    trials = H.Trials()
    H.fmin(mixed_space_fn, t_mixed_space(), algo=H.partial(T.suggest, n_EI_candidates=16, **kw),
           max_evals=24, trials=trials, rstate=np.random.default_rng(0), device="cpu")
    assert len(trials.trials) == 24 and np.all(np.isfinite(trials.losses()))


# -- joint EI -----------------------------------------------------------------

JOINT_BATCH = 8


def _ref_joint(jps, n_cand):
    """Jitted reference: the joint score [B, S] of every configuration
    column and its candidate values [B, D, S], on the reference's key
    tree (``tpe_jax.build_suggest_fn(joint_ei=True)``'s body)."""
    import jax.numpy as jnp

    c = jps._consts
    D, dc, dk = jps.n_dims, len(jps.cont_idx), len(jps.cat_idx)
    batch = JOINT_BATCH

    def fn(key, values, active, losses, valid):
        fits = JK.fit_all_dims(c, values, active, losses, valid, 0.25, 25.0, 1.0,
                               above_cap=JK.DEFAULT_ABOVE_CAP)
        keys = jax.random.split(key, batch * (dc + dk))
        cand = jnp.zeros((batch, D, n_cand), jnp.float32)
        llrs = jnp.zeros((batch, D, n_cand), jnp.float32)
        v, l = JK.ei_sweep_cont_scores(jps.q, c, keys[: batch * dc].reshape(batch, dc),
                                       fits["cont"], n_cand)
        cand, llrs = cand.at[:, c["cont_idx"]].set(v), llrs.at[:, c["cont_idx"]].set(l)
        v, l = JK.ei_sweep_cat_scores(keys[batch * dc:].reshape(batch, dk), *fits["cat"], n_cand)
        cand = cand.at[:, c["cat_idx"]].set(v + c["int_low"][None, :, None])
        llrs = llrs.at[:, c["cat_idx"]].set(l)
        flat = jnp.moveaxis(cand, 0, 1).reshape(D, batch * n_cand)
        act = jnp.moveaxis(jps.active_fn(flat).reshape(D, batch, n_cand), 0, 1)
        return jnp.sum(jnp.where(act, llrs, 0.0), axis=1), cand

    return jax.jit(fn)


@pytest.mark.parametrize("seed", [0, pytest.param(1, marks=pytest.mark.slow)])
def test_joint_ei_teacher_forced(seed, spaces):
    """B=8 on the 200-obs history: ``active`` equal, and every trial picks
    the reference's configuration column unless the reference's own
    margin between its best and its second-best column is a near-tie
    (< NEAR_TIE); the two packages' joint scores at those two columns
    agree 10x closer than that."""
    jps, tps = spaces["jps"], spaces["tps"]
    batch = JOINT_BATCH
    arrays = _history(jps, 200, 256, seed)
    key = jax.random.key(2000 + seed)
    jfn = tpe_jax.build_suggest_fn(jps, N_CAND, 0.25, 25, 1.0, joint_ei=True, n_cand_cat=N_CAT)
    jv, ja = (np.asarray(a) for a in jfn(key, *arrays, batch=batch))
    state = convert.history_from_numpy(*arrays, device="cpu")
    tkey = convert.key_from_numpy(jax.random.key_data(key), device="cpu")
    tfn = T.build_suggest_fn(tps, N_CAND, 0.25, 25, 1.0, joint_ei=True, n_cand_cat=N_CAT)
    tv, ta = (a.numpy() for a in tfn(tkey, *state, batch))

    joint, cand = (np.asarray(a) for a in _ref_joint(jps, N_CAND)(key, *arrays))
    order = np.argsort(-joint, axis=1, kind="stable")
    best, second = order[:, 0], order[:, 1]
    rows = np.arange(batch)
    margin = joint[rows, best] - joint[rows, second]
    np.testing.assert_array_equal(jv, cand[rows, :, best].T)  # the helper is the reference
    same = np.all(np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL), axis=0)
    assert np.all(same | (margin < NEAR_TIE)), (same, margin)
    assert np.array_equal(ja[:, same], ta[:, same])
    assert same.sum() >= batch - 1

    # the port's joint scores, from its own candidates, at the two columns
    ps_c = tps.consts
    fits = TK.fit_all_dims(ps_c, *state, 0.25, 25.0, 1.0, above_cap=TK.DEFAULT_ABOVE_CAP)
    keys = R.split(tkey, batch * 20)
    _, cl = TK.ei_sweep_cont_scores(tps.q, ps_c, keys[: batch * 14].reshape(batch, 14, 2),
                                    fits["cont"], N_CAND)
    _, kl = TK.ei_sweep_cat_scores(keys[batch * 14:].reshape(batch, 6, 2), *fits["cat"], N_CAND)
    llrs = np.zeros((batch, jps.n_dims, N_CAND), np.float32)
    llrs[:, jps.cont_idx], llrs[:, jps.cat_idx] = cl.numpy(), kl.numpy()
    act = np.moveaxis(jps.active_fn(np.moveaxis(cand, 0, 1).reshape(jps.n_dims, -1)), 0, 1)
    act = np.moveaxis(np.asarray(act).reshape(jps.n_dims, batch, N_CAND), 0, 1)
    tjoint = np.where(act, llrs, 0.0).sum(1)
    for col in (best, second):
        assert np.abs(tjoint[rows, col] - joint[rows, col]).max() < NEAR_TIE / 10


def test_ei_sweep_cat_scores_bitwise(spaces):
    """The per-candidate categorical sweep: the same draws and llrs as
    the reference's, bit for bit, on the same posteriors and keys."""
    jps = spaces["jps"]
    arrays = _history(jps, 200, 256, 4)
    fits = jax.jit(lambda *a: JK.fit_all_dims(jps._consts, *a, 0.25, 25.0, 1.0)["cat"])(*arrays)
    pb, pa = (np.asarray(a) for a in fits)
    keys = jax.random.split(jax.random.key(77), 3 * pb.shape[0]).reshape(3, pb.shape[0])
    jv, jl = (np.asarray(a) for a in JK.ei_sweep_cat_scores(keys, pb, pa, 40))
    tkeys = convert.key_from_numpy(jax.random.key_data(keys), device="cpu")
    tv, tl = TK.ei_sweep_cat_scores(tkeys, torch.tensor(pb), torch.tensor(pa), 40)
    assert tv.shape == (3, pb.shape[0], 40)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), jl)


# -- speculative, fused ---------------------------------------------------------

def _driven(jalgo, talgo, n, seed=0):
    """The same FMinIter run through both packages, each with its own
    Domain: (reference trials, domain), (port trials, domain)."""
    from hyperopt_tpu.fmin import FMinIter as JFMinIter

    jd, jt = J.Domain(mixed_space_fn, j_mixed_space()), J.Trials()
    JFMinIter(jalgo, jd, jt, rstate=np.random.default_rng(seed), max_evals=n,
              show_progressbar=False).exhaust()
    td, tt = H.Domain(mixed_space_fn, t_mixed_space(), device="cpu"), H.Trials()
    TFMinIter(talgo, td, tt, rstate=np.random.default_rng(seed), max_evals=n).exhaust()
    return (jt, jd), (tt, td)


def test_speculative_stream_matches_reference():
    """40 trials with ``speculative=4``: startup equal, the first
    divergence (if any) a near-tie of the reference's own k-wide draw,
    and the same number of draws through each package's buffer."""
    from hyperopt_tpu.fmin import partial as jpartial
    from hyperopt_tpu.jax_trials import obs_buffer_for as j_buf
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for as t_buf

    k, n, seed = 4, 40, 0
    (jt, jd), (tt, td) = _driven(jpartial(tpe_jax.suggest, speculative=k),
                                 H.partial(T.suggest, speculative=k), n, seed)
    assert j_buf(jd, jt).dispatch_count == t_buf(td, tt).dispatch_count == n // k
    jps = j_compile(j_mixed_space())
    first, labels = _first_divergence(jps, jt, tt)
    assert first is None or first >= 20, (first, labels)
    if first is None:
        return
    j = 20 + k * ((first - 20) // k)  # the ask whose k-wide draw made `first`
    buf = JObsBuffer(jps)
    hist = J.Trials()
    hist._insert_trial_docs(jt.trials[:j])
    hist.refresh()
    buf.sync(hist)
    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)] for a in buf.arrays())
    rng = np.random.default_rng(seed)
    seeds = [int(rng.integers(2**31 - 1)) for _ in range(j + 1)]
    margins = _ref_margins(jps, arrays, host_key(seeds[j] % (2**31 - 1)), k)[:, first - j]
    for label in labels:
        assert margins[jps.labels.index(label)] < NEAR_TIE, (first, label)


def test_saturated_categorical_guard_warns_once():
    """On a small pure-categorical space ``speculative=4`` degrades to one
    draw per ask, warns once, and gives the plain stream."""
    import warnings

    space = {"r": H.hp.randint("r", 3), "s": H.hp.randint("s", 4)}
    obj = lambda cfg: cfg["r"] * 0.1 + cfg["s"] * 0.01  # noqa: E731
    streams = []
    for kw in ({"speculative": 4}, {}):
        trials = H.Trials()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            H.fmin(obj, space, algo=H.partial(T.suggest, **kw), max_evals=30, trials=trials,
                   rstate=np.random.default_rng(1), device="cpu")
        assert sum("speculative=4 disabled" in str(x.message) for x in w) == len(kw)
        streams.append([t["misc"]["vals"] for t in trials.trials])
    assert streams[0] == streams[1]


def test_fused_takes_the_plain_drivers_seeds():
    """The ask-ahead hook pre-draws each seed from the same rstate stream:
    the fused driver hands the algo the plain driver's seeds, in order."""
    seen = {}
    for name, kw in (("plain", {}), ("fused", {"fused": True})):
        seeds = seen.setdefault(name, [])
        algo = H.partial(T.suggest, n_EI_candidates=16, **kw)

        def recording(new_ids, domain, trials, seed, algo=algo, seeds=seeds):
            seeds.append(seed)
            return algo(new_ids, domain, trials, seed)

        H.fmin(mixed_space_fn, t_mixed_space(), algo=recording, max_evals=25,
               trials=H.Trials(), rstate=np.random.default_rng(5), device="cpu")
    assert len(seen["plain"]) == 25 and seen["plain"] == seen["fused"]
