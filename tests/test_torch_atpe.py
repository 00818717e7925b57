"""The port's adaptive TPE (``atpe.suggest``, ``build_atpe_device_fn``)
against ``atpe_jax`` and ``atpe.ATPEOptimizer``.

The host decision layer is plain numpy in both packages: its settings
and lock sets must be EXACTLY equal on the same trials.  The device
function is teacher-forced at B=8 on a stalled and on an improving
history: its per-step settings must be the ones the history calls for,
and every pick must equal the reference's (categorical equal,
continuous within CONT_RTOL/CONT_ATOL, the tolerance of
``test_torch_tpe.py``) unless the reference's own sweep margin there is a
near-tie (< NEAR_TIE): the sweep is TPE's, with the same last-bit
differences.  Locks and restarts use the reference's key tree, so they
fall on the same columns.
"""

import numpy as np
import pytest
import torch

import jax

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import atpe as j_atpe_host, atpe_jax
from hyperopt_tpu.fmin import FMinIter as JFMinIter
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu_torch import atpe as A, convert
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from hyperopt_tpu_torch.ops import kernels as TK
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile

CONT_RTOL, CONT_ATOL = 5e-5, 1e-6
NEAR_TIE = 1e-3
BATCH = 8
N_EI, N_CAT = 256, 24  # the adapted counts at D=20 (base 128)


def _history(jps, kind, cap=256, n_obs=200, seed=0):
    """Prior draws with synthetic losses: ``stalled`` finds its best at
    slot 5 and then nothing better, its 8 elites converged on u0, u1 and
    ri0 (so they lock); ``improving`` gains on every observation."""
    values, active = (np.array(a) for a in jps.sample_prior(jax.random.key(seed), cap))
    rng = np.random.default_rng(seed)
    if kind == "stalled":
        losses = rng.uniform(1.0, 2.0, cap).astype(np.float32)
        elite = np.arange(5, 5 + 8 * 20, 20)
        losses[elite] = np.linspace(0.0, 0.5, 8, dtype=np.float32)
        for label, v in (("u0", 1.25), ("u1", -2.5)):
            d = jps.labels.index(label)
            values[d, elite] = v + rng.normal(0, 0.01, 8).astype(np.float32)
        values[jps.labels.index("ri0"), elite] = 3.0
    else:
        losses = (200.0 - np.arange(cap) + rng.uniform(0, 0.5, cap)).astype(np.float32)
    return values, active, losses, np.arange(cap) < n_obs


def _ref_margins(jps, arrays, key, gamma, pw):
    """The reference's near-tie margin of every (dim, trial) pick of the
    sweep inside the adaptive step (its key: ``split(key, 3)[0]``)."""
    c, dc, dk = jps._consts, len(jps.cont_idx), len(jps.cat_idx)

    def fn(key, values, active, losses, valid):
        fits = JK.fit_all_dims(c, values, active, losses, valid, gamma, 25.0, pw,
                               pad_gamma=0.35, above_cap=JK.DEFAULT_ABOVE_CAP)
        keys = jax.random.split(jax.random.split(key, 3)[0], BATCH * (dc + dk))
        cv, cl = JK.ei_sweep_cont_scores(jps.q, c, keys[: BATCH * dc].reshape(BATCH, dc),
                                         fits["cont"], N_EI)
        kv, kl = JK.ei_sweep_cat_scores(keys[BATCH * dc:].reshape(BATCH, dk), *fits["cat"], N_CAT)
        return cv, cl, kv, kl

    cv, cl, kv, kl = (np.asarray(a) for a in jax.jit(fn)(key, *arrays))

    def margins(vals, llr):
        best = llr.argmax(-1)
        win_v = np.take_along_axis(vals, best[..., None], -1)
        other = np.where(vals != win_v, llr, -np.inf).max(-1)
        return np.take_along_axis(llr, best[..., None], -1)[..., 0] - other

    out = np.empty((jps.n_dims, BATCH))
    out[jps.cont_idx], out[jps.cat_idx] = margins(cv, cl).T, margins(kv, kl).T
    return out


@pytest.fixture(scope="module")
def spaces():
    jps = j_compile(j_mixed_space())
    return {"jps": jps, "tps": t_compile(t_mixed_space(), device="cpu"),
            "jfn": atpe_jax.build_atpe_device_fn(jps, 25.0)}


@pytest.mark.parametrize("kind,gamma,pw,explore", [
    ("stalled", 0.35, 1.5, 0.25), ("improving", 0.30, 1.0, 0.0)])
def test_device_fn_teacher_forced(spaces, kind, gamma, pw, explore):
    jps, tps = spaces["jps"], spaces["tps"]
    arrays = _history(jps, kind)
    key = jax.random.key(500 if kind == "stalled" else 501)
    jv, ja = (np.asarray(a) for a in spaces["jfn"](key, *arrays, batch=BATCH))
    state = convert.history_from_numpy(*arrays, device="cpu")
    tkey = convert.key_from_numpy(jax.random.key_data(key), device="cpu")
    tfn = A.build_atpe_device_fn(tps, 25.0)
    tv, ta = (a.numpy() for a in tfn(tkey, *state, BATCH))

    g, p, e, ok, n = tfn.settings(state.losses, state.valid)
    assert (float(g), float(p), float(e), int(n)) == (
        np.float32(gamma), pw, explore, 200)
    lock_mask, lock_vals = tfn.lock_set(state.values, state.active, state.losses, ok, n)
    locked = [jps.labels[d] for d in np.flatnonzero(lock_mask.numpy())]
    assert locked == (["ri0", "u0", "u1"] if kind == "stalled" else [])

    assert np.array_equal(ja, ta)
    cat = np.zeros(jps.n_dims, bool)
    cat[jps.cat_idx] = True
    same = np.where(cat[:, None], tv == jv, np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL))
    margins = _ref_margins(jps, arrays, key, np.float32(gamma), np.float32(pw))
    assert np.all(same | (margins < NEAR_TIE)), np.argwhere(~same & (margins >= NEAR_TIE))
    assert (~same).sum() <= 2


def test_prior_weight_tensor_fits_like_a_float(spaces):
    """``fit_all_dims`` takes the device fn's 0-dim tensor prior weight
    (and gamma) without a host sync, bitwise the float's fits."""
    tps = spaces["tps"]
    state = convert.history_from_numpy(*_history(spaces["jps"], "improving"), device="cpu")
    args = (tps.consts, *state)
    want = TK.fit_all_dims(*args, 0.3, 25.0, 1.5, pad_gamma=0.35, above_cap=512)
    got = TK.fit_all_dims(*args, torch.tensor(0.3), 25.0, torch.tensor(1.5), pad_gamma=0.35,
                          above_cap=512)
    for w, g in zip(want["cont"] + want["cat"], got["cont"] + got["cat"]):
        assert torch.equal(w, g)


def _trials_pair(kind, n=60, seed=2):
    """The same completed trial docs in a reference and a port store."""
    jd = J.Domain(mixed_space_fn, j_mixed_space())
    jt = J.Trials()
    docs = J.rand.suggest(list(range(n)), jd, jt, seed)
    rng = np.random.default_rng(seed)
    losses = (rng.uniform(1, 2, n) if kind == "stalled"
              else 100.0 - np.arange(n) + rng.uniform(0, 0.5, n))
    if kind == "stalled":
        losses[3] = 0.0
        for i in np.argsort(losses)[:8]:  # converged elites: locks
            docs[i]["misc"]["vals"]["u2"] = [0.75 + 0.001 * i]
            docs[i]["misc"]["vals"]["ch1"] = [2]
    for doc, loss in zip(docs, losses):
        doc["state"] = 2
        doc["result"] = {"status": "ok", "loss": float(loss)}
    jt.insert_trial_docs(docs)
    jt.refresh()
    tt = H.Trials()
    tt.insert_trial_docs([{**d, "misc": {**d["misc"]}} for d in docs])
    tt.refresh()
    return (jd, jt), (H.Domain(mixed_space_fn, t_mixed_space(), device="cpu"), tt)


@pytest.mark.parametrize("kind", ["stalled", "improving"])
def test_optimizer_decisions_equal_reference(kind):
    (jd, jt), (td, tt) = _trials_pair(kind)
    jopt = j_atpe_host.ATPEOptimizer(base_n_ei=128)
    topt = A.ATPEOptimizer(base_n_ei=128)
    assert topt.tpe_settings(td, tt) == jopt.tpe_settings(jd, jt)
    locks = topt.lock_candidates(td, tt)
    assert locks == jopt.lock_candidates(jd, jt)
    assert (set(locks) == {"u2", "ch1"}) == (kind == "stalled")
    for seed in range(4):
        assert (topt.locked_values(td, tt, np.random.default_rng(seed))
                == jopt.locked_values(jd, jt, np.random.default_rng(seed)))


def test_atpe_stream_matches_reference():
    """50 trials of ``atpe.suggest`` through both drivers: startup equal,
    the first divergence (if any) a near-tie of the reference's own
    adaptive sweep at that ask."""
    from test_torch_tpe import _first_divergence, _ref_margins as tpe_margins

    n, seed = 50, 1
    jd, jt = J.Domain(mixed_space_fn, j_mixed_space()), J.Trials()
    JFMinIter(atpe_jax.suggest, jd, jt, rstate=np.random.default_rng(seed), max_evals=n,
              show_progressbar=False).exhaust()
    td, tt = H.Domain(mixed_space_fn, t_mixed_space(), device="cpu"), H.Trials()
    FMinIter(A.suggest, td, tt, rstate=np.random.default_rng(seed), max_evals=n).exhaust()
    jps = j_compile(j_mixed_space())
    first, labels = _first_divergence(jps, jt, tt)
    assert first is None or first >= 20, (first, labels)
    if first is None:
        return
    hist = J.Trials()
    hist._insert_trial_docs(jt.trials[:first])
    hist.refresh()
    settings = j_atpe_host.ATPEOptimizer(base_n_ei=128).tpe_settings(jd, hist)
    buf = JObsBuffer(jps)
    buf.sync(hist)
    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)] for a in buf.arrays())
    rstate = np.random.default_rng(seed)
    ask_seed = [int(rstate.integers(2**31 - 1)) for _ in range(first + 1)][first]
    dev_seed = int(np.random.default_rng(ask_seed).integers(0, 2**31 - 1))
    c, dc, dk = jps._consts, len(jps.cont_idx), len(jps.cat_idx)

    def cands(key, values, active, losses, valid):
        fits = JK.fit_all_dims(c, values, active, losses, valid, settings["gamma"], 25.0,
                               settings["prior_weight"], above_cap=JK.DEFAULT_ABOVE_CAP)
        keys = jax.random.split(key, dc + dk)
        cv, cl = JK.ei_sweep_cont_scores(jps.q, c, keys[:dc].reshape(1, dc), fits["cont"],
                                         settings["n_EI_candidates"])
        kv, kl = JK.ei_sweep_cat_scores(keys[dc:].reshape(1, dk), *fits["cat"], N_CAT)
        return cv, cl, kv, kl

    margins = tpe_margins(jps, arrays, host_key(dev_seed % (2**31 - 1)), 1,
                          cands=jax.jit(cands))[:, 0]
    for label in labels:
        assert margins[jps.labels.index(label)] < NEAR_TIE, (first, label)


def test_atpe_resident_parity():
    streams = {}
    for resident in (None, True):
        trials = H.Trials()
        H.fmin(mixed_space_fn, t_mixed_space(), algo=H.partial(A.suggest, resident=resident),
               max_evals=40, trials=trials, rstate=np.random.default_rng(4), device="cpu")
        streams[resident] = [t["misc"]["vals"] for t in trials.trials]
    assert streams[None] == streams[True]


def test_mesh_raises():
    """What the ATPE mesh options still refuse, as the reference does: a
    ``cand_axis`` without a mesh; a mesh over two processes when no
    process group joins them, at the first warm draw (startup draws need
    no mesh)."""
    from hyperopt_tpu_torch.parallel.mesh import RankMesh

    with pytest.raises(ValueError, match="requires a mesh"):
        atpe_jax.build_atpe_device_fn(j_compile(j_mixed_space()), 25.0, cand_axis="cand")
    with pytest.raises(ValueError, match="requires a mesh"):
        A.build_atpe_device_fn(t_compile(t_mixed_space(), device="cpu"), 25.0, cand_axis="cand")
    trials = H.Trials()
    algo = H.partial(A.suggest, mesh=RankMesh((2,), ("cand",), (0, 1)), n_startup_jobs=3)
    with pytest.raises(RuntimeError, match="virtual_mesh"):
        H.fmin(mixed_space_fn, t_mixed_space(), algo=algo, max_evals=4, trials=trials,
               rstate=np.random.default_rng(0), device="cpu", show_progressbar=False)
    assert len(trials.trials) == 3


def _mesh_fmin(fmin, trials_cls, suggest, hp, mesh, fmin_kw=(), **kw):
    trials = trials_cls()
    fmin(lambda x: (x - 3.0) ** 2, hp.uniform("x", -10, 10),
         algo=H.partial(suggest, mesh=mesh, **kw), max_evals=40, trials=trials,
         rstate=np.random.default_rng(2), show_progressbar=False, **dict(fmin_kw))
    return trials


@pytest.mark.parametrize("speculative", [0, 4])
def test_suggest_mesh_matches_reference(speculative):
    """``atpe.suggest(mesh=virtual_mesh(4))`` through ``fmin`` against
    ``atpe_jax.suggest(mesh=)`` on a 4-device ``cand`` mesh (the
    reference's ``test_sharding.py`` case, cut to 40 trials): every value
    within CONT_RTOL/CONT_ATOL and every loss close; the sharded warm
    draws part from the unsharded stream; the speculative cache keys on
    the mesh."""
    from hyperopt_tpu.parallel.mesh import mesh_from_spec as j_mesh_from_spec
    from hyperopt_tpu_torch.parallel.mesh import virtual_mesh

    kw = dict(speculative=speculative) if speculative else {}
    jt = _mesh_fmin(J.fmin, J.Trials, atpe_jax.suggest, J.hp,
                    j_mesh_from_spec((4,), ("cand",), devices=jax.devices()[:4]), **kw)
    mesh = virtual_mesh(4)
    tt = _mesh_fmin(H.fmin, H.Trials, A.suggest, H.hp, mesh, {"device": "cpu"}, **kw)
    jx = np.array([t["misc"]["vals"]["x"][0] for t in jt.trials])
    tx = np.array([t["misc"]["vals"]["x"][0] for t in tt.trials])
    assert len(tx) == 40
    np.testing.assert_allclose(tx, jx, rtol=CONT_RTOL, atol=CONT_ATOL)
    np.testing.assert_allclose(tt.losses(), jt.losses(), rtol=1e-5, atol=2e-5)
    assert min(tt.losses()) < 1.0
    plain = _mesh_fmin(H.fmin, H.Trials, A.suggest, H.hp, None, {"device": "cpu"}, **kw)
    px = np.array([t["misc"]["vals"]["x"][0] for t in plain.trials])
    assert np.array_equal(px[:20], tx[:20]) and not np.array_equal(px[20:], tx[20:])
