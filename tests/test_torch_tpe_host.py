"""The port's host TPE (``tpe_host``) against the reference's numpy TPE
(:mod:`hyperopt_tpu.tpe`).

Both are numpy code over the same seeded generators, so every public
function, every posterior draw and every ``fmin`` stream is held bitwise
(``assert_array_equal``, ``==`` on trial documents).  The numpy oracle is
pinned by patching ``_native`` to return None in both packages; one
stream runs with each package's native library instead: the two build
the same C++ source with the same flags on the same host, so that
stream is bitwise too.
"""

import unittest.mock

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import hp as jhp
from hyperopt_tpu import native as j_native
from hyperopt_tpu import rand as j_rand
from hyperopt_tpu import tpe as jt
from hyperopt_tpu.base import JOB_STATE_DONE, JOB_STATE_ERROR, JOB_STATE_RUNNING
from hyperopt_tpu.models.synthetic import DOMAINS as J_DOMAINS
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu_torch import hp as thp
from hyperopt_tpu_torch import native as t_native
from hyperopt_tpu_torch import rand_host as t_rand
from hyperopt_tpu_torch import tpe_host as tt
from hyperopt_tpu_torch.models.synthetic import DOMAINS as T_DOMAINS
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space

from test_torch_native import reference_library

EQ = np.testing.assert_array_equal


@pytest.fixture
def numpy_mode():
    """Both packages on their numpy oracle."""
    with unittest.mock.patch.object(jt, "_native", lambda: None), \
            unittest.mock.patch.object(tt, "_native", lambda: None):
        yield


def both(fn_name, *args, **kw):
    return getattr(jt, fn_name)(*args, **kw), getattr(tt, fn_name)(*args, **kw)


def test_module_constants_and_names():
    for name in ("_default_prior_weight", "_default_n_EI_candidates", "_default_gamma",
                 "_default_n_startup_jobs", "_default_linear_forgetting", "EPS"):
        assert getattr(jt, name) == getattr(tt, name), name
    assert jt.__all__ == tt.__all__
    assert set(jt.adaptive_parzen_samplers) == set(tt.adaptive_parzen_samplers)
    assert tt.ap_split_trials is tt.ap_filter_trials


@pytest.mark.parametrize("N,LF", [(0, 25), (5, 25), (25, 25), (40, 25), (100, 10), (7, 0)])
def test_linear_forgetting_weights(N, LF):
    EQ(*both("linear_forgetting_weights", N, LF))


@pytest.mark.parametrize("variant", ["adaptive_parzen_normal", "adaptive_parzen_normal_numpy"])
@pytest.mark.parametrize("n_obs", [0, 1, 2, 3, 7, 40])
def test_adaptive_parzen_normal(numpy_mode, variant, n_obs):
    obs = np.random.default_rng(n_obs).normal(0.5, 2.0, n_obs)
    for LF in (25, 5, 0):
        for g, w in zip(*both(variant, obs, 1.0, 0.0, 5.0, LF)):
            EQ(g, w)


def test_adaptive_parzen_normal_orig(numpy_mode):
    obs = np.random.default_rng(3).uniform(-2, 2, 30)
    for g, w in zip(*both("adaptive_parzen_normal_orig", obs, 0.5, 1.0, 3.0)):
        EQ(g, w)


def test_normal_cdf_and_trunc_sample():
    rng = np.random.default_rng(1)
    x, mu, sigma = rng.normal(size=20), rng.normal(size=20), rng.uniform(0, 2, 20)
    EQ(*both("normal_cdf", x, mu, sigma))
    for low, high in ((None, None), (-1.0, None), (None, 2.0), (-0.5, 0.5)):
        got = [mod._trunc_normal_sample(np.random.default_rng(5), mu, sigma, low, high, (20,))
               for mod in (jt, tt)]
        EQ(*got)


def _mixture(seed, K=9):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, K)
    return w / w.sum(), rng.normal(0.5, 1.5, K), rng.uniform(0.2, 2.0, K)


# (low, high, q): unbounded, bounded, quantized bounded, quantized open
BOUNDS = [(None, None, None), (-2.0, 3.0, None), (0.0, 10.0, 1.0), (None, None, 0.5)]


@pytest.mark.parametrize("family", ["GMM1", "LGMM1"])
@pytest.mark.parametrize("low,high,q", BOUNDS)
def test_gmm_sample_and_lpdf(numpy_mode, family, low, high, q):
    w, mu, sigma = _mixture(0)
    if family == "LGMM1" and low is not None:
        low, high = -1.0, 1.0  # log-space bounds
    samples = [getattr(mod, family)(w, mu, sigma, low=low, high=high, q=q,
                                    rng=np.random.default_rng(2), size=(40,))
               for mod in (jt, tt)]
    EQ(*samples)
    one = [getattr(mod, family)(w, mu, sigma, low=low, high=high, q=q,
                                rng=np.random.default_rng(3)) for mod in (jt, tt)]
    assert one[0] == one[1] and isinstance(one[1], float)
    for name in (f"{family}_lpdf", f"{family}_lpdf_numpy"):
        EQ(*both(name, samples[0], w, mu, sigma, low=low, high=high, q=q))


def test_broadcast_best_and_categorical_posterior():
    rng = np.random.default_rng(4)
    s, lb, la = rng.normal(size=24), rng.normal(size=24), rng.normal(size=24)
    assert jt.broadcast_best(s, lb, la) == tt.broadcast_best(s, lb, la)
    obs = rng.integers(0, 5, 40)
    prior = np.array([0.1, 0.2, 0.3, 0.2, 0.2])
    for LF in (25, 0):
        EQ(*both("categorical_posterior", obs, prior, 1.0, LF))


def all_dists_space(hp):
    """One label of every distribution the host TPE draws."""
    return {
        "u": hp.uniform("u", -5, 5), "qu": hp.quniform("qu", 0, 20, 1),
        "lu": hp.loguniform("lu", -4, 2), "qlu": hp.qloguniform("qlu", 0, 4, 2),
        "n": hp.normal("n", 0, 2), "qn": hp.qnormal("qn", 0, 4, 1),
        "ln": hp.lognormal("ln", 0, 1), "qln": hp.qlognormal("qln", 1, 1, 3),
        "ri": hp.randint("ri", 3, 9), "ch": hp.choice("ch", [0, 1, 2, 3]),
        "pc": hp.pchoice("pc", [(0.2, "a"), (0.5, "b"), (0.3, "c")]),
    }


def _stream(pkg, algo, space, fn, n, seed=0, **kw):
    trials = pkg.Trials()
    pkg.fmin(fn, space, algo=algo, max_evals=n, trials=trials, show_progressbar=False,
             rstate=np.random.default_rng(seed), **kw)
    return trials


def _docs_key(trials):
    return [(t["tid"], t["result"].get("loss"), t["misc"]["idxs"], t["misc"]["vals"])
            for t in trials.trials]


def _all_dists_fn(cfg):
    return float(sum(abs(v) if not isinstance(v, str) else len(v) for v in cfg.values()) % 17)


@pytest.fixture(scope="module")
def all_dists_histories():
    """60 trials of the every-distribution space in each package (the
    reference's host TPE and the port's, numpy mode): the history the
    posterior draws and the split are held on."""
    with unittest.mock.patch.object(jt, "_native", lambda: None), \
            unittest.mock.patch.object(tt, "_native", lambda: None):
        j = _stream(J, jt.suggest, all_dists_space(jhp), _all_dists_fn, 60)
        t = _stream(H, tt.suggest, all_dists_space(thp), _all_dists_fn, 60, device="cpu")
    assert _docs_key(j) == _docs_key(t)
    return j, t


@pytest.mark.parametrize("label", sorted(all_dists_space(thp)))
def test_posterior_draw_every_distribution(numpy_mode, all_dists_histories, label):
    jtr, ttr = all_dists_histories
    jdom = J.Domain(_all_dists_fn, all_dists_space(jhp))
    tdom = H.Domain(_all_dists_fn, all_dists_space(thp), device="cpu")
    jinfo, tinfo = jt._domain_helper(jdom).hps[label], tt._domain_helper(tdom).hps[label]
    assert jinfo.dist == tinfo.dist
    if tinfo.dist not in ("randint", "categorical", "randint_via_categorical"):
        assert jt._prior_gmm_params(jinfo) == tt._prior_gmm_params(tinfo)
    jb, ja = jt._obs_index_for(jdom, jtr, [label]).split_obs(0.25, 25)
    tb, ta = tt._obs_index_for(tdom, ttr, [label]).split_obs(0.25, 25)
    assert (jb, ja) == (tb, ta)
    for seed in range(3):
        got = [mod.adaptive_parzen_samplers[tinfo.dist](
            info, b[label], a[label], np.random.default_rng(seed), 1.0, 24, 25)
            for mod, info, b, a in ((jt, jinfo, jb, ja), (tt, tinfo, tb, ta))]
        assert got[0] == got[1] and type(got[0]) is type(got[1])


@pytest.mark.parametrize("gamma,LF", [(0.25, 25), (0.15, 10), (0.5, 5)])
def test_split_and_obs_index(all_dists_histories, gamma, LF):
    jtr, ttr = all_dists_histories
    labels = sorted(all_dists_space(thp))
    jb, ja = jt.ap_filter_trials(jtr, gamma, LF)
    tb, ta = tt.ap_split_trials(ttr, gamma, LF)
    assert [d["tid"] for d in jb] == [d["tid"] for d in tb]
    assert [d["tid"] for d in ja] == [d["tid"] for d in ta]
    assert jt._obs_by_label(jb, labels) == tt._obs_by_label(tb, labels)
    tdom = H.Domain(_all_dists_fn, all_dists_space(thp), device="cpu")
    assert tt._obs_index_for(tdom, ttr, labels).split_obs(gamma, LF) == (
        tt._obs_by_label(tb, labels), tt._obs_by_label(ta, labels))


def test_suggest_batch_and_draws(numpy_mode, all_dists_histories):
    jtr, ttr = all_dists_histories
    jdom = J.Domain(_all_dists_fn, all_dists_space(jhp))
    tdom = H.Domain(_all_dists_fn, all_dists_space(thp), device="cpu")
    ids = list(range(100, 106))
    assert jt.suggest_batch(ids, jdom, jtr, 7) == tt.suggest_batch(ids, tdom, ttr, 7)
    assert (jt.suggest_batch(ids, jdom, jtr, 7, n_startup_jobs=100)
            == tt.suggest_batch(ids, tdom, ttr, 7, n_startup_jobs=100))
    jd = jt._posterior_draws(jdom, jtr, np.random.default_rng(8), 1.0, 24, 0.25, 25)
    td = tt._posterior_draws(tdom, ttr, np.random.default_rng(8), 1.0, 24, 0.25, 25)
    assert jd == td
    assert jt._route_draws(jdom, jd) == tt._route_draws(tdom, td)
    got = [mod._suggest_config(dom, tr, np.random.default_rng(9), 1.0, 24, 0.25, 25)
           for mod, dom, tr in ((jt, jdom, jtr), (tt, tdom, ttr))]
    assert got[0] == got[1]


def _many_dists(pkg_domains):
    d = pkg_domains["many_dists"]
    return d.fn, d.make_space()


@pytest.mark.parametrize("space", ["mixed", "conditional"])
def test_fmin_stream_numpy_mode(numpy_mode, space):
    if space == "mixed":
        jargs, targs = (mixed_space_fn, j_mixed_space()), (mixed_space_fn, t_mixed_space())
    else:
        (jf, js), (tf, ts) = _many_dists(J_DOMAINS), _many_dists(T_DOMAINS)
        jargs, targs = (jf, js), (tf, ts)
    j = _stream(J, jt.suggest, jargs[1], jargs[0], 40)
    t = _stream(H, tt.suggest, targs[1], targs[0], 40, device="cpu")
    assert j.losses() == t.losses()
    assert _docs_key(j) == _docs_key(t)


def test_fmin_stream_native_library():
    """Each package on its own native library: the same source and flags
    on the same host, so the stream is bitwise."""
    if not (reference_library() and t_native.available()):
        pytest.skip("no C++ toolchain: the native libraries did not build")
    assert jt._native() is j_native and tt._native() is t_native
    j = _stream(J, jt.suggest, j_mixed_space(), mixed_space_fn, 40)
    t = _stream(H, tt.suggest, t_mixed_space(), mixed_space_fn, 40, device="cpu")
    assert _docs_key(j) == _docs_key(t)


def test_obs_index_late_completions():
    """The reference's ``_ObsIndex`` case in both packages: a store with
    mixed states, a split equal to ``ap_filter_trials``' at two settings,
    then RUNNING trials completing after the index scanned them."""
    results = []
    for pkg, mod, rand, domains in ((J, jt, j_rand, J_DOMAINS), (H, tt, t_rand, T_DOMAINS)):
        rng = np.random.default_rng(0)
        kw = {} if pkg is J else {"device": "cpu"}
        dom = pkg.Domain(domains["many_dists"].fn, domains["many_dists"].make_space(), **kw)
        trials = pkg.Trials()
        docs = rand.suggest(trials.new_trial_ids(80), dom, trials, seed=0)
        for d in docs:
            r = rng.uniform()
            if r < 0.7:
                d["state"] = JOB_STATE_DONE
                d["result"] = {"status": "ok", "loss": float(rng.uniform(0, 10))}
            elif r < 0.8:
                d["state"] = JOB_STATE_RUNNING
            elif r < 0.9:
                d["state"] = JOB_STATE_ERROR
            else:
                d["state"] = JOB_STATE_DONE
                d["result"] = {"status": "ok", "loss": float("nan")}
        trials.insert_trial_docs(docs)
        trials.refresh()
        labels = sorted(mod._domain_helper(dom).hps)
        out = []
        for gamma, LF in ((0.25, 25), (0.15, 10)):
            below, above = mod.ap_filter_trials(trials, gamma, LF)
            ref = (mod._obs_by_label(below, labels), mod._obs_by_label(above, labels))
            assert mod._obs_index_for(dom, trials, labels).split_obs(gamma, LF) == ref
            out.append(ref)
        for d in trials._dynamic_trials:
            if d["state"] == JOB_STATE_RUNNING:
                d["state"] = JOB_STATE_DONE
                d["result"] = {"status": "ok", "loss": float(rng.uniform(0, 10))}
        trials.refresh()
        below, above = mod.ap_filter_trials(trials, 0.25, 25)
        ref = (mod._obs_by_label(below, labels), mod._obs_by_label(above, labels))
        assert mod._obs_index_for(dom, trials, labels).split_obs(0.25, 25) == ref
        out.append(ref)
        results.append(out)
    assert results[0] == results[1]


def test_obs_index_keyed_by_trials_store():
    """A domain reused across two stores never serves one store's
    observations for the other."""
    dom = H.Domain(lambda x: x, thp.uniform("x", 0, 1), device="cpu")

    def store(n, loss):
        trials = H.Trials()
        trials.insert_trial_docs(t_rand.suggest(trials.new_trial_ids(n), dom, trials, seed=n))
        trials.refresh()
        for d in trials._dynamic_trials:
            d["state"] = JOB_STATE_DONE
            d["result"] = {"status": "ok", "loss": loss}
        trials.refresh()
        return trials

    a, b = store(4, 1.0), store(6, 2.0)
    assert len(tt._obs_index_for(dom, a, ["x"]).losses) == 4
    assert set(tt._obs_index_for(dom, b, ["x"]).losses) == {2.0}
    idx = tt._obs_index_for(dom, a, ["x"])
    assert len(idx.losses) == 4 and set(idx.losses) == {1.0}
