"""The port's host algorithms against the reference's: ``anneal_host``
(:mod:`hyperopt_tpu.anneal`), ``atpe_host`` (:mod:`hyperopt_tpu.atpe`)
and ``mix`` (:mod:`hyperopt_tpu.mix`) over ``tpe_host``/``rand_host``.

Each is numpy code over the same seeded generators, so each ``fmin``
stream of 40 trials is held bitwise (losses and trial documents), with
the host TPE on its numpy oracle in both packages.  ATPE's stream runs
past its 20 startup jobs with ``lock_fraction=1`` on a space whose
elite converges, and the locks it takes are counted.
"""

import unittest.mock

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import anneal as ja
from hyperopt_tpu import atpe as jatpe
from hyperopt_tpu import hp as jhp
from hyperopt_tpu import mix as jmix
from hyperopt_tpu import rand as jrand
from hyperopt_tpu import tpe as jt
from hyperopt_tpu.models.synthetic import DOMAINS as J_DOMAINS
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu_torch import anneal_host as ta
from hyperopt_tpu_torch import atpe_host as tatpe
from hyperopt_tpu_torch import hp as thp
from hyperopt_tpu_torch import mix as tmix
from hyperopt_tpu_torch import rand_host as trand
from hyperopt_tpu_torch import tpe_host as tt
from hyperopt_tpu_torch.fmin import partial as tpartial
from hyperopt_tpu.fmin import partial as jpartial
from hyperopt_tpu_torch.models.synthetic import DOMAINS as T_DOMAINS
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space

N = 40


@pytest.fixture(autouse=True)
def numpy_mode():
    with unittest.mock.patch.object(jt, "_native", lambda: None), \
            unittest.mock.patch.object(tt, "_native", lambda: None):
        yield


def _run(pkg, algo, fn, space, n=N, seed=0):
    trials = pkg.Trials()
    kw = {} if pkg is J else {"device": "cpu"}
    pkg.fmin(fn, space, algo=algo, max_evals=n, trials=trials, show_progressbar=False,
             rstate=np.random.default_rng(seed), **kw)
    return trials


def _key(trials):
    return [(t["tid"], t["state"], t["result"].get("loss"), t["misc"]["idxs"], t["misc"]["vals"])
            for t in trials.trials]


def _assert_same(j, t):
    assert j.losses() == t.losses()
    assert _key(j) == _key(t)


def locking_space(hp):
    """A categorical the elite agrees on and two continuous dims."""
    return {"x": hp.uniform("x", -5, 5), "y": hp.uniform("y", -5, 5),
            "c": hp.choice("c", [0, 1, 2])}


def locking_fn(cfg):
    return (cfg["x"] - 1.0) ** 2 + 0.5 * cfg["y"] ** 2 + 10.0 * (cfg["c"] != 0)


SPACES = {
    "mixed": (mixed_space_fn, j_mixed_space, t_mixed_space),
    "conditional": (J_DOMAINS["many_dists"].fn, J_DOMAINS["many_dists"].make_space,
                    T_DOMAINS["many_dists"].make_space),
}


@pytest.mark.parametrize("space", sorted(SPACES))
def test_anneal_stream(space):
    fn, jspace, tspace = SPACES[space]
    _assert_same(_run(J, ja.suggest, fn, jspace()), _run(H, ta.suggest, fn, tspace()))


def test_anneal_stream_options():
    j = _run(J, jpartial(ja.suggest, avg_best_idx=4.0, shrink_coef=0.3), mixed_space_fn,
             j_mixed_space(), seed=3)
    t = _run(H, tpartial(ta.suggest, avg_best_idx=4.0, shrink_coef=0.3), mixed_space_fn,
             t_mixed_space(), seed=3)
    _assert_same(j, t)


@pytest.mark.parametrize("label", ["u", "qu", "lu", "qlu", "n", "qn", "ln", "qln", "ri", "ch"])
def test_anneal_draws_every_distribution(label):
    """``prior_draw`` and ``neighborhood_draw`` of each distribution."""
    from test_torch_tpe_host import all_dists_space

    out = []
    for pkg, mod, hp in ((J, ja, jhp), (H, ta, thp)):
        kw = {} if pkg is J else {"device": "cpu"}
        dom = pkg.Domain(lambda cfg: 0.0, all_dists_space(hp), **kw)
        algo = mod.AnnealingAlgo(dom, pkg.Trials(), 5)
        info = algo.hps[label]
        prior = [algo.prior_draw(info) for _ in range(8)]
        near = [algo.neighborhood_draw(info, prior[i], n) for i, n in enumerate((0, 3, 10, 40))]
        out.append((prior, near, algo.shrink_frac(7)))
    assert out[0] == out[1]


@pytest.mark.parametrize("space", ["locking", "mixed"])
def test_atpe_stream_past_startup(space):
    if space == "locking":
        fn, jspace, tspace = locking_fn, locking_space(jhp), locking_space(thp)
        algos = (jpartial(jatpe.suggest, lock_fraction=1.0),
                 tpartial(tatpe.suggest, lock_fraction=1.0))
    else:
        fn, jspace, tspace = mixed_space_fn, j_mixed_space(), t_mixed_space()
        algos = (jatpe.suggest, tatpe.suggest)
    locks = []
    real = tatpe.ATPEOptimizer.lock_candidates

    def counting(self, domain, trials):
        got = real(self, domain, trials)
        locks.append(sorted(got))
        return got

    j = _run(J, algos[0], fn, jspace)
    with unittest.mock.patch.object(tatpe.ATPEOptimizer, "lock_candidates", counting):
        t = _run(H, algos[1], fn, tspace)
    _assert_same(j, t)
    assert len(t.trials) == N
    if space == "locking":
        assert any(locks), "no label locked: the stream did not test locking"


def test_atpe_settings_and_lock_candidates():
    """The adaptive settings and the lock set on one history of each."""
    j = _run(J, jpartial(jatpe.suggest, lock_fraction=1.0), locking_fn, locking_space(jhp))
    t = _run(H, tpartial(tatpe.suggest, lock_fraction=1.0), locking_fn, locking_space(thp))
    jdom = J.Domain(locking_fn, locking_space(jhp))
    tdom = H.Domain(locking_fn, locking_space(thp), device="cpu")
    jopt, topt = jatpe.ATPEOptimizer(), tatpe.ATPEOptimizer()
    assert jopt.tpe_settings(jdom, j) == topt.tpe_settings(tdom, t)
    assert jopt.lock_candidates(jdom, j) == topt.lock_candidates(tdom, t)
    for seed in range(4):
        assert (jopt.suggest_config(jdom, j, np.random.default_rng(seed))
                == topt.suggest_config(tdom, t, np.random.default_rng(seed)))


@pytest.mark.parametrize("mixture", ["tpe_rand", "anneal_rand_tpe"])
def test_mix_stream(mixture):
    if mixture == "tpe_rand":
        jp = [(0.7, jt.suggest), (0.3, jrand.suggest)]
        tp = [(0.7, tt.suggest), (0.3, trand.suggest)]
    else:
        jp = [(0.2, ja.suggest), (0.3, jrand.suggest), (0.5, jt.suggest)]
        tp = [(0.2, ta.suggest), (0.3, trand.suggest), (0.5, tt.suggest)]
    j = _run(J, jpartial(jmix.suggest, p_suggest=jp), mixed_space_fn, j_mixed_space())
    t = _run(H, tpartial(tmix.suggest, p_suggest=tp), mixed_space_fn, t_mixed_space())
    _assert_same(j, t)


def test_mix_rejects_probabilities_not_summing_to_one():
    dom = H.Domain(mixed_space_fn, t_mixed_space(), device="cpu")
    with pytest.raises(ValueError, match="sum to 1.0"):
        tmix.suggest([0], dom, H.Trials(), 0, p_suggest=[(0.5, trand.suggest)])
    assert H.mix is tmix
