"""The port's benchmark domains against the reference's, and the port's
two TPEs held to the battery's thresholds.

The battery (``models.synthetic.DOMAINS``), the XGBoost surrogate
(``models.surrogate``) and NAS-Bench-201 (``models.nasbench``): the same
names, minima and targets; each space's draws equal under one seed
(``pyll.stochastic.sample`` in each package) and each objective equal on
50 of them; NAS-Bench-201's full table and optimum equal.

Quality: the thresholds are the reference's statistic, the median best
loss over seeds 0-4 (``tests/test_domains.py``).  The port's device TPE
(on the CPU here) meets them on ``quadratic1`` and ``branin`` -- the
seeds and statistic that ``chip_smoke.py`` phase 15 asserts on the card
-- and, under ``-m slow``, on every other domain; the host TPE
(``tpe_host``) meets them on the reference's threshold domains.
"""

import numpy as np
import pytest

import hyperopt_tpu_torch as H
from hyperopt_tpu.models import nasbench as j_nas
from hyperopt_tpu.models import surrogate as j_sur
from hyperopt_tpu.models.synthetic import DOMAINS as J_DOMAINS
from hyperopt_tpu.models.synthetic import battery as j_battery
from hyperopt_tpu.pyll.stochastic import sample as j_sample
from hyperopt_tpu_torch.models import nasbench as t_nas
from hyperopt_tpu_torch.models import surrogate as t_sur
from hyperopt_tpu_torch.models.synthetic import DOMAINS as T_DOMAINS
from hyperopt_tpu_torch.models.synthetic import battery as t_battery
from hyperopt_tpu_torch.pyll.stochastic import sample as t_sample

SEEDS = (0, 1, 2, 3, 4)
N_CONFIGS = 50
# the reference's threshold domains for its host algorithms
HOST_THRESHOLD_DOMAINS = ["quadratic1", "q1_choice", "n_arms", "branin", "gauss_wave2"]
FAST_DEVICE_DOMAINS = ["quadratic1", "branin"]


def test_battery_names_minima_and_targets():
    assert list(J_DOMAINS) == list(T_DOMAINS)
    for name, j in J_DOMAINS.items():
        t = T_DOMAINS[name]
        assert (t.name, t.global_min, t.targets) == (j.name, j.global_min, j.targets)
        assert repr(t) == repr(j)
    assert [d.name for d in t_battery()] == [d.name for d in j_battery()]
    assert [d.name for d in t_battery(["branin", "n_arms"])] == ["branin", "n_arms"]


def _draws(sample, space, seed=0):
    rng = np.random.default_rng(seed)
    return [sample(space, rng) for _ in range(N_CONFIGS)]


@pytest.mark.parametrize("name", sorted(J_DOMAINS))
def test_battery_draws_and_objective(name):
    j, t = J_DOMAINS[name], T_DOMAINS[name]
    jcfgs, tcfgs = _draws(j_sample, j.make_space()), _draws(t_sample, t.make_space())
    assert jcfgs == tcfgs
    assert [j.fn(c) for c in jcfgs] == [t.fn(c) for c in tcfgs]


def test_branin_and_hartmann6_at_their_minima():
    from hyperopt_tpu.models.synthetic import branin_fn, hartmann6_fn
    from hyperopt_tpu_torch.models import synthetic as S

    for cfg in ({"x1": -np.pi, "x2": 12.275}, {"x1": 9.42478, "x2": 2.475}):
        assert S.branin_fn(cfg) == branin_fn(cfg)
        assert abs(S.branin_fn(cfg) - T_DOMAINS["branin"].global_min) < 1e-5
    x = [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573]
    cfg = {f"x{i}": v for i, v in enumerate(x)}
    assert S.hartmann6_fn(cfg) == hartmann6_fn(cfg)
    assert abs(S.hartmann6_fn(cfg) - T_DOMAINS["hartmann6"].global_min) < 1e-4


@pytest.mark.parametrize("bench", ["surrogate", "nasbench"])
def test_benchmark_draws_and_objective(bench):
    j, t = (j_sur, t_sur) if bench == "surrogate" else (j_nas, t_nas)
    assert j.__all__ == t.__all__
    jcfgs, tcfgs = _draws(j_sample, j.space(), 3), _draws(t_sample, t.space(), 3)
    assert jcfgs == tcfgs
    assert [j.objective(c) for c in jcfgs] == [t.objective(c) for c in tcfgs]
    if bench == "surrogate":
        assert t.best_known() == j.best_known()
    else:
        assert [j.arch_from_config(c) for c in jcfgs] == [t.arch_from_config(c) for c in tcfgs]
        assert (t.OPS, t.N_EDGES) == (j.OPS, j.N_EDGES)


def test_nasbench_full_table_and_optimum():
    j_archs, j_losses = j_nas.full_table()
    t_archs, t_losses = t_nas.full_table()
    assert t_archs == j_archs and len(t_archs) == 5 ** 6
    np.testing.assert_array_equal(t_losses, j_losses)
    assert t_nas.optimal_loss() == j_nas.optimal_loss() == float(t_losses.min())
    assert t_nas.full_table() is t_nas.full_table()  # cached


def best_loss(domain, algo, seed):
    trials = H.Trials()
    n_evals = next(iter(domain.targets))
    H.fmin(domain.fn, domain.make_space(), algo=algo, max_evals=n_evals, trials=trials,
           rstate=np.random.default_rng(seed), device="cpu", show_progressbar=False,
           catch_eval_exceptions=False)
    assert len(trials.trials) == n_evals
    return trials.best_trial["result"]["loss"]


def median_best(name, algo):
    return float(np.median([best_loss(T_DOMAINS[name], algo, s) for s in SEEDS]))


@pytest.mark.parametrize("name", [
    n if n in FAST_DEVICE_DOMAINS else pytest.param(n, marks=pytest.mark.slow)
    for n in T_DOMAINS])
def test_device_tpe_meets_the_threshold(name):
    threshold = next(iter(T_DOMAINS[name].targets.values()))
    med = median_best(name, H.tpe.suggest)
    assert med <= threshold, f"the port's tpe on {name}: median {med} > {threshold}"


@pytest.mark.parametrize("name", HOST_THRESHOLD_DOMAINS + [
    pytest.param(n, marks=pytest.mark.slow)
    for n in T_DOMAINS if n not in HOST_THRESHOLD_DOMAINS])
def test_host_tpe_meets_the_threshold(name):
    threshold = next(iter(T_DOMAINS[name].targets.values()))
    med = median_best(name, H.tpe_host.suggest)
    assert med <= threshold, f"tpe_host on {name}: median {med} > {threshold}"
