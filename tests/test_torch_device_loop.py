"""The port's compiled loop (``hyperopt_tpu_torch.device_loop``) against
the reference's ``hyperopt_tpu.device_loop`` on the CPU.

Both packages run ``compile_fmin`` on the same space, seed and settings
(2-3 dims, 40-64 trials, 10 startup trials), the reference with a jnp
objective and the port with the same objective over tensors.  The
streams must agree trial by trial: ``active`` and every categorical
value equal, continuous values within CONT_RTOL/CONT_ATOL, losses within
LOSS_RTOL/LOSS_ATOL (XLA's and PyTorch's ``log`` differ in the last
bits), and the startup trials bitwise, or within one ulp on log-space
dims.  A stream may part only at a near-tie of the reference's EI argmax;
on these seeds none does, so the whole stream is held.

Also: ``fold_in`` bitwise ``jax.random.fold_in``; the conditional space
with ``joint_ei`` on and off; NaN losses masked and all-failed runs
raising; the early-stop rules' ``n_evals``; warm starts through ``init=``
and ``history_from_trials``; the seed sweep of every algorithm (ATPE and
joint EI included) bitwise each solo run; and the options of later
slices (ASHA, the metrics registry, the mesh) refusing what they cannot
run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import hyperopt_tpu as J
from hyperopt_tpu import hp as jhp
from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
from hyperopt_tpu.device_loop import history_from_trials as j_history_from_trials
import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import convert, hp as thp
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.device_loop import compile_fmin, history_from_trials
from hyperopt_tpu_torch.exceptions import AllTrialsFailed
from hyperopt_tpu_torch.obs import MetricsRegistry
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile

CONT_RTOL, CONT_ATOL = 5e-5, 1e-6
LOSS_RTOL, LOSS_ATOL = 1e-5, 2e-5
N_STARTUP = 10
LOG01 = float(np.log(np.float32(0.1)))


def quad_space(hp):
    return {
        "x": hp.uniform("x", -5.0, 5.0),
        "y": hp.loguniform("y", np.log(1e-3), np.log(10.0)),
        "u": hp.choice("u", [0, 1, 2]),
    }


def j_quad(cfg):
    return (cfg["x"] - 1.0) ** 2 + (jnp.log(cfg["y"]) - LOG01) ** 2 + 0.1 * cfg["u"]


def t_quad(cfg):
    return (cfg["x"] - 1.0) ** 2 + (torch.log(cfg["y"]) - LOG01) ** 2 + 0.1 * cfg["u"]


def cond_space(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-4), np.log(1.0)),
        "arch": hp.choice("arch", [
            {"k": 0, "depth": hp.quniform("depth", 2, 8, 1)},
            {"k": 1, "w": hp.uniform("w", 0.0, 1.0)},
        ]),
    }


def j_cond(cfg, active):
    arm = jnp.where(active["depth"], 0.1 * (cfg["depth"] - 5.0) ** 2,
                    1.0 + (cfg["w"] - 0.5) ** 2)
    return (jnp.log(cfg["lr"]) - float(np.log(np.float32(3e-3)))) ** 2 + arm


def t_cond(cfg, active):
    arm = torch.where(active["depth"], 0.1 * (cfg["depth"] - 5.0) ** 2,
                      1.0 + (cfg["w"] - 0.5) ** 2)
    return (torch.log(cfg["lr"]) - float(np.log(np.float32(3e-3)))) ** 2 + arm


KW = dict(n_startup_jobs=N_STARTUP, n_EI_candidates=16, n_EI_candidates_cat=8)


def _pair(j_fn, t_fn, space, seed=3, **kw):
    """One run of each package on the same settings."""
    j = j_compile_fmin(j_fn, space(jhp), **kw)(seed=seed)
    t = compile_fmin(t_fn, space(thp), device="cpu", **kw)(seed=seed)
    return j, t


def assert_streams_match(j, t, space):
    """The two streams trial by trial (see the module docstring)."""
    ps = t_compile(space(thp), device="cpu")
    jv, ja = np.asarray(j["values"]), np.asarray(j["active"])
    tv, ta = t["values"], t["active"]
    assert jv.shape == tv.shape and j["n_evals"] == t["n_evals"]
    assert np.array_equal(ja, ta)
    cat = np.zeros(ps.n_dims, bool)
    cat[ps.cat_idx] = True
    same = np.where(cat[:, None], tv == jv, np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL))
    assert same.all(), np.argwhere(~same)[:5]
    np.testing.assert_allclose(t["losses"], np.asarray(j["losses"]), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    # startup trials: bitwise, or one ulp where PyTorch's exp makes a log-space value
    n = min(N_STARTUP, jv.shape[1])
    logspace = np.zeros(ps.n_dims, bool)
    logspace[ps.cont_idx] = ps.logspace
    ulp = np.abs(jv[:, :n].view(np.int32).astype(np.int64) - tv[:, :n].view(np.int32))
    assert (np.where(ta[:, :n], ulp, 0) <= np.where(logspace, 1, 0)[:, None]).all()


@pytest.mark.parametrize("seed,data", [(0, 0), (5, 7), (123, 2**31 + 5), (2**32 - 1, 123456)])
def test_fold_in_bitwise(seed, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), data)))
    got = R.fold_in(R.key(seed), data)
    assert np.array_equal(want.astype(np.int64), got.numpy())
    # a device counter folds in the same: tensor data, batched keys
    keys = R.split(R.key(seed), 3)
    batched = R.fold_in(keys, torch.tensor(data, dtype=torch.int64))
    for i in range(3):
        assert torch.equal(batched[i], R.fold_in(keys[i], data))


@pytest.mark.parametrize("algo,batch", [("tpe", 1), ("tpe", 4), ("anneal", 1), ("anneal", 4),
                                        ("rand", 4), ("atpe", 1)])
def test_stream_matches_reference(algo, batch):
    j, t = _pair(j_quad, t_quad, quad_space, max_evals=48, batch_size=batch, algo=algo, **KW)
    assert t["n_evals"] == 48
    assert_streams_match(j, t, quad_space)
    assert t["best_loss"] == pytest.approx(float(t["losses"].min()))


@pytest.mark.parametrize("joint", [False, True])
def test_conditional_space_matches_reference(joint):
    j, t = _pair(j_cond, t_cond, cond_space, max_evals=40, batch_size=4, joint_ei=joint, **KW)
    assert_streams_match(j, t, cond_space)
    labels = sorted(["arch", "depth", "lr", "w"])
    d = {l: i for i, l in enumerate(labels)}
    assert np.array_equal(t["active"][d["depth"]], t["values"][d["arch"]] == 0)
    assert np.array_equal(t["active"][d["w"]], t["values"][d["arch"]] == 1)
    assert ("depth" in t["best"]) != ("w" in t["best"])


def test_nan_losses_are_masked():
    def j_obj(cfg):
        return jnp.where(cfg["x"] < -2.0, jnp.nan, (cfg["x"] - 1.0) ** 2)

    def t_obj(cfg):
        return torch.where(cfg["x"] < -2.0, torch.nan, (cfg["x"] - 1.0) ** 2)

    space = lambda hp: {"x": hp.uniform("x", -5.0, 5.0)}  # noqa: E731
    j, t = _pair(j_obj, t_obj, space, seed=0, max_evals=48, **KW)
    assert np.isnan(t["losses"]).any() and np.isfinite(t["best_loss"])
    assert_streams_match(j, t, space)
    trials = compile_fmin(t_obj, space(thp), max_evals=24, device="cpu", **KW)(
        seed=0, return_trials=True)["trials"]
    assert set(trials.statuses()) == {"ok", "fail"}


def test_all_failed_raises_and_unknown_algo_is_rejected():
    space = {"x": thp.uniform("x", -1.0, 1.0)}
    runner = compile_fmin(lambda cfg: torch.full_like(cfg["x"], torch.nan), space,
                          max_evals=12, device="cpu", **KW)
    with pytest.raises(AllTrialsFailed):
        runner(seed=0)
    with pytest.raises(ValueError, match="unknown algo"):
        compile_fmin(t_quad, quad_space(thp), max_evals=8, algo="random", device="cpu")
    with pytest.raises(ValueError, match="joint"):
        compile_fmin(t_quad, quad_space(thp), max_evals=8, algo="atpe", joint_ei=True,
                     device="cpu")
    with pytest.raises(ValueError, match="no_progress_steps"):
        compile_fmin(t_quad, quad_space(thp), max_evals=8, no_progress_steps=0, device="cpu")


@pytest.mark.parametrize("rule", [dict(loss_threshold=0.5), dict(no_progress_steps=3)])
def test_early_stop_matches_reference(rule):
    j, t = _pair(j_quad, t_quad, quad_space, seed=0, max_evals=96, batch_size=4, **rule, **KW)
    assert t["n_evals"] == j["n_evals"] < 96
    assert len(t["losses"]) == t["n_evals"]
    assert_streams_match(j, t, quad_space)
    # an unreachable threshold runs the whole budget: the flat run's stream
    full = compile_fmin(t_quad, quad_space(thp), max_evals=48, batch_size=4, device="cpu",
                        loss_threshold=-1.0, **KW)(seed=0)
    flat = compile_fmin(t_quad, quad_space(thp), max_evals=48, batch_size=4, device="cpu",
                        **KW)(seed=0)
    assert full["n_evals"] == 48
    for f in ("values", "active", "losses"):
        assert np.array_equal(full[f], flat[f]), f


@pytest.fixture(scope="module")
def warm_runners():
    """One warm-startable runner of each package, shared by the warm-start
    tests (the reference's compile is most of their time)."""
    kw = dict(max_evals=24, batch_size=4, warm_capacity=64, **KW)
    return (j_compile_fmin(j_quad, quad_space(jhp), **kw),
            compile_fmin(t_quad, quad_space(thp), device="cpu", **kw))


def test_warm_start_through_init_matches_reference(warm_runners):
    j_run, t_run = warm_runners
    j_first = j_run(seed=0)
    t_first = t_run(seed=0, init=None)
    assert_streams_match(j_first, t_first, quad_space)
    # both second legs start from the reference's first leg
    j2 = j_run(seed=1, init=j_first)
    t2 = t_run(seed=1, init=convert.device_loop_result_from_numpy(j_first))
    assert t2["n_total"] == 48 and t2["n_evals"] == 24
    assert_streams_match(j2, t2, quad_space)
    np.testing.assert_array_equal(t2["losses"][:24], np.asarray(j_first["losses"]))
    with pytest.raises(ValueError, match="warm_capacity"):
        t_run(seed=2, init={k: np.concatenate([t2[k]] * 2, axis=-1)
                            for k in ("values", "active", "losses")})


def test_history_from_trials_warm_start_matches_reference(warm_runners):
    def host_obj(cfg):
        return (cfg["x"] - 1.0) ** 2 + (np.log(cfg["y"]) - LOG01) ** 2 + 0.1 * cfg["u"]

    jt = J.Trials()
    J.fmin(host_obj, quad_space(jhp), algo=J.rand.suggest, max_evals=20, trials=jt,
           rstate=np.random.default_rng(0), show_progressbar=False)
    jt._dynamic_trials[3]["result"]["loss"] = float("nan")  # never enters
    jt.refresh()
    j_hist = j_history_from_trials(quad_space(jhp), jt)
    t_hist = history_from_trials(quad_space(thp), jt)
    for k in ("values", "active", "losses"):
        np.testing.assert_array_equal(t_hist[k], np.asarray(j_hist[k]))
    assert t_hist["losses"].shape == (19,)
    j_run, t_run = warm_runners
    j = j_run(seed=0, init=j_hist)
    t = t_run(seed=0, init=t_hist)
    assert t["n_total"] == 43
    assert_streams_match(j, t, quad_space)


# "joint" is algo="tpe" with joint_ei=True
SWEEP_ALGOS = {"tpe": {}, "anneal": {"algo": "anneal"}, "rand": {"algo": "rand"},
               "atpe": {"algo": "atpe"}, "joint": {"joint_ei": True}}


@pytest.mark.parametrize("algo", ["tpe", "anneal", "rand", "atpe", "joint"])
def test_seed_sweep_is_bitwise_each_solo_run(algo):
    runner = compile_fmin(t_quad, quad_space(thp), max_evals=32, batch_size=2,
                          device="cpu", **SWEEP_ALGOS[algo], **KW)
    swept = runner(seed=[3, 4, 5])
    assert isinstance(swept, list) and len(swept) == 3
    for seed, out in zip((3, 4, 5), swept):
        single = runner(seed=seed)
        for f in ("values", "active", "losses"):
            assert np.array_equal(out[f], single[f]), (seed, f)
        assert out["best"] == single["best"]
    with pytest.raises(ValueError, match="single-seed"):
        runner(seed=[1, 2], init=swept[0])


def test_seed_sweep_with_early_stop_and_the_axes_not_ported():
    """Early stop in a sweep, for the factorized TPE body and for the two
    bodies that gained their seed axis last (ATPE and joint EI, on the
    conditional space): each seed stops where its solo run stops."""
    cases = ((t_quad, quad_space, {}), (t_cond, cond_space, dict(algo="atpe")),
             (t_cond, cond_space, dict(joint_ei=True)))
    for fn, space, kw in cases:
        runner = compile_fmin(fn, space(thp), max_evals=48, batch_size=1,
                              loss_threshold=0.3, device="cpu", **kw, **KW)
        for seed, out in zip((0, 1), runner(seed=[0, 1])):
            single = runner(seed=seed)
            assert out["n_evals"] == single["n_evals"], kw
            assert np.array_equal(out["values"], single["values"]), kw
            assert np.array_equal(out["losses"], single["losses"]), kw


@pytest.mark.parametrize("option,value,item", [
    ("asha", {"eta": 2}, "14"), ("artifact_callback", print, "14"),
    ("mesh", object(), "15"), ("cand_axis", "cand", "15"),
    ("metrics_registry", MetricsRegistry("dl"), "16"),
])
def test_deferred_options_raise(option, value, item):
    """The options of items 14, 15 and 16 are ported, and without what
    they need they raise as the reference does: ASHA needs a
    ``TrainableObjective``, the artifact stream needs ``asha=``, the
    registry's progress rows need ``chunk_size``, ``cand_axis`` needs a
    mesh, and ``mesh`` must be a ``RankMesh`` (where the reference needs a
    ``jax.sharding.Mesh``); ``tests/test_torch_device_loop_mesh.py`` runs
    the mesh options against the reference."""
    if item in ("14", "16"):
        with pytest.raises(ValueError, match="TrainableObjective|requires asha=|chunk_size"):
            compile_fmin(t_quad, quad_space(thp), max_evals=8, device="cpu", **{option: value})
        return
    with pytest.raises((TypeError, ValueError), match="RankMesh|requires a mesh"):
        compile_fmin(t_quad, quad_space(thp), max_evals=8, device="cpu", **{option: value})
