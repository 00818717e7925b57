"""The port's schedulers (``hyperopt_tpu_torch.hyperband``) against the
reference's ``hyperopt_tpu.hyperband`` on the CPU.

* ``rung_schedule`` equal, ``rung_rank`` bitwise on NaN, +-inf and ties;
* ``compile_sha`` (one and two replicas) and ``compile_hyperband`` on the
  reference tests' quadratic ``train_fn``, written once for both
  packages: the rung orders and the log-space hypers bitwise (read from
  both packages' rung snapshots), the losses within LOSS_RTOL (XLA's and
  PyTorch's ``exp`` of a hyper differ in the last bit); a kill between
  rungs, and a crash at every rung-boundary crash point of the file
  seam, resumes bitwise;
* the host drivers with the default host random search: the trial docs
  and the best bitwise; resume at every kill point bitwise; with the
  port's ``tpe.suggest`` against ``tpe_jax.suggest`` the streams agree
  within CONT_RTOL (no near-tie on this seed); ``budget_aware`` filters
  as the reference does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import hyperopt_tpu as J
from hyperopt_tpu import hyperband as JH
from hyperopt_tpu import rand as j_rand, tpe_jax
from hyperopt_tpu.base import Domain as JDomain
from hyperopt_tpu.models.synthetic import budgeted_quadratic_space as j_space
import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import convert, hyperband as TH
from hyperopt_tpu_torch import rand_host, random as R, tpe as t_tpe
from hyperopt_tpu_torch.base import Domain as TDomain
from hyperopt_tpu_torch.distributed.faults import (CHECKPOINT_CRASH_POINTS, SHA_CRASH_POINTS,
                                                   FaultPlan, SimulatedCrash)
from hyperopt_tpu_torch.models.synthetic import budgeted_quadratic_fn
from hyperopt_tpu_torch.models.synthetic import budgeted_quadratic_space as t_space
from hyperopt_tpu_torch.parallel.mesh import virtual_mesh

# a hyper's exp differs by an ulp between XLA and PyTorch; 16 steps of
# the quadratic carry it to some 1e-6 relative in a loss
LOSS_RTOL = 1e-5
CONT_RTOL = 5e-5


def quad_train_fn(state, hypers, key):
    """theta' = theta - lr * 2 (theta - 0.7): the same ops over jnp or torch."""
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
    return {"theta": theta}, (theta - 0.7) ** 2


# ---------------------------------------------------------------------------
# the shared ladder and ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(8, 2, None, 1), (8, 2, 3, 1), (27, 3, None, 2), (9, 3, 1, 5)])
def test_rung_schedule_equals_the_reference(args):
    assert TH.rung_schedule(*args) == JH.rung_schedule(*args)


@pytest.mark.parametrize("args", [(6, 2), (8, 1), (8, 2, 5)])
def test_rung_schedule_refuses_what_the_reference_refuses(args):
    for mod in (TH, JH):
        with pytest.raises(ValueError):
            mod.rung_schedule(*args)


@pytest.mark.parametrize("replicas,p_live", [(1, 8), (2, 4), (3, 5)])
def test_rung_rank_bitwise_on_nan_inf_and_ties(replicas, p_live):
    rng = np.random.default_rng(replicas * 10 + p_live)
    losses = rng.choice(np.float32([0.5, 0.25, 1.0, np.nan, np.inf, -np.inf, 0.25]),
                        size=replicas * p_live).astype(np.float32)
    want = np.asarray(JH.rung_rank(jnp.asarray(losses), replicas, p_live))
    got = TH.rung_rank(torch.from_numpy(losses), replicas, p_live)
    np.testing.assert_array_equal(got.numpy(), want)
    # non-finite keys last; ties by member order within each bracket
    keyed = np.where(np.isfinite(losses), losses, np.inf).reshape(replicas, p_live)
    stable = np.argsort(keyed, axis=1, kind="stable") + np.arange(replicas)[:, None] * p_live
    np.testing.assert_array_equal(got.numpy(), stable)


# ---------------------------------------------------------------------------
# compile_sha / compile_hyperband
# ---------------------------------------------------------------------------

def _snapshot(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("replicas", [1, 2])
def test_compile_sha_rung_orders_and_hypers_bitwise(replicas, tmp_path):
    P = 8
    init = np.linspace(-2.0, 3.0, replicas * P).astype(np.float32)
    kw = dict(n_configs=P, eta=2, steps_per_rung=2, replicas=replicas)
    bounds = {"lr": (1e-3, 1.2), "wd": (1e-4, 1e-1)}
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j = JH.compile_sha(quad_train_fn, {"theta": jnp.asarray(init)}, bounds, **kw)(
        seed=4, checkpoint=j_path)
    t = TH.compile_sha(quad_train_fn, {"theta": init}, bounds, device="cpu", **kw)(
        seed=4, checkpoint=t_path)
    js, ts = _snapshot(j_path), _snapshot(t_path)
    assert sorted(js) == sorted(ts)  # the reference's key layout
    for k in js:
        if "order" in k or k in ("['meta']", "['log_h']"):
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        else:
            np.testing.assert_allclose(ts[k], js[k], rtol=LOSS_RTOL, err_msg=k)
    assert t["best_index"] == j["best_index"]
    assert t["best_hypers"] == j["best_hypers"]
    np.testing.assert_allclose([r["best_loss"] for r in t["rungs"]],
                               [r["best_loss"] for r in j["rungs"]], rtol=LOSS_RTOL)
    np.testing.assert_allclose(t["replica_bests"], j["replica_bests"], rtol=LOSS_RTOL)
    # a rerun resumes from the finished snapshot with no training at all
    again = TH.compile_sha(quad_train_fn, {"theta": init}, bounds, device="cpu", **kw)(
        seed=4, checkpoint=t_path)
    assert again["rungs"] == t["rungs"] and again["best_hypers"] == t["best_hypers"]
    # the reference's result carried over starts the port from its weights
    carried = convert.sha_result_from_numpy(jax.tree.map(np.asarray, j), device="cpu")
    np.testing.assert_allclose(carried["state"]["theta"].numpy(), t["state"]["theta"].numpy(),
                               rtol=LOSS_RTOL, atol=1e-7)


class _KillableTrain:
    """``quad_train_fn`` that raises ``KeyboardInterrupt`` at its N-th call
    while armed (one class, so the killed and the resumed run share the
    runner)."""

    def __init__(self):
        self.kill_at = None
        self.calls = 0

    def __call__(self, state, hypers, key):
        self.calls += 1
        if self.kill_at is not None and self.calls == self.kill_at:
            self.kill_at = None
            raise KeyboardInterrupt
        return quad_train_fn(state, hypers, key)


def test_compile_sha_kill_between_rungs_resumes_bitwise(tmp_path):
    train = _KillableTrain()
    init = {"theta": np.linspace(-1.0, 2.0, 8).astype(np.float32)}
    runner = TH.compile_sha(train, init, {"lr": (1e-3, 1.0)}, n_configs=8, eta=2,
                            steps_per_rung=1, device="cpu")
    ref = runner(seed=1)
    # the ladder trains 1 + 2 + 4 + 8 steps; kill inside rungs 1, 2 and 3
    for kill_at in (2, 4, 9):
        path = str(tmp_path / f"k{kill_at}.npz")
        train.calls, train.kill_at = 0, kill_at
        with pytest.raises(KeyboardInterrupt):
            runner(seed=1, checkpoint=path)
        out = runner(seed=1, checkpoint=path)
        assert out["rungs"] == ref["rungs"] and out["best_index"] == ref["best_index"]
        assert torch.equal(out["state"]["theta"], ref["state"]["theta"])
        with pytest.raises(ValueError, match="refusing to resume"):
            runner(seed=2, checkpoint=path)


@pytest.mark.parametrize("at", [1, 2, 3, 4])
@pytest.mark.parametrize("point", SHA_CRASH_POINTS + CHECKPOINT_CRASH_POINTS)
def test_compile_sha_crash_at_every_rung_boundary_resumes_bitwise(point, at, tmp_path):
    """The 4-rung ladder's snapshots go through the ``fs=`` seam: a crash
    before a rung's snapshot, inside its torn-publish window or after it
    resumes from the last published snapshot to the uncrashed run's bits."""
    init = {"theta": np.linspace(-1.0, 2.0, 8).astype(np.float32)}
    plan = FaultPlan(seed=0)
    runner = TH.compile_sha(quad_train_fn, init, {"lr": (1e-3, 1.0)}, n_configs=8, eta=2,
                            steps_per_rung=1, device="cpu", fs=plan.fs())
    ref = runner(seed=1)
    path = str(tmp_path / "sha.npz")
    plan.arm(point, at=at)
    with pytest.raises(SimulatedCrash):
        runner(seed=1, checkpoint=path)
    out = runner(seed=1, checkpoint=path)
    assert out["rungs"] == ref["rungs"] and out["best_hypers"] == ref["best_hypers"]
    assert out["best_index"] == ref["best_index"]
    assert torch.equal(out["state"]["theta"], ref["state"]["theta"])


def test_compile_hyperband_matches_the_reference(tmp_path):
    kw = dict(s_max=2, eta=2, steps_per_rung=1, replicas=2)
    bounds = {"lr": (1e-3, 1.2)}
    j = JH.compile_hyperband(quad_train_fn,
                             lambda k, n: {"theta": 3.0 * jax.random.uniform(k, (n,))},
                             bounds, **kw)(seed=3)
    t_run = TH.compile_hyperband(quad_train_fn, lambda k, n: {"theta": 3.0 * R.uniform(k, (n,))},
                                 bounds, device="cpu", **kw)
    t = t_run(seed=3)
    assert t["best_bracket"] == j["best_bracket"]
    assert t["best_hypers"] == j["best_hypers"]
    for tb, jb in zip(t["brackets"], j["brackets"]):
        assert (tb["s"], tb["n_configs"]) == (jb["s"], jb["n_configs"])
        np.testing.assert_allclose(tb["replica_bests"], jb["replica_bests"], rtol=LOSS_RTOL,
                                   atol=1e-12)
    durable = t_run(seed=3, checkpoint=str(tmp_path / "hb"))
    assert durable["brackets"] == t["brackets"]
    assert t_run(seed=3, checkpoint=str(tmp_path / "hb"))["brackets"] == t["brackets"]


def test_compile_sha_validates_and_refuses_sharding():
    init = {"theta": np.zeros(8, np.float32)}
    with pytest.raises(ValueError, match="replicas"):
        TH.compile_sha(quad_train_fn, init, {"lr": (1e-3, 1.0)}, 8, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="leading dim"):
        TH.compile_sha(quad_train_fn, init, {"lr": (1e-3, 1.0)}, 8, replicas=2, device="cpu")
    with pytest.raises(ValueError, match="power of eta"):
        TH.compile_sha(quad_train_fn, {"theta": np.zeros(6, np.float32)}, {"lr": (1e-3, 1.0)},
                       6, device="cpu")
    # the sharding options fail as the reference's do, with its texts
    for n_shards, mode, match in ((None, "shard_map", "requires mesh"),
                                  (4, "nonsense", "shard_mode")):
        with pytest.raises(ValueError, match=match) as t_err:
            TH.compile_sha(quad_train_fn, init, {"lr": (1e-3, 1.0)}, 8, shard_mode=mode,
                           mesh=None if n_shards is None else virtual_mesh(n_shards, "trial"),
                           device="cpu")
        with pytest.raises(ValueError, match=match) as j_err:
            JH.compile_sha(quad_train_fn, {"theta": jnp.zeros(8, jnp.float32)},
                           {"lr": (1e-3, 1.0)}, 8, shard_mode=mode,
                           mesh=None if n_shards is None else Mesh(
                               np.asarray(jax.devices()[:n_shards]), ("trial",)))
        assert str(t_err.value) == str(j_err.value)
    # compile_hyperband's mesh= still waits for its item
    with pytest.raises(NotImplementedError, match="item 15"):
        TH.compile_hyperband(quad_train_fn, lambda key, n: init, {"lr": (1e-3, 1.0)}, 1,
                             mesh=virtual_mesh(2, "trial"), device="cpu")
    # a callable init that takes the seed sees the runner's seed
    seen = []
    runner = TH.compile_sha(quad_train_fn, lambda seed: seen.append(seed) or init,
                            {"lr": (1e-3, 1.0)}, 8, steps_per_rung=1, device="cpu")
    runner(seed=7)
    assert seen == [7]


# ---------------------------------------------------------------------------
# host drivers
# ---------------------------------------------------------------------------

class _KillableQuad:
    """budgeted_quadratic_fn with a kill switch at call N (a class: the
    checkpoint guard fingerprints the objective)."""

    def __init__(self, kill_at=None):
        self.kill_at = kill_at
        self.calls = 0

    def __call__(self, cfg, budget):
        self.calls += 1
        if self.kill_at is not None and self.calls == self.kill_at:
            raise KeyboardInterrupt
        return budgeted_quadratic_fn(cfg, budget)


def _docs(trials):
    return [(d["tid"], d["misc"]["vals"], d["result"]) for d in trials.trials]


def _digest(out):
    return (out["best_loss"], out["best"], _docs(out["trials"]),
            out.get("rungs"), out.get("brackets"))


DRIVERS = {
    "sha": lambda mod, fn, **kw: mod.successive_halving(fn, **kw, max_budget=9, eta=3),
    "hyperband": lambda mod, fn, **kw: mod.hyperband(fn, **kw, max_budget=9, eta=3),
    "asha": lambda mod, fn, **kw: mod.asha(fn, **kw, max_budget=9, eta=3, max_jobs=30,
                                           workers=1),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_host_driver_docs_and_best_bitwise(driver):
    from hyperopt_tpu.models.synthetic import budgeted_quadratic_fn as j_fn

    run = DRIVERS[driver]
    j = run(JH, j_fn, space=j_space(), rstate=np.random.default_rng(0))
    t = run(TH, budgeted_quadratic_fn, space=t_space(), rstate=np.random.default_rng(0),
            device="cpu")
    assert _digest(t) == _digest(j)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_host_driver_resume_at_every_kill_point_is_bitwise(driver, tmp_path):
    run = DRIVERS[driver]
    kw = dict(space=t_space(), device="cpu")
    ref = _digest(run(TH, _KillableQuad(), rstate=np.random.default_rng(5), **kw))
    n_evals = len(ref[2])
    for kill_at in range(1, n_evals + 1):
        path = str(tmp_path / f"{driver}-{kill_at}.ckpt")
        with pytest.raises(KeyboardInterrupt):
            run(TH, _KillableQuad(kill_at), rstate=np.random.default_rng(5), checkpoint=path,
                **kw)
        resumed = run(TH, _KillableQuad(), rstate=np.random.default_rng(5), checkpoint=path,
                      **kw)
        assert _digest(resumed) == ref, kill_at
    # another seed (sha, hyperband) or another job budget (asha) is refused
    with pytest.raises(ValueError, match="refusing to resume"):
        if driver == "asha":
            TH.asha(_KillableQuad(), max_budget=9, eta=3, max_jobs=31, workers=1,
                    checkpoint=path, **kw)
        else:
            run(TH, _KillableQuad(), rstate=np.random.default_rng(6), checkpoint=path, **kw)


def smooth_quad(cfg, budget):
    """A noise-free budgeted quadratic: no loss sits on a near-tie."""
    return (cfg["x"] - 3.0) ** 2 + 1.0 / budget


def test_asha_with_the_ports_tpe_on_the_device_path_matches_tpe_jax():
    """Rung-0 asks through the port's device TPE (here on the CPU) and
    through tpe_jax: 40 jobs, the model regime from the 21st ask; the
    configs agree within CONT_RTOL and the promotions equal."""
    kw = dict(max_budget=9, eta=3, max_jobs=40, workers=1)
    jt, tt = J.Trials(), H.Trials()
    JH.asha(smooth_quad, j_space(), algo=tpe_jax.suggest, trials=jt,
            rstate=np.random.default_rng(2), **kw)
    TH.asha(smooth_quad, t_space(), algo=t_tpe.suggest, trials=tt,
            rstate=np.random.default_rng(2), device="cpu", **kw)
    assert [d["result"]["budget"] for d in tt.trials] == [d["result"]["budget"]
                                                          for d in jt.trials]
    np.testing.assert_allclose([d["misc"]["vals"]["x"][0] for d in tt.trials],
                               [d["misc"]["vals"]["x"][0] for d in jt.trials], rtol=CONT_RTOL)
    assert sum(d["result"]["budget"] == 1 for d in tt.trials) > 20  # TPE's model regime ran


def test_budget_aware_filters_as_the_reference():
    seen = {"j": [], "t": []}

    def recorder(which, suggest):
        def algo(new_ids, domain, trials, seed, **kw):
            seen[which].append(sorted(t["result"]["budget"] for t in trials.trials
                                      if t.get("result")))
            return suggest(new_ids, domain, trials, seed)
        return algo

    for which, mod, Tr, Dom, sugg, space in (
            ("j", JH, J.Trials, JDomain, j_rand.suggest, j_space()),
            ("t", TH, H.Trials, TDomain, rand_host.suggest, t_space())):
        kw = {} if which == "j" else {"device": "cpu"}
        domain = Dom(lambda cfg: 0.0, space, **kw)
        trials = Tr()
        docs = sugg(trials.new_trial_ids(12), domain, trials, seed=0)
        for i, d in enumerate(docs):
            d["state"] = 2
            d["result"] = {"status": "ok", "loss": float(i), "budget": 1 if i < 9 else 3}
        trials.insert_trial_docs(docs)
        trials.refresh()
        algo = mod.budget_aware(recorder(which, sugg), min_obs=8)
        algo(trials.new_trial_ids(1), domain, trials, seed=1)
        more = sugg(trials.new_trial_ids(6), domain, trials, seed=2)
        for d in more:
            d["state"] = 2
            d["result"] = {"status": "ok", "loss": 1.0, "budget": 3}
        trials.insert_trial_docs(more)
        trials.refresh()
        algo(trials.new_trial_ids(1), domain, trials, seed=3)
        algo(Tr().new_trial_ids(1), domain, Tr(), seed=4)
    assert seen["t"] == seen["j"] == [[1] * 9, [3] * 9, []]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2])
def test_host_drivers_match_on_more_seeds(seed):
    from hyperopt_tpu.models.synthetic import budgeted_quadratic_fn as j_fn

    for driver in sorted(DRIVERS):
        run = DRIVERS[driver]
        j = run(JH, j_fn, space=j_space(), rstate=np.random.default_rng(seed))
        t = run(TH, budgeted_quadratic_fn, space=t_space(), rstate=np.random.default_rng(seed),
                device="cpu")
        assert _digest(t) == _digest(j), driver
