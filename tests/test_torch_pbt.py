"""The port's Population-Based Training (``hyperopt_tpu_torch.pbt``)
against the reference's ``hyperopt_tpu.pbt`` on the CPU.

Both packages run ``compile_pbt`` on a ``train_fn`` written once for jnp
and torch.  The log-space hypers of every round's exploit/explore event
are bitwise (compared through ``exp``, which numpy applies alike to
both); the losses agree within LOSS_RTOL: XLA's and PyTorch's ``exp`` of
a hyper may differ in the last bit, and training carries it.  A NaN
member ranks last in both (``jnp.argsort`` and a stable
``torch.argsort`` sort NaN to the end), ties keep member order; a resume
(``init=``) from the reference's own result continues bitwise in the
hypers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.pbt import compile_pbt as j_compile_pbt
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch.parallel.mesh import TRIAL_AXIS, virtual_mesh
from hyperopt_tpu_torch.pbt import compile_pbt

LOSS_RTOL = 1e-5
BOUNDS = {"lr": (1e-3, 1.5), "wd": (1e-5, 1e-1)}


def quad_train_fn(state, hypers, key):
    """theta' = theta - lr * 2 (theta - 0.7) - wd * theta: the same ops
    over jnp or torch; lr > 1 diverges."""
    theta = state["theta"]
    theta = theta - hypers["lr"] * 2.0 * (theta - 0.7) - hypers["wd"] * theta
    return {"theta": theta}, (theta - 0.7) ** 2


def nan_train_fn(state, hypers, key):
    """Members whose lr passes 0.2 report NaN: they must rank last."""
    st, losses = quad_train_fn(state, hypers, key)
    keep = hypers["lr"] < 0.2
    return st, losses * keep / keep  # 0 / False is NaN


def j_mesh(n):
    """The reference's ``trial`` mesh over the first ``n`` forced host
    devices."""
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (TRIAL_AXIS,))


def _both(train_fn, P=8, seed=3, init=None, **kw):
    theta0 = np.linspace(2.0, 5.0, P).astype(np.float32)
    opts = dict(pop_size=P, exploit_every=3, n_rounds=6, **kw)
    j_run = j_compile_pbt(train_fn, {"theta": jnp.asarray(theta0)}, BOUNDS, **opts)
    t_run = compile_pbt(train_fn, {"theta": theta0}, BOUNDS, device="cpu", **opts)
    return j_run, t_run


def _hypers(out):
    return np.stack([np.asarray(out["hypers"][n]) for n in sorted(BOUNDS)], axis=1)


def assert_match(j, t):
    np.testing.assert_array_equal(_hypers(t), _hypers(j))
    np.testing.assert_allclose(t["loss_history"], np.asarray(j["loss_history"]),
                               rtol=LOSS_RTOL, atol=1e-12)
    assert t["best_index"] == j["best_index"]
    assert t["n_steps"] == j["n_steps"]


@pytest.mark.parametrize("quantile", [0.25, 0.5])
def test_pbt_matches_the_reference(quantile):
    j_run, t_run = _both(quad_train_fn, exploit_quantile=quantile)
    j, t = j_run(seed=3), t_run(seed=3)
    assert_match(j, t)
    lo, hi = np.float32([BOUNDS[n] for n in sorted(BOUNDS)]).T
    assert ((_hypers(t) >= lo * (1 - 1e-6)) & (_hypers(t) <= hi * (1 + 1e-6))).all()
    # seed-deterministic and reusable
    again = t_run(seed=3)
    np.testing.assert_array_equal(again["loss_history"], t["loss_history"])
    assert not np.array_equal(t_run(seed=4)["loss_history"], t["loss_history"])


def test_pbt_nan_members_rank_last_as_in_the_reference():
    j_run, t_run = _both(nan_train_fn)
    j, t = j_run(seed=1), t_run(seed=1)
    assert not np.isfinite(t["loss_history"]).all()  # NaN members existed
    np.testing.assert_array_equal(_hypers(t), _hypers(j))
    np.testing.assert_array_equal(np.isfinite(t["loss_history"]),
                                  np.isfinite(np.asarray(j["loss_history"])))
    assert t["best_index"] == j["best_index"]
    assert np.isfinite(t["best_loss"])


def test_pbt_resume_from_the_references_result():
    j_run, t_run = _both(quad_train_fn)
    j1 = j_run(seed=2)
    j2 = j_run(seed=2, init=j1)
    carried = convert.pbt_result_from_numpy(jax.tree.map(np.asarray, j1), device="cpu")
    t2 = t_run(seed=2, init=carried)
    assert_match(j2, t2)
    # the port's own resume continues its own run the same way
    t1 = t_run(seed=2)
    own = t_run(seed=2, init=t1)
    np.testing.assert_array_equal(_hypers(own), _hypers(t2))


def test_pbt_exploit_copies_params_from_the_top():
    """Linear dynamics (theta' = theta - lr, loss = theta'): after one
    round exactly the bottom member holds the top member's value."""

    def linear(state, hypers, key):
        theta = state["theta"] - hypers["lr"]
        return {"theta": theta}, theta

    P = 8
    out = compile_pbt(linear, {"theta": np.zeros(P, np.float32)}, {"lr": (1e-3, 1.0)},
                      pop_size=P, exploit_every=2, n_rounds=1, exploit_quantile=0.125,
                      device="cpu")(seed=0)
    theta = out["state"]["theta"].numpy()
    vals, counts = np.unique(theta, return_counts=True)
    assert counts.max() == 2 and vals[counts == 2][0] == theta.min()


def test_pbt_refusals():
    init = {"theta": np.zeros(8, np.float32)}
    # the sharding options fail as the reference's do, with its texts
    for n_shards, mode, match in ((None, "shard_map", "requires mesh"),
                                  (4, "nonsense", "shard_mode"), (3, "shard_map", "divide")):
        t_mesh = None if n_shards is None else virtual_mesh(n_shards, TRIAL_AXIS)
        with pytest.raises(ValueError, match=match) as t_err:
            compile_pbt(quad_train_fn, init, BOUNDS, 8, mesh=t_mesh, trial_axis=TRIAL_AXIS,
                        shard_mode=mode, device="cpu")
        with pytest.raises(ValueError, match=match) as j_err:
            j_compile_pbt(quad_train_fn, {"theta": jnp.zeros(8, jnp.float32)}, BOUNDS, 8,
                          mesh=None if n_shards is None else j_mesh(n_shards),
                          trial_axis=TRIAL_AXIS, shard_mode=mode)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="overlap"):
        compile_pbt(quad_train_fn, init, BOUNDS, 8, exploit_quantile=0.75, device="cpu")
    with pytest.raises(ValueError, match="0 < low < high"):
        compile_pbt(quad_train_fn, init, {"lr": (0.0, 1.0)}, 8, device="cpu")
    runner = compile_pbt(quad_train_fn, init, BOUNDS, 8, n_rounds=1, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        runner(init={"state": init, "hypers": {"lr": np.ones(8)}})
    with pytest.raises(ValueError, match="cover"):
        runner(init={"state": init, "hypers": {"lr": np.ones(4), "wd": np.ones(4)}})
    assert torch.is_tensor(runner(seed=0)["state"]["theta"])


@pytest.mark.slow
@pytest.mark.parametrize("seed", [5, 6])
def test_pbt_matches_the_reference_on_more_seeds(seed):
    j_run, t_run = _both(quad_train_fn, P=16)
    assert_match(j_run(seed=seed), t_run(seed=seed))
