"""The port's chunked compiled loop, its checkpoints, the trainable
objectives and ``fmin(compiled=True)``, on the CPU.

* a chunked run (``chunk_size``) is bitwise the flat run, a padded tail
  chunk included, and the progress rows, with the callback on or off,
  change nothing and equal the reference's rows;
* a kill at every chunk boundary (both compiled-loop crash points, and
  the checkpoint's torn-publish window) resumes bitwise, through the
  port's ``FaultyFS``; a foreign seed or experiment and a corrupt bundle
  are refused with ``CheckpointError``;
* ``mlp_tune_objective`` teacher-forced against the reference's: the
  same configurations, keys and initial state train to per-trial losses
  within TRAIN_RTOL (XLA's and PyTorch's matrix products sum in other
  orders); the compiled run is deterministic and bitwise across a kill
  and resume;
* ``fmin(compiled=True)`` returns a standard ``Trials`` and the argmin.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import hyperopt_tpu as J
from hyperopt_tpu import hp as jhp
from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
from hyperopt_tpu.models.synthetic import (cond_tune_objective as j_cond_tune,
                                           cond_tune_space as j_cond_tune_space,
                                           mlp_tune_objective as j_mlp_tune)
import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import convert, hp as thp
from hyperopt_tpu_torch.device_loop import TrainableObjective, compile_fmin, fmin_on_device
from hyperopt_tpu_torch.distributed.faults import (DEVICE_LOOP_CRASH_POINTS, FaultPlan,
                                                   SimulatedCrash)
from hyperopt_tpu_torch.exceptions import CheckpointError
from hyperopt_tpu_torch.fmin import _compiled_algo_name
from hyperopt_tpu_torch.models.synthetic import (cond_tune_objective, cond_tune_space,
                                                 mlp_tune_objective, mlp_tune_space)

# per-trial losses after 8 epochs of the same training in both packages
# (measured at most 2e-7 relative)
TRAIN_RTOL = 1e-5

N_EVALS = 24
BATCH = 2  # 12 steps; chunk_size=8 -> 4-step chunks, 3 chunks
KW = dict(max_evals=N_EVALS, batch_size=BATCH, n_startup_jobs=4, n_EI_candidates=8,
          n_EI_candidates_cat=4)
SEED = 5


def space(hp):
    return {"x": hp.uniform("x", -5.0, 5.0), "u": hp.choice("u", [0, 1, 2])}


def objective(cfg):  # (x - 1)^2 + u / 10: the same ops over jnp or torch
    return (cfg["x"] - 1.0) ** 2 + 0.1 * cfg["u"]


@functools.lru_cache(maxsize=None)
def flat_result():
    return compile_fmin(objective, space(thp), device="cpu", **KW)(seed=SEED)


def assert_stream_equal(a, b):
    """The whole result stream, bitwise."""
    for f in ("losses", "values", "active"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert a["best_loss"] == b["best_loss"]
    assert a["best_index"] == b["best_index"]
    assert a["best"] == b["best"]


@pytest.mark.parametrize("chunk_size", [8, 5])
def test_chunked_is_bitwise_the_flat_run(chunk_size):
    # chunk_size=5: 3-step chunks, 4 chunks over 12 steps, the last padded
    runner = compile_fmin(objective, space(thp), chunk_size=chunk_size, device="cpu", **KW)
    out = runner(seed=SEED)
    assert out["n_evals"] == N_EVALS
    assert runner._chunk_geometry["n_chunks"] == (3 if chunk_size == 8 else 4)
    assert_stream_equal(flat_result(), out)


def test_progress_rows_change_nothing_and_equal_the_reference_rows():
    rows, j_rows = [], []
    runner = compile_fmin(objective, space(thp), chunk_size=8, progress_callback=rows.append,
                          progress_every=2, device="cpu", **KW)
    out = runner(seed=SEED)
    assert_stream_equal(flat_result(), out)
    assert [r["chunk"] for r in rows] == [1, 2]
    assert [r["trials_done"] for r in rows] == [16, 24]
    assert rows[-1]["best_loss"] == out["best_loss"]
    j_compile_fmin(objective, space(jhp), chunk_size=8, progress_callback=j_rows.append,
                   progress_every=2, **KW)(seed=SEED)
    assert [(r["chunk"], r["trials_done"]) for r in rows] == [
        (r["chunk"], r["trials_done"]) for r in j_rows]
    np.testing.assert_allclose([r["best_loss"] for r in rows],
                               [r["best_loss"] for r in j_rows], rtol=1e-5)
    rows.clear()
    runner(seed=SEED)  # a second run fires the cadence again
    assert [r["chunk"] for r in rows] == [1, 2]


def test_kill_and_resume_at_every_chunk_boundary_is_bitwise(tmp_path):
    path = str(tmp_path / "chunk.ckpt")
    plan = FaultPlan(seed=0)
    runner = compile_fmin(objective, space(thp), chunk_size=8, checkpoint_path=path,
                          checkpoint_every=1, fs=plan.fs(), device="cpu", **KW)
    ref = runner(seed=SEED)
    assert_stream_equal(flat_result(), ref)  # durability changes nothing
    n_chunks = runner._chunk_geometry["n_chunks"]
    for point in DEVICE_LOOP_CRASH_POINTS + ("after_ckpt_tmp_before_rename",):
        for at in range(1, n_chunks + 1):
            if os.path.exists(path):
                os.remove(path)
            plan.arm(point, at=at)
            with pytest.raises(SimulatedCrash):
                runner(seed=SEED)
            assert_stream_equal(ref, runner(seed=SEED, resume=True))
    assert plan.stats["crash:after_ckpt_tmp_before_rename"] == n_chunks
    # a completed run resumes straight from its last bundle
    assert_stream_equal(ref, runner(seed=SEED, resume=True))


def test_resume_refuses_a_foreign_seed_experiment_or_file(tmp_path):
    path = str(tmp_path / "chunk.ckpt")
    runner = compile_fmin(objective, space(thp), chunk_size=8, checkpoint_path=path,
                          device="cpu", **KW)
    runner(seed=SEED)
    with pytest.raises(CheckpointError, match="seed"):
        runner(seed=SEED + 1, resume=True)
    foreign = compile_fmin(objective, space(thp), chunk_size=8, checkpoint_path=path,
                           device="cpu", **dict(KW, max_evals=2 * N_EVALS))
    with pytest.raises(CheckpointError, match="refusing to resume"):
        foreign(seed=SEED, resume=True)
    other_algo = compile_fmin(objective, space(thp), chunk_size=8, checkpoint_path=path,
                              algo="anneal", device="cpu", **KW)
    with pytest.raises(CheckpointError, match="refusing to resume"):
        other_algo(seed=SEED, resume=True)
    with open(path, "r+b") as f:
        f.truncate(40)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        runner(seed=SEED, resume=True)


def test_chunk_option_validation():
    t_space = space(thp)
    with pytest.raises(ValueError, match="chunk_size"):
        compile_fmin(objective, t_space, progress_callback=print, device="cpu", **KW)
    with pytest.raises(ValueError, match="loss_threshold"):
        compile_fmin(objective, t_space, chunk_size=8, loss_threshold=0.1, device="cpu", **KW)
    with pytest.raises(ValueError, match="checkpoint_path"):
        compile_fmin(objective, t_space, chunk_size=8, resume=True, device="cpu", **KW)
    runner = compile_fmin(objective, t_space, chunk_size=8, device="cpu", **KW)
    with pytest.raises(ValueError, match="seed sweep"):
        runner(seed=[0, 1])
    with pytest.raises(ValueError, match="checkpoint_path"):
        runner(seed=0, resume=True)
    with pytest.raises(ValueError, match="chunked"):
        compile_fmin(objective, t_space, device="cpu", **KW)(seed=0, resume=True)
    with pytest.raises(ValueError, match="n_epochs"):
        TrainableObjective(lambda k, c: 0, lambda s, c, e: s, lambda s, c: 0.0, n_epochs=0)


# ---------------------------------------------------------------------------
# trainable objectives
# ---------------------------------------------------------------------------

TINY = dict(n_epochs=4, n_train=64, in_dim=4, hidden=8)


def _train_both(j_obj, t_obj, cfg, active=None):
    """Each package's per-trial losses from the SAME configurations, keys
    and initial state: the reference's state is carried across by
    ``convert.trainable_state_from_numpy``."""
    n = len(next(iter(cfg.values())))
    keys = jax.random.split(jax.random.key(7), n)
    j_cfg = {k: jnp.asarray(v) for k, v in cfg.items()}
    j_act = None if active is None else {k: jnp.asarray(v) for k, v in active.items()}

    def j_one(k, c, a):
        s0 = j_obj.init_fn(k, c) if a is None else j_obj.init_fn(k, c, a)
        s = jax.lax.fori_loop(0, j_obj.n_epochs, lambda e, st: j_obj.step_fn(st, c, e), s0)
        return s0, j_obj.loss_fn(s, c)

    s0, j_loss = jax.vmap(j_one)(keys, j_cfg, j_act)
    t_state = convert.trainable_state_from_numpy(jax.tree.map(np.asarray, s0), device="cpu")
    t_cfg = {k: torch.from_numpy(np.asarray(v)) for k, v in cfg.items()}

    def t_one(s, c):
        for e in range(t_obj.n_epochs):
            s = t_obj.step_fn(s, c, e)
        return t_obj.loss_fn(s, c)

    t_loss = torch.func.vmap(t_one)(t_state, t_cfg).numpy()
    # the port's own init from the same keys is the reference's bit for bit
    t_keys = convert.key_from_numpy(jax.random.key_data(keys), device="cpu")
    t_act = None if active is None else {k: torch.from_numpy(v) for k, v in active.items()}
    init = (lambda k, c: t_obj.init_fn(k, c)) if active is None else (
        lambda k, c, a: t_obj.init_fn(k, c, a))
    args = (t_keys, t_cfg) if active is None else (t_keys, t_cfg, t_act)
    t_s0 = torch.func.vmap(init)(*args)
    np.testing.assert_array_equal(t_s0[0]["w1"].numpy(), np.asarray(s0[0]["w1"]))
    return np.asarray(j_loss), t_loss


def test_mlp_tune_teacher_forced_within_tolerance():
    rng = np.random.default_rng(0)
    n = 16
    cfg = {
        "lr": np.exp(rng.uniform(np.log(1e-3), 0.0, n)).astype(np.float32),
        "momentum": rng.uniform(0.0, 0.99, n).astype(np.float32),
        "wd": np.exp(rng.uniform(np.log(1e-6), np.log(1e-2), n)).astype(np.float32),
        "init_scale": np.exp(rng.uniform(np.log(1e-2), 0.0, n)).astype(np.float32),
    }
    j_loss, t_loss = _train_both(j_mlp_tune(**TINY), mlp_tune_objective(**TINY), cfg)
    assert np.unique(t_loss).size == n  # the state really trained
    np.testing.assert_allclose(t_loss, j_loss, rtol=TRAIN_RTOL)


def test_cond_tune_teacher_forced_within_tolerance():
    rng = np.random.default_rng(1)
    n = 12
    branch = np.arange(n) % 3
    cfg = {
        "ct_lr": np.exp(rng.uniform(np.log(1e-3), 0.0, n)).astype(np.float32),
        # off-branch dims are 0.0, as the compiled loop pins them
        "ct_wd": np.where(branch == 1, np.exp(rng.uniform(-13.8, -2.3, n)), 0.0).astype(
            np.float32),
        "ct_mu": np.where(branch == 2, rng.uniform(0.0, 0.99, n), 0.0).astype(np.float32),
        "ct_extra": np.where(branch == 2, rng.uniform(0.0, 1.0, n), 0.0).astype(np.float32),
        "ct_reg": branch.astype(np.float32),
        "ct_nest": np.zeros(n, np.float32),
    }
    active = {"ct_lr": branch >= 0, "ct_reg": branch >= 0, "ct_wd": branch == 1,
              "ct_mu": branch == 2, "ct_nest": branch == 2, "ct_extra": branch == 2}
    j_loss, t_loss = _train_both(j_cond_tune(), cond_tune_objective(), cfg, active)
    np.testing.assert_allclose(t_loss, j_loss, rtol=TRAIN_RTOL)


def test_trainable_runs_are_deterministic_and_resume_bitwise(tmp_path):
    kw = dict(max_evals=16, batch_size=4, n_startup_jobs=4, n_EI_candidates=4, device="cpu")
    runner = compile_fmin(mlp_tune_objective(**TINY), mlp_tune_space(), **kw)
    a = runner(seed=0)
    assert np.isfinite(a["losses"]).all() and np.unique(a["losses"]).size > 1
    assert_stream_equal(a, runner(seed=0))
    assert not np.array_equal(a["losses"], runner(seed=1)["losses"])
    path = str(tmp_path / "mlp.ckpt")
    plan = FaultPlan(seed=0)
    rows = []
    chunked = compile_fmin(mlp_tune_objective(**TINY), mlp_tune_space(), chunk_size=8,
                           checkpoint_path=path, progress_callback=rows.append, fs=plan.fs(),
                           **kw)
    assert_stream_equal(a, chunked(seed=0))
    plan.arm("device_loop_after_ckpt_before_next_chunk", at=1)
    with pytest.raises(SimulatedCrash):
        chunked(seed=0)
    rows.clear()
    assert_stream_equal(a, chunked(seed=0, resume=True))
    assert [r["trials_done"] for r in rows] == [16]


def test_cond_tune_compiled_stream_matches_reference():
    """The trainable end to end in both compiled loops: off-branch dims
    pinned to 0.0 and ``init_fn`` given the ``active`` masks, so the same
    suggestions train to the same losses, within TRAIN_RTOL."""
    kw = dict(max_evals=12, batch_size=4, n_startup_jobs=4, n_EI_candidates=4)
    j = j_compile_fmin(j_cond_tune(n_epochs=2), j_cond_tune_space(), **kw)(
        seed=2)
    t = compile_fmin(cond_tune_objective(n_epochs=2), cond_tune_space(), device="cpu", **kw)(
        seed=2)
    np.testing.assert_array_equal(t["active"], np.asarray(j["active"]))
    np.testing.assert_allclose(t["values"], np.asarray(j["values"]), rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(t["losses"], np.asarray(j["losses"]), rtol=TRAIN_RTOL)


# ---------------------------------------------------------------------------
# fmin(compiled=True)
# ---------------------------------------------------------------------------

OPTS = dict(batch_size=2, n_startup_jobs=4, n_EI_candidates=8)


def test_fmin_compiled_returns_standard_trials_and_argmin():
    trials = H.Trials()
    best = H.fmin(objective, space(thp), compiled=True, max_evals=16, trials=trials,
                  rstate=np.random.default_rng(3), compiled_options=OPTS, device="cpu")
    assert len(trials) == 16 and trials.argmin == best
    losses = trials.losses()
    assert all(np.isfinite(losses))
    loss = H.fmin(objective, space(thp), compiled=True, max_evals=16, return_argmin=False,
                  rstate=np.random.default_rng(3), compiled_options=OPTS, device="cpu")
    assert loss == min(losses)
    # the same seed through a prebuilt runner, and the reference's stream
    runner = compile_fmin(objective, space(thp), 16, device="cpu", **OPTS)
    seed = int(np.random.default_rng(3).integers(2**31 - 1))
    by_runner = H.Trials()
    H.fmin(objective, space(thp), compiled=True, trials=by_runner, device="cpu",
           compiled_options={"runner": runner, "seed": seed})
    assert by_runner.losses() == losses
    one_shot = fmin_on_device(objective, space(thp), 16, seed=seed, device="cpu", **OPTS)
    assert one_shot["losses"].tolist() == losses
    jt = J.Trials()
    J.fmin(objective, space(jhp), compiled=True, max_evals=16, trials=jt,
           rstate=np.random.default_rng(3), compiled_options=OPTS)
    np.testing.assert_allclose(losses, jt.losses(), rtol=1e-5)  # XLA contracts an FMA


def test_fmin_compiled_algo_mapping_and_refusals():
    assert _compiled_algo_name(None) == "tpe"
    assert _compiled_algo_name("anneal") == "anneal"
    assert _compiled_algo_name(H.tpe.suggest) == "tpe"
    assert _compiled_algo_name(functools.partial(H.atpe.suggest, elite_count=4)) == "atpe"
    assert _compiled_algo_name(H.partial(H.rand.suggest)) == "rand"
    with pytest.raises(ValueError, match="compiled"):
        _compiled_algo_name(lambda *a: None)
    with pytest.raises(ValueError, match="unknown compiled algo"):
        _compiled_algo_name("grid")
    with pytest.raises(ValueError, match="trials_save_file"):
        H.fmin(objective, space(thp), compiled=True, max_evals=8, trials_save_file="x.ckpt")
    with pytest.raises(ValueError, match="trial_timeout"):
        H.fmin(objective, space(thp), compiled=True, max_evals=8, trial_timeout=1.0)
    filled = H.Trials()
    H.fmin(objective, space(thp), compiled=True, max_evals=4, trials=filled,
           rstate=np.random.default_rng(0), device="cpu",
           compiled_options=dict(OPTS, n_startup_jobs=2))
    with pytest.raises(ValueError, match="fresh experiment"):
        H.fmin(objective, space(thp), compiled=True, max_evals=8, trials=filled, device="cpu")
