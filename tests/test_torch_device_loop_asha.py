"""The compiled loop's fused ASHA brackets (``compile_fmin(asha=...)``)
against the reference's on the CPU.

* on a ``TrainableObjective`` written for both packages with per-epoch
  math that rounds alike (elementwise float32, no multiply-add to
  contract, no reduction) and random search (whose draws on uniform
  dims are the reference's bits), the whole stream is bitwise:
  ``values``, ``active``, ``losses``, ``rung_of``, the full-fidelity
  ``best`` and every artifact row; with TPE the values agree within
  CONT_RTOL and the promotions equal;
* ``mlp_tune_objective`` under the same random-search configs (bitwise
  but for one ulp of a log-space draw) trains every rung to losses
  within the trainable tests' TRAIN_RTOL, with the same promotions;
* a chunked run is bitwise the flat run (a padded tail included), a kill
  at every chunk boundary resumes bitwise through ``FaultyFS``, and the
  checkpoint guard refuses another ladder;
* the reference's refusals, with its exception types.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.device_loop import TrainableObjective as JTrainable
from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
from hyperopt_tpu.models.synthetic import mlp_tune_objective as j_mlp_tune
from hyperopt_tpu.models.synthetic import mlp_tune_space as j_mlp_space
import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import hp as thp
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.device_loop import TrainableObjective, compile_fmin
from hyperopt_tpu_torch.distributed.faults import (DEVICE_LOOP_CRASH_POINTS, FaultPlan,
                                                   SimulatedCrash)
from hyperopt_tpu_torch.exceptions import CheckpointError
from hyperopt_tpu_torch.models.synthetic import mlp_tune_objective, mlp_tune_space

# as in test_torch_device_loop_chunked.py: per-trial losses after the same
# training in both packages
TRAIN_RTOL = 1e-5
CONT_RTOL, CONT_ATOL = 5e-5, 1e-6

ASHA = {"eta": 2, "rung_epochs": 1, "n_rungs": 3}
# 3 brackets of 8: ladder (8, 1, 0) -> (4, 2, 1) -> (2, 4, 3)
KW = dict(max_evals=24, batch_size=8, n_startup_jobs=8, n_EI_candidates=8, asha=ASHA)
SEED = 5


def space(hp):
    return {"decay": hp.uniform("decay", 0.05, 0.6), "t": hp.uniform("t", -2.0, 2.0)}


def shrink(random, zeros_like):
    """The same trainable for both packages: theta starts uniform in
    [0, 1)^3 and each epoch moves it toward ``t`` by ``(theta - t) * (1 -
    decay) + t`` computed as two roundings (sub, mul) plus an add that no
    compiler contracts (the product is of two subtractions' results)."""

    def init(k, cfg):
        return {"theta": random(k), "steps": zeros_like(random(k))}

    def step(s, cfg, epoch):
        theta = (s["theta"] - cfg["t"]) * (1.0 - cfg["decay"])
        return {"theta": theta, "steps": s["steps"] + 1.0}

    def loss(s, cfg):
        return s["theta"][0] * s["theta"][0]

    return init, step, loss


def j_objective():
    return JTrainable(*shrink(lambda k: jax.random.uniform(k, (3,)), jnp.zeros_like))


def t_objective():
    return TrainableObjective(*shrink(lambda k: R.uniform(k, (3,)), torch.zeros_like))


def _pair(algo, **kw):
    j_rows, t_rows = [], []
    opts = dict(KW, algo=algo, **kw)
    if "chunk_size" in kw:
        opts_j = dict(opts, artifact_callback=j_rows.append)
        opts_t = dict(opts, artifact_callback=t_rows.append)
    else:
        opts_j = opts_t = opts
    j = j_compile_fmin(j_objective(), space(jhp), **opts_j)(seed=SEED)
    t = compile_fmin(t_objective(), space(thp), device="cpu", **opts_t)(seed=SEED)
    return j, t, j_rows, t_rows


def assert_stream_equal(a, b):
    for f in ("values", "active", "losses", "rung_of"):
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)
    assert a["best_loss"] == b["best_loss"]
    assert a["best_index"] == b["best_index"]
    assert a["best"] == b["best"]


@functools.lru_cache(maxsize=None)
def flat_result():
    return compile_fmin(t_objective(), space(thp), algo="rand", device="cpu", **KW)(seed=SEED)


def test_asha_stream_and_artifact_rows_are_the_references_bits():
    j, t, j_rows, t_rows = _pair("rand", chunk_size=16)
    assert_stream_equal(j, t)
    assert t["asha"] == j["asha"]
    assert list(np.bincount(t["rung_of"] + 1, minlength=4)) == [0, 12, 6, 6]
    full = t["rung_of"] == ASHA["n_rungs"] - 1
    assert full[t["best_index"]] and t["best_loss"] == t["losses"][full].min()
    assert len(t_rows) == len(j_rows) == 3
    for a, b in zip(j_rows, t_rows):
        assert (a["bracket"], a["slot"], a["loss"]) == (b["bracket"], b["slot"], b["loss"])
        for k in ("theta", "steps"):
            np.testing.assert_array_equal(np.asarray(a["params"][k]), b["params"][k])
        assert b["params"]["steps"][0] == 1 + 2 + 4  # the winner trained the whole ladder
    assert_stream_equal(flat_result(), t)  # the artifact stream changes nothing


def test_asha_tpe_stream_matches_the_reference():
    j, t, _, _ = _pair("tpe")
    np.testing.assert_array_equal(t["rung_of"], np.asarray(j["rung_of"]))
    np.testing.assert_array_equal(t["active"], np.asarray(j["active"]))
    np.testing.assert_allclose(t["values"], np.asarray(j["values"]), rtol=CONT_RTOL,
                               atol=CONT_ATOL)
    np.testing.assert_allclose(t["losses"], np.asarray(j["losses"]), rtol=1e-5, atol=1e-6)
    assert t["best_index"] == j["best_index"]


def test_asha_mlp_tune_rungs_within_train_rtol():
    tiny = dict(n_epochs=1, n_train=32, in_dim=4, hidden=8)
    kw = dict(KW, algo="rand")
    j = j_compile_fmin(j_mlp_tune(**tiny), j_mlp_space(), **kw)(seed=1)
    t = compile_fmin(mlp_tune_objective(**tiny), mlp_tune_space(), device="cpu", **kw)(seed=1)
    np.testing.assert_array_equal(t["rung_of"], np.asarray(j["rung_of"]))
    ulp = np.abs(t["values"].view(np.int32).astype(np.int64)
                 - np.asarray(j["values"]).view(np.int32))
    assert ulp.max() <= 1  # log-space prior draws: PyTorch's exp, one ulp at most
    np.testing.assert_allclose(t["losses"], np.asarray(j["losses"]), rtol=TRAIN_RTOL)
    assert t["best_index"] == j["best_index"]


@pytest.mark.parametrize("chunk_size", [8, 16])
def test_chunked_asha_is_bitwise_the_flat_run(chunk_size):
    # 16: two brackets per chunk, the second chunk padded
    runner = compile_fmin(t_objective(), space(thp), algo="rand", chunk_size=chunk_size,
                          device="cpu", **KW)
    assert runner._chunk_geometry["n_chunks"] == (3 if chunk_size == 8 else 2)
    assert_stream_equal(flat_result(), runner(seed=SEED))


def test_asha_progress_rows_count_full_fidelity_only():
    rows, j_rows = [], []
    kw = dict(KW, algo="rand", chunk_size=8)
    compile_fmin(t_objective(), space(thp), progress_callback=rows.append, device="cpu",
                 **kw)(seed=SEED)
    j_compile_fmin(j_objective(), space(jhp), progress_callback=j_rows.append, **kw)(seed=SEED)
    assert rows == j_rows
    out = flat_result()
    full = out["rung_of"] == ASHA["n_rungs"] - 1
    assert rows[-1]["best_loss"] == float(out["losses"][full].min())


def _row(r):
    return (r["bracket"], r["slot"], r["loss"], r["params"]["theta"].tobytes())


def test_asha_kill_and_resume_at_every_chunk_boundary_is_bitwise(tmp_path):
    path = str(tmp_path / "asha.ckpt")
    plan = FaultPlan(seed=0)
    rows = []
    runner = compile_fmin(t_objective(), space(thp), algo="rand", chunk_size=8,
                          checkpoint_path=path, fs=plan.fs(), artifact_callback=rows.append,
                          device="cpu", **KW)
    ref = runner(seed=SEED)
    assert_stream_equal(flat_result(), ref)
    ref_rows = list(rows)
    for point in DEVICE_LOOP_CRASH_POINTS + ("after_ckpt_tmp_before_rename",):
        for at in range(1, 4):
            if os.path.exists(path):
                os.remove(path)
            plan.arm(point, at=at)
            with pytest.raises(SimulatedCrash):
                runner(seed=SEED)
            rows.clear()
            assert_stream_equal(ref, runner(seed=SEED, resume=True))
            # the resumed chunks stream their own brackets' rows again
            tail = ref_rows[len(ref_rows) - len(rows):]
            assert [_row(r) for r in rows] == [_row(r) for r in tail]
    # a bundle from another ladder is refused
    other = compile_fmin(t_objective(), space(thp), algo="rand", chunk_size=8,
                         checkpoint_path=path, device="cpu",
                         **dict(KW, asha={"eta": 2, "rung_epochs": 2, "n_rungs": 3}))
    with pytest.raises(CheckpointError, match="refusing to resume"):
        other(seed=SEED, resume=True)
    plain = compile_fmin(t_objective(), space(thp), algo="rand", chunk_size=8,
                         checkpoint_path=path, device="cpu",
                         **{k: v for k, v in KW.items() if k != "asha"})
    with pytest.raises(CheckpointError, match="refusing to resume"):
        plain(seed=SEED, resume=True)


@pytest.mark.parametrize("kw,match", [
    (dict(asha=[2]), "dict"),
    (dict(asha={"eta": 2, "rungs": 3}), "unknown asha"),
    (dict(loss_threshold=0.1), "loss_threshold"),
    (dict(no_progress_steps=2), "loss_threshold"),
    (dict(cand_axis="c"), "cand_axis"),
    (dict(batch_size=6), "power of eta"),
    (dict(artifact_callback=print), "chunk_size"),
])
def test_asha_refusals_are_the_references(kw, match):
    opts = dict(KW, **kw)
    for run in (lambda: j_compile_fmin(j_objective(), space(jhp), **opts),
                lambda: compile_fmin(t_objective(), space(thp), device="cpu", **opts)):
        with pytest.raises(ValueError, match=match):
            run()


def test_asha_refuses_sweeps_plain_objectives_and_runs_through_fmin():
    runner = compile_fmin(t_objective(), space(thp), algo="rand", device="cpu", **KW)
    with pytest.raises(ValueError, match="seed sweeps"):
        runner(seed=[0, 1])
    with pytest.raises(ValueError, match="TrainableObjective"):
        compile_fmin(lambda cfg: cfg["t"], space(thp), device="cpu", **KW)
    trials = H.Trials()
    best = H.fmin(t_objective(), space(thp), algo="rand", max_evals=24, trials=trials,
                  compiled=True, device="cpu",
                  compiled_options={"batch_size": 8, "asha": ASHA, "seed": SEED})
    assert len(trials) == 24
    np.testing.assert_array_equal(trials.losses(), flat_result()["losses"])
    assert trials.argmin == best


def test_captured_steps_read_nothing_on_the_host():
    """What the card captures -- an ASHA bracket, a compile_sha rung and a
    compile_pbt round -- dispatches no host read or host copy
    (``aten._local_scalar_dense``, ``aten.nonzero``, ``aten.lift_fresh``)
    once warm, run here on the CPU under a dispatch mode that flags them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hyperopt_tpu_torch.hyperband import compile_sha
    from hyperopt_tpu_torch.pbt import compile_pbt

    flagged = {"aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh"}

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket._qualified_op_name.replace("::", ".")
            assert name not in flagged, name
            return func(*args, **(kwargs or {}))

    runner = compile_fmin(mlp_tune_objective(n_epochs=1, n_train=16, in_dim=2, hidden=4),
                          mlp_tune_space(), algo="tpe", device="cpu", chunk_size=16,
                          artifact_callback=lambda row: None, **KW)
    runner(seed=0)  # warm: the cached constants exist
    prog = runner._program()
    with HostReads():
        prog.step("model")

    def quad(state, hypers, key):
        theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
        return {"theta": theta}, (theta - 0.7) ** 2

    init = {"theta": torch.linspace(-1.0, 2.0, 8)}
    sha = compile_sha(quad, init, {"lr": (1e-3, 1.0)}, n_configs=4, replicas=2,
                      steps_per_rung=1, device="cpu")
    sha(seed=0)
    pbt = compile_pbt(quad, init, {"lr": (1e-3, 1.0)}, pop_size=8, exploit_every=2,
                      n_rounds=2, device="cpu")
    pbt(seed=0)
    pbt._round_index.zero_()
    with HostReads():
        for r in range(len(sha._ladder)):
            sha._rung_step(r)
        pbt._round()


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2])
def test_asha_streams_on_more_seeds(seed):
    """Second seeds of the bitwise (random search) and the TPE streams."""
    kw = dict(KW, max_evals=48)
    j = j_compile_fmin(j_objective(), space(jhp), algo="rand", **kw)(seed=seed)
    t = compile_fmin(t_objective(), space(thp), algo="rand", device="cpu", **kw)(seed=seed)
    assert_stream_equal(j, t)
    j = j_compile_fmin(j_objective(), space(jhp), algo="tpe", **kw)(seed=seed)
    t = compile_fmin(t_objective(), space(thp), algo="tpe", device="cpu", **kw)(seed=seed)
    np.testing.assert_array_equal(t["rung_of"], np.asarray(j["rung_of"]))
    np.testing.assert_allclose(t["values"], np.asarray(j["values"]), rtol=CONT_RTOL,
                               atol=CONT_ATOL)
