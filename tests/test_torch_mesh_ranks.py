"""The compiled loop's ``cand`` axis and ``asha=`` over ranks, and meshes of
two axes, with the ranks simulated by threads inside this process.

``test_torch_population_ranks.ThreadRanks`` names each thread's rank in
``process_block`` and ``process_line`` and gathers within a line's ranks
in ``fetch_global``, so two and four ranks run without a process group
(the spawned ``gloo`` ranks of ``tests/test_torch_parallel.py`` and
``dcn_check`` stages F-H check the real collective).  Every rank's
stream is held bit for bit against the same program on a
``virtual_mesh`` in one process:

* ``compile_fmin(cand_axis=)`` for TPE and ATPE over two ranks, its step
  split at the packed winners: one gather per model step, none at
  startup;
* ``compile_fmin(asha=)`` over the ``trial`` ranks, rung by rung (the
  rung's gcd sub-mesh trains, an idle rank sends padding): two gathers
  per rung, and the stream bitwise the unsharded run as well;
* a ``trial`` x ``cand`` ``compile_fmin`` over four ranks: one gather per
  line per step;
* ``compile_pbt`` and ``compile_sha`` on a 2 x 2 mesh over four ranks and
  on the virtual mesh, bitwise the unsharded run on an elementwise
  ``train_fn``, and against the reference's ``Mesh(jax.devices()[:4].
  reshape(2, 2), ("trial", "cand"))`` at the rule of ``test_torch_pbt.py``
  and ``test_torch_hyperband.py`` (hypers, rung orders and the winner
  bitwise, losses within their LOSS_RTOL of 1e-5: XLA's and PyTorch's
  ``exp`` of a hyper differ in the last bit).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hyperopt_tpu.hyperband import compile_sha as j_compile_sha
from hyperopt_tpu.pbt import compile_pbt as j_compile_pbt
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.device_loop import compile_fmin
from hyperopt_tpu_torch.hyperband import compile_sha
from hyperopt_tpu_torch.parallel import dcn_check, mesh as TM
from hyperopt_tpu_torch.pbt import compile_pbt

import test_torch_device_loop_asha as AS
import test_torch_device_loop_mesh as DM
import test_torch_hyperband as HB
import test_torch_pbt as PB
from test_torch_population_ranks import thread_ranks  # noqa: F401 -- the fixture

TWO_D = ("trial", "cand")
FIELDS = ("values", "active", "losses", "n_evals")


def cand_mesh(n):
    return TM.RankMesh((n,), ("cand",), range(n))


def two_d_mesh():
    return TM.RankMesh((2, 2), TWO_D, range(4))


def mixed_fn(cfg):
    return (cfg["x"] - 1.0) ** 2 + 0.1 * cfg["k"] + 0.25 * cfg["r"]


def arrays(out, fields=FIELDS):
    return [np.asarray(out[f]) for f in fields]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# compile_fmin's cand axis
# ---------------------------------------------------------------------------

FMIN_KW = dict(max_evals=16, n_startup_jobs=8, n_EI_candidates=16, n_EI_candidates_cat=8,
               device="cpu")


def cand_run(mesh, algo, variant="flat", **kw):
    """One cand-sharded ``compile_fmin`` on the mixed space, as arrays."""
    runner = compile_fmin(mixed_fn, dcn_check.mixed_space(hp), mesh=mesh, cand_axis="cand",
                          algo=algo, **dict(FMIN_KW, **kw))
    if variant == "seeds":
        return [a for out in runner(seed=[3, 4]) for a in arrays(out)]
    return arrays(runner(seed=3))


@pytest.mark.parametrize("algo", ["tpe", pytest.param("atpe", marks=pytest.mark.slow)])
def test_fmin_cand_axis_over_ranks_is_bitwise_the_virtual_loop(thread_ranks, algo):
    """Two ranks each score their slab at their position on ``cand``, one
    gather of the packed winners per model step (8 of them; none in the
    8 startup steps), and every rank writes the virtual mesh's stream.
    (ATPE over two ``gloo`` ranks runs in the fast tier as ``dcn_check``
    stage F, ``tests/test_torch_parallel.py``.)"""
    ranks = thread_ranks(2)
    want = cand_run(TM.virtual_mesh(2), algo)
    for got in ranks.run(lambda: cand_run(cand_mesh(2), algo)):
        assert_same(got, want)
    assert ranks.gathers == [16 - 8] * 2
    assert set(ranks.line_gathers) == {(0, (0, 1)), (1, (0, 1))}


@pytest.mark.slow
@pytest.mark.parametrize("variant,kw", [
    ("seeds", dict(batch_size=2, trial_axis=None)),
    ("flat", dict(chunk_size=12, max_evals=32)),
    ("flat", dict(loss_threshold=0.5, max_evals=64)),
])
@pytest.mark.parametrize("algo", ["tpe", "atpe"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_fmin_cand_axis_over_ranks_more_variants(thread_ranks, n_ranks, algo, variant, kw):
    """A seed sweep (its seed axis behind the rank axis), a chunked run and
    an early stop, at two and four ranks: bitwise the virtual mesh."""
    ranks = thread_ranks(n_ranks)
    want = cand_run(TM.virtual_mesh(n_ranks), algo, variant, **kw)
    for got in ranks.run(lambda: cand_run(cand_mesh(n_ranks), algo, variant, **kw)):
        assert_same(got, want)


# ---------------------------------------------------------------------------
# asha= over the trial ranks
# ---------------------------------------------------------------------------

ASHA_FIELDS = ("values", "active", "losses", "rung_of", "best_loss", "best_index")


def asha_run(objective, space, mesh, algo, rows=None, **kw):
    opts = dict(AS.KW, algo=algo, device="cpu", **kw)
    if rows is not None:
        opts.update(chunk_size=16, artifact_callback=rows.append)
    if mesh is not None:
        opts.update(mesh=mesh, trial_axis="trial")
    runner = compile_fmin(objective, space(hp), **opts)
    out = runner(seed=AS.SEED)
    return arrays(out, ASHA_FIELDS), getattr(runner, "_asha_submesh_devices", None)


def assert_rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x["bracket"], x["slot"], x["loss"]) == (y["bracket"], y["slot"], y["loss"])
        np.testing.assert_array_equal(x["params"]["theta"], y["params"]["theta"])


@pytest.mark.parametrize("algo", ["rand", "tpe"])
def test_asha_over_ranks_is_bitwise_the_virtual_and_unsharded_runs(thread_ranks, algo):
    """Rung by rung over two ranks (8 -> 4 -> 2 trials: every rung on both
    ranks), two gathers per rung -- the block losses and the block
    states -- and every rank's stream, rung record and artifact rows the
    virtual mesh's and the unsharded run's; the chunked run is the flat
    one, and the rung sub-mesh reported is the virtual mesh's."""
    ranks = thread_ranks(2)
    flat, _ = asha_run(AS.t_objective(), AS.space, None, algo)
    rows_v = []
    virtual, k_v = asha_run(AS.t_objective(), AS.space, TM.virtual_mesh(2, "trial"), algo,
                            rows=rows_v)
    assert_same(virtual, flat)

    def run():
        rows = []
        return (asha_run(AS.t_objective(), AS.space, TM.RankMesh((2,), ("trial",), (0, 1)),
                         algo, rows=rows), rows)

    for (got, k), rows in ranks.run(run):
        assert_same(got, flat)
        assert k == k_v == 2
        assert_rows_equal(rows, rows_v)
    # 3 brackets of 3 rungs
    assert ranks.gathers == [2 * 3 * 3] * 2


@pytest.mark.slow
@pytest.mark.parametrize("objective", ["shrink", "mesh_trainable"])
@pytest.mark.parametrize("n_ranks", [3, 4])
def test_asha_over_more_ranks(thread_ranks, n_ranks, objective):
    """Four ranks (8 -> 4 -> 2: the last rung on a sub-mesh of two, the
    others idle and sending padding) and three (every rung on rank 0), on
    the shrink trainable and on ``test_torch_device_loop_mesh``'s
    elementwise one: bitwise the unsharded run."""
    ranks = thread_ranks(n_ranks)
    make, space = ((AS.t_objective, AS.space) if objective == "shrink"
                   else (DM._trainable, DM.DL.quad_space))
    flat, _ = asha_run(make(), space, None, "tpe")
    _, k_v = asha_run(make(), space, TM.virtual_mesh(n_ranks, "trial"), "tpe")
    mesh = TM.RankMesh((n_ranks,), ("trial",), range(n_ranks))
    for got, k in ranks.run(lambda: asha_run(make(), space, mesh, "tpe")):
        assert_same(got, flat)
        assert k == k_v == math.gcd(2, n_ranks)
    assert ranks.gathers == [2 * 3 * 3] * n_ranks


#: the losses' tolerance over ranks on a trainable whose per-trial math
#: holds a matmul: under ``vmap`` a rank's block of ``b`` trials runs a
#: batched product of width ``b``, whose kernel (and so its order of sums)
#: is picked by the width, so a block's losses may part from the whole
#: rung's in the last bits -- 3.3e-7 relative on the CPU, 1.49e-5 for the
#: population MLP's ``h @ w2`` on cuBLAS (PERF.md's findings on population
#: blocks) -- and the promotions hold unless two trials of a rung tie
#: within that
MATMUL_RTOL = 2e-5


@pytest.mark.slow
def test_asha_over_ranks_on_a_matmul_trainable(thread_ranks):
    """``mlp_tune``'s MLP over two ranks: configs, activity and the rung
    record equal to the unsharded run, the losses within MATMUL_RTOL."""
    from hyperopt_tpu_torch.models.synthetic import mlp_tune_objective, mlp_tune_space

    ranks = thread_ranks(2)
    make = lambda: mlp_tune_objective(n_epochs=1, n_train=64, in_dim=4, hidden=16)  # noqa: E731
    space = lambda hp_: mlp_tune_space()  # noqa: E731
    flat, _ = asha_run(make(), space, None, "tpe")
    for got, _ in ranks.run(lambda: asha_run(make(), space, TM.RankMesh((2,), ("trial",), (0, 1)),
                                             "tpe")):
        assert_same([got[i] for i in (0, 1, 3)], [flat[i] for i in (0, 1, 3)])
        np.testing.assert_allclose(got[2], flat[2], rtol=MATMUL_RTOL)


# ---------------------------------------------------------------------------
# trial x cand over four ranks
# ---------------------------------------------------------------------------

def two_d_run(mesh, algo="tpe"):
    return cand_run(mesh, algo, batch_size=2, max_evals=12, n_startup_jobs=8)


def test_two_d_fmin_over_four_ranks_is_bitwise_the_virtual_mesh(thread_ranks):
    """``trial`` 2 x ``cand`` 2 at B=2: each rank scores its slab at its
    ``cand`` position, the winners meet on its ``cand`` line, it evaluates
    its ``trial`` block, and the losses meet on its ``trial`` line -- per
    model step one gather on each of the rank's two lines (2 model steps),
    per startup step one on its trial line (4)."""
    ranks = thread_ranks(4)
    want = two_d_run(TM.virtual_mesh((2, 2), TWO_D))
    for got in ranks.run(lambda: two_d_run(two_d_mesh())):
        assert_same(got, want)
    mesh = two_d_mesh()
    for r in range(4):
        assert ranks.line_gathers[r, mesh.axis_ranks("cand", r)] == 2
        assert ranks.line_gathers[r, mesh.axis_ranks("trial", r)] == 6
    assert ranks.gathers == [8] * 4


@pytest.mark.slow
def test_two_d_fmin_under_atpe_over_four_ranks(thread_ranks):
    ranks = thread_ranks(4)
    want = two_d_run(TM.virtual_mesh((2, 2), TWO_D), "atpe")
    for got in ranks.run(lambda: two_d_run(two_d_mesh(), "atpe")):
        assert_same(got, want)


# ---------------------------------------------------------------------------
# compile_pbt and compile_sha on a 2 x 2 mesh
# ---------------------------------------------------------------------------

def j_two_d():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), TWO_D)


PBT_KW = dict(pop_size=8, exploit_every=3, n_rounds=4, trial_axis="trial")
SHA_KW = dict(n_configs=4, eta=2, steps_per_rung=1, trial_axis="trial")
THETA0 = np.linspace(2.0, 5.0, 8).astype(np.float32)


def t_pbt(mesh, mode):
    return compile_pbt(PB.quad_train_fn, {"theta": THETA0}, PB.BOUNDS, mesh=mesh,
                       shard_mode=mode, device="cpu", **PBT_KW)


def t_sha(mesh, mode):
    return compile_sha(HB.quad_train_fn, {"theta": THETA0[:4]}, {"lr": (1e-3, 1.2)}, mesh=mesh,
                       shard_mode=mode, device="cpu", **SHA_KW)


def pbt_arrays(out):
    return [out["loss_history"], out["log_hypers"], out["state"]["theta"].numpy(),
            np.asarray(out["best_index"])]


def sha_values(out):
    return (out["rungs"], out["best_loss"], out["best_hypers"], out["best_index"],
            out["state"]["theta"].tolist())


@pytest.mark.parametrize("mode", [None, pytest.param("shard_map", marks=pytest.mark.slow)])
def test_two_d_pbt_and_sha_meet_the_reference_and_the_unsharded_run(mode):
    """In one process (the repair: a mesh of two axes was refused): the
    ``trial`` axis shards, ``cand`` replicates, and both schedules are
    bitwise the unsharded run; against the reference's 2 x 2 device mesh
    hypers and the winner are equal and the losses within LOSS_RTOL."""
    v = TM.virtual_mesh((2, 2), TWO_D)
    pbt, plain = t_pbt(v, mode)(seed=3), t_pbt(None, None)(seed=3)
    assert_same(pbt_arrays(pbt), pbt_arrays(plain))
    j = j_compile_pbt(PB.quad_train_fn, {"theta": jnp.asarray(THETA0)}, PB.BOUNDS,
                      mesh=j_two_d(), shard_mode=mode, **PBT_KW)(seed=3)
    PB.assert_match(j, pbt)

    sha_runner = t_sha(v, mode)
    sha = sha_runner(seed=9)
    assert sha_values(sha) == sha_values(t_sha(None, None)(seed=9))
    assert [m.size for m in sha_runner._rung_meshes] == [2, 2, 1]
    j_runner = j_compile_sha(HB.quad_train_fn, {"theta": jnp.asarray(THETA0[:4])},
                             {"lr": (1e-3, 1.2)}, mesh=j_two_d(), shard_mode=mode, **SHA_KW)
    js = j_runner(seed=9)
    assert sha["best_hypers"] == js["best_hypers"] and sha["best_index"] == js["best_index"]
    np.testing.assert_allclose([r["best_loss"] for r in sha["rungs"]],
                               [r["best_loss"] for r in js["rungs"]], rtol=HB.LOSS_RTOL)
    np.testing.assert_allclose(sha["replica_bests"], js["replica_bests"], rtol=HB.LOSS_RTOL)
    if mode == "shard_map":
        assert [m.size for m in sha_runner._rung_meshes] == [
            int(np.prod(list(s.mesh.shape.values()))) for s in j_runner._rung_shardings]


def test_two_d_pbt_and_sha_over_four_ranks(thread_ranks):
    """Over four ranks the ranks that share a ``trial`` coordinate hold the
    same block, and each ``trial`` line gathers on its own: two gathers
    per exploit and per rung, on the rank's ``trial`` line only, and every
    rank's result the unsharded run's."""
    ranks = thread_ranks(4)
    want_pbt = pbt_arrays(t_pbt(None, None)(seed=3))
    want_sha = sha_values(t_sha(None, None)(seed=9))
    for pbt, sha in ranks.run(lambda: (pbt_arrays(t_pbt(two_d_mesh(), None)(seed=3)),
                                       sha_values(t_sha(two_d_mesh(), None)(seed=9)))):
        assert_same(pbt, want_pbt)
        assert sha == want_sha
    mesh = two_d_mesh()
    for r in range(4):
        assert ranks.line_gathers[r, mesh.axis_ranks("trial", r)] == 2 * 4 + 2 * 3
    assert ranks.gathers == [14] * 4
