"""The compiled loop's ``mesh=`` (``compile_fmin(mesh=, trial_axis=,
cand_axis=)``) against the reference's on the CPU.

The reference shards over the 8 virtual CPU devices this test session
forces (``conftest.py``); the port runs every rank inside this process
on :func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh` with
``device="cpu"``.

* the ``cand`` axis at 4 ranks against the reference's 4-device ``cand``
  mesh, on the flat and the conditional space, for ``algo="tpe"`` and
  ``"atpe"``, with ``loss_threshold``, and the 2 x 4 ``trial`` x ``cand``
  mesh: the tolerances of ``test_torch_device_loop.py`` (startup bitwise
  up to one ulp on log-space dims, categorical values and ``active``
  equal, continuous values within CONT_RTOL/CONT_ATOL, losses within
  LOSS_RTOL/LOSS_ATOL, the same stop step).  A stream may part only
  where the ranks' best scores of the two picks are a near-tie; one ATPE
  stream does, at an exact tie (``log(0.25 / 0.2083) == log(0.5 /
  0.4167)``), and the test holds it to that; every warm step of that
  stream is also held on the reference's own history (teacher-forced);
* the startup trials are the unsharded program's bits, two runs are
  bitwise, and a seed sweep is bitwise each solo run;
* the ``trial`` axis (a placement axis, which inside one process runs
  the unsharded body) at 2 and 4 ranks is bitwise the port's unsharded
  stream on an elementwise objective and a trainable one;
* ASHA's rung sub-mesh: ``_asha_submesh_devices`` the reference's (1,
  then gcd 2 at 4 ranks), the streams bitwise the reference's sharded
  runs under random search and the unsharded run, chunked bitwise flat;
* every validation message of the reference's mesh options, and a mesh
  over several processes refused without the process group that holds
  its ranks (``tests/test_torch_mesh_ranks.py`` runs it over thread
  ranks).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
from hyperopt_tpu_torch import hp as thp
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.atpe import build_atpe_device_fn
from hyperopt_tpu_torch.device_loop import compile_fmin
from hyperopt_tpu_torch.ops import kernels as TK
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile
from hyperopt_tpu_torch.parallel.mesh import RankMesh, virtual_mesh
from hyperopt_tpu_torch.parallel.sharded import build_local_best, per_device_count

import test_torch_device_loop as DL
import test_torch_device_loop_asha as AS

KW = DL.KW
N_STARTUP = DL.N_STARTUP
NEAR_TIE = 1e-3
CAND = 4


def j_mesh(shape, axes):
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes)


def _pair(j_fn, t_fn, space, j_m, t_m, seed=3, **kw):
    j = j_compile_fmin(j_fn, space(jhp), mesh=j_m, **kw, **KW)(seed=seed)
    runner = compile_fmin(t_fn, space(thp), mesh=t_m, device="cpu", **kw, **KW)
    return j, runner(seed=seed), runner


def _unsharded(t_fn, space, seed=3, **kw):
    return compile_fmin(t_fn, space(thp), device="cpu", **kw, **KW)(seed=seed)


def _bitwise(a, b, fields=("values", "active", "losses")):
    return all(np.array_equal(a[f], b[f]) for f in fields)


CASES = {
    "quad": (DL.j_quad, DL.t_quad, DL.quad_space, 48),
    "cond": (DL.j_cond, DL.t_cond, DL.cond_space, 40),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cand_sharded_stream_matches_reference(case):
    j_fn, t_fn, space, n = CASES[case]
    j, t, runner = _pair(j_fn, t_fn, space, j_mesh((CAND,), ("cand",)), virtual_mesh(CAND),
                         max_evals=n, cand_axis="cand")
    assert t["n_evals"] == n
    DL.assert_streams_match(j, t, space)
    assert _bitwise(t, runner(seed=3))
    plain = _unsharded(t_fn, space, max_evals=n)
    # the prior steps are untouched: startup is the unsharded program's
    for f in ("values", "active", "losses"):
        assert np.array_equal(t[f][..., :N_STARTUP], plain[f][..., :N_STARTUP]), f
    assert not np.array_equal(t["values"][:, N_STARTUP:], plain["values"][:, N_STARTUP:])


def _first_departure(j, t, ps):
    jv, tv = np.asarray(j["values"]), t["values"]
    cat = np.zeros(ps.n_dims, bool)
    cat[ps.cat_idx] = True
    same = np.where(cat[:, None], tv == jv, np.isclose(tv, jv, rtol=DL.CONT_RTOL,
                                                       atol=DL.CONT_ATOL))
    bad = np.flatnonzero(~same.all(axis=0))
    return None if bad.size == 0 else int(bad[0])


def _reference_history(j, i, cap=128):
    """The reference's first ``i`` trials as the loop's carry."""
    D = np.asarray(j["values"]).shape[0]
    hist = [torch.zeros((D, cap)), torch.zeros((D, cap), dtype=torch.bool), torch.zeros(cap),
            torch.zeros(cap, dtype=torch.bool)]
    for h, f in zip(hist, ("values", "active", "losses")):
        h[..., :i] = torch.from_numpy(np.array(j[f])[..., :i])
    hist[3][:i] = True
    return hist


def _atpe_step_key(seed, i):
    return R.fold_in(R.fold_in(R.key(seed), 0), i)


def _assert_near_tie(ps, hist, key, jv, tv):
    """Each dim where the port's pick ``tv`` departs from the reference's
    ``jv`` (on the same history) is a near-tie of the port's ranks'
    winning scores: both picks are rank winners whose EI scores agree to
    NEAR_TIE."""
    fn = build_atpe_device_fn(ps, 25.0, base_n_ei=KW["n_EI_candidates"],
                              n_cand_cat=KW["n_EI_candidates_cat"])
    gamma, pw = fn.settings(hist[2], hist[3])[:2]
    fits = TK.fit_all_dims(ps.consts, *hist, gamma, 25.0, pw, pad_gamma=0.35,
                           above_cap=TK.DEFAULT_ABOVE_CAP)
    k_tpe = R.split(key, 3)[0]
    n_ei = int(np.clip(KW["n_EI_candidates"] * (1 + ps.n_dims / 20), KW["n_EI_candidates"], 256))
    local = build_local_best(ps, per_device_count(n_ei, CAND),
                             per_device_count(KW["n_EI_candidates_cat"], CAND))
    ranks = torch.stack([local(k_tpe, fits, 1, r) for r in range(CAND)])[:, 0].numpy()
    order = list(ps.cont_idx) + list(ps.cat_idx)  # the packed winners' dim order
    low = dict(zip(ps.cat_idx.tolist(), ps.int_low.tolist()))
    departed = [d for d in range(ps.n_dims)
                if (jv[d] != tv[d] if d in low else
                    not np.isclose(tv[d], jv[d], rtol=DL.CONT_RTOL, atol=DL.CONT_ATOL))]
    for d in departed:
        vals, scores = ranks[:, order.index(d), 0], ranks[:, order.index(d), 1]

        def score_of(v):
            hit = np.isclose(vals, v - low.get(d, 0), rtol=DL.CONT_RTOL, atol=DL.CONT_ATOL)
            assert hit.any(), (d, v, ranks[:, order.index(d)])
            return scores[np.argmax(hit)]

        assert abs(score_of(jv[d]) - score_of(tv[d])) < NEAR_TIE, (d, ranks)
    return departed


def test_atpe_cand_sharded_stream_matches_reference():
    """ATPE's sweep over 4 ranks inside the loop: the reference's stream up
    to its first departure, which must be a near-tie of the ranks' winning
    scores on the reference's own history at that step."""
    j, t, runner = _pair(DL.j_quad, DL.t_quad, DL.quad_space, j_mesh((CAND,), ("cand",)),
                         virtual_mesh(CAND), max_evals=48, cand_axis="cand", algo="atpe")
    ps = t_compile(DL.quad_space(thp), device="cpu")
    i = _first_departure(j, t, ps)
    n = t["n_evals"] if i is None else i
    assert n > N_STARTUP
    cut = {f: np.asarray(j[f])[..., :n] for f in ("values", "active", "losses")}
    DL.assert_streams_match(dict(cut, n_evals=n),
                            dict({f: t[f][..., :n] for f in cut}, n_evals=n), DL.quad_space)
    assert _bitwise(t, runner(seed=3))
    if i is None:
        return
    assert _assert_near_tie(ps, _reference_history(j, i), _atpe_step_key(3, i),
                            np.asarray(j["values"])[:, i], t["values"][:, i])


def test_atpe_cand_sharded_step_matches_reference_teacher_forced():
    """Every warm step of the reference's sharded ATPE stream, on its own
    history: the port's sharded step (settings, lock set and rolls,
    per-rank counts from the adapted candidate count, the categorical
    offset) at the step's key picks the reference's column, values within
    CONT_RTOL/CONT_ATOL and categoricals equal; a dim may differ only at a
    near-tie of the ranks' best scores."""
    n = 48
    j = j_compile_fmin(DL.j_quad, DL.quad_space(jhp), mesh=j_mesh((CAND,), ("cand",)),
                       max_evals=n, cand_axis="cand", algo="atpe", **KW)(seed=3)
    ps = t_compile(DL.quad_space(thp), device="cpu")
    step = build_atpe_device_fn(ps, 25.0, base_n_ei=KW["n_EI_candidates"],
                                n_cand_cat=KW["n_EI_candidates_cat"], mesh=virtual_mesh(CAND),
                                cand_axis="cand")
    jv_all, ja_all = np.asarray(j["values"]), np.asarray(j["active"])
    ties = []
    for i in range(N_STARTUP, n):
        hist = _reference_history(j, i)
        values, active = step(_atpe_step_key(3, i), *hist, 1)
        tv, ta = values[:, 0].numpy(), active[:, 0].numpy()
        departed = _assert_near_tie(ps, hist, _atpe_step_key(3, i), jv_all[:, i], tv)
        if departed:
            ties.append((i, departed))
        else:
            assert np.array_equal(ta, ja_all[:, i]), i
    # a near-tie is rare: most of the warm steps are held dim for dim
    assert len(ties) <= (n - N_STARTUP) // 4, ties


def test_cand_sharded_early_stop_matches_reference():
    j, t, _ = _pair(DL.j_quad, DL.t_quad, DL.quad_space, j_mesh((CAND,), ("cand",)),
                    virtual_mesh(CAND), max_evals=96, cand_axis="cand", loss_threshold=0.2)
    assert N_STARTUP < t["n_evals"] == j["n_evals"] < 96
    DL.assert_streams_match(j, t, DL.quad_space)


def test_two_d_mesh_matches_reference():
    """``trial`` 2 x ``cand`` 4 at B=4: the trial axis placed, the sweep
    over 4 ranks, against the reference's 2 x 4 device mesh."""
    j, t, _ = _pair(DL.j_quad, DL.t_quad, DL.quad_space, j_mesh((2, CAND), ("trial", "cand")),
                    virtual_mesh((2, CAND), ("trial", "cand")), max_evals=48, batch_size=4,
                    cand_axis="cand")
    DL.assert_streams_match(j, t, DL.quad_space)
    # the trial axis changes nothing: the cand-only program's stream
    cand_only = compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=48, batch_size=4,
                             mesh=virtual_mesh(CAND), trial_axis=None, cand_axis="cand",
                             device="cpu", **KW)(seed=3)
    assert _bitwise(t, cand_only)


@pytest.mark.parametrize("algo", ["tpe", "atpe"])
def test_cand_sharded_seed_sweep_is_bitwise_each_solo_run(algo):
    runner = compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=32, batch_size=2,
                          mesh=virtual_mesh((2, CAND), ("trial", "cand")), cand_axis="cand",
                          algo=algo, device="cpu", **KW)
    for seed, out in zip((3, 4), runner(seed=[3, 4])):
        assert _bitwise(out, runner(seed=seed)), seed


def _trainable():
    """A per-trial trainable of elementwise math (``compile_fmin``'s
    objective, mapped over the batch)."""
    from hyperopt_tpu_torch.device_loop import TrainableObjective

    def init(k, cfg):
        return {"w": R.uniform(k, (3,)) + cfg["x"]}

    def step(s, cfg, epoch):
        return {"w": s["w"] - 0.1 * (s["w"] - cfg["y"])}

    def loss(s, cfg):
        return (s["w"][0] - 1.0) ** 2 + 0.1 * cfg["u"]

    return TrainableObjective(init, step, loss, n_epochs=3)


@pytest.mark.parametrize("n", [2, 4])
def test_trial_axis_is_bitwise_the_unsharded_stream(n):
    for fn, kw in ((DL.t_quad, {}), (_trainable(), {}), (DL.t_quad, dict(algo="anneal"))):
        opts = dict(max_evals=48, batch_size=8, device="cpu", **kw, **KW)
        sharded = compile_fmin(fn, DL.quad_space(thp), mesh=virtual_mesh(n, "trial"), **opts)
        flat = compile_fmin(fn, DL.quad_space(thp), **opts)
        assert _bitwise(sharded(seed=3), flat(seed=3)), (n, kw)
        for seed, out in zip((3, 4), sharded(seed=[3, 4])):
            assert _bitwise(out, flat(seed=seed)), (n, kw, seed)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_asha_rung_blocks_match_reference(n):
    """The ASHA bracket with ``trial_axis``: the reference's sub-mesh size
    (gcd of the smallest rung's width 2 and the axis), its sharded stream
    bitwise under random search on the elementwise trainable, the
    unsharded stream bitwise, and the chunked run bitwise the flat one."""
    opts = dict(AS.KW, algo="rand")
    jr = j_compile_fmin(AS.j_objective(), AS.space(jhp), mesh=j_mesh((n,), ("trial",)),
                        trial_axis="trial", **opts)
    tr = compile_fmin(AS.t_objective(), AS.space(thp), mesh=virtual_mesh(n, "trial"),
                      trial_axis="trial", device="cpu", **opts)
    assert tr._asha_submesh_devices == jr._asha_submesh_devices == min(n, 2)
    out = tr(seed=AS.SEED)
    AS.assert_stream_equal(jr(seed=AS.SEED), out)
    AS.assert_stream_equal(AS.flat_result(), out)
    chunked = compile_fmin(AS.t_objective(), AS.space(thp), mesh=virtual_mesh(n, "trial"),
                           chunk_size=16, device="cpu", **opts)(seed=AS.SEED)
    AS.assert_stream_equal(chunked, out)


def test_asha_rung_blocks_under_tpe_match_reference():
    opts = dict(AS.KW, algo="tpe")
    j = j_compile_fmin(AS.j_objective(), AS.space(jhp), mesh=j_mesh((4,), ("trial",)),
                       **opts)(seed=AS.SEED)
    t = compile_fmin(AS.t_objective(), AS.space(thp), mesh=virtual_mesh(4, "trial"),
                     device="cpu", **opts)(seed=AS.SEED)
    np.testing.assert_array_equal(t["rung_of"], np.asarray(j["rung_of"]))
    np.testing.assert_allclose(t["values"], np.asarray(j["values"]), rtol=AS.CONT_RTOL,
                               atol=AS.CONT_ATOL)


# (compile_fmin options, the reference's message); the mesh is a 1-D
# ``cand`` mesh unless the options name ``mesh2`` (trial x cand)
REFUSALS = [
    (dict(cand_axis="cand", mesh=None), "requires a mesh"),
    (dict(cand_axis="nope"), "not an axis"),
    (dict(cand_axis="cand", algo="anneal"), "no candidate sweep"),
    (dict(cand_axis="cand", algo="rand"), "no candidate sweep"),
    (dict(cand_axis="cand", joint_ei=True), "factorized"),
    (dict(cand_axis="cand", batch_size=4, trial_axis="trail"), "not an axis"),
    (dict(batch_size=4, trial_axis=None), "nothing to shard"),
    (dict(mesh2=True, batch_size=3), "must be a multiple of mesh axis"),
    (dict(asha=True, cand_axis="cand", trial_axis=None), "asha= does not compose with cand_axis"),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_mesh_options_refused_as_the_reference_refuses(case):
    opts, message = REFUSALS[case]
    opts = dict(opts)
    if opts.pop("mesh2", False):
        j_m, t_m = j_mesh((2, 4), ("trial", "cand")), virtual_mesh((2, 4), ("trial", "cand"))
    else:
        j_m, t_m = j_mesh((4,), ("cand",)), virtual_mesh(4)
    if "mesh" in opts:
        j_m = t_m = opts.pop("mesh")
    if opts.pop("asha", False):
        j_args, t_args = (AS.j_objective(), AS.space(jhp)), (AS.t_objective(), AS.space(thp))
        opts = dict(AS.KW, **opts)
    else:
        j_args, t_args = (DL.j_quad, DL.quad_space(jhp)), (DL.t_quad, DL.quad_space(thp))
        opts = dict(dict(max_evals=16), **opts)
    with pytest.raises(ValueError, match=message):
        j_compile_fmin(*j_args, mesh=j_m, **opts)
    with pytest.raises(ValueError, match=message):
        compile_fmin(*t_args, mesh=t_m, device="cpu", **opts)


def test_mesh_options_the_reference_accepts():
    """A cand-only mesh needs no trial axis at B=1; ``trial_axis=None``
    opts out at B>1; ASHA's rungs need not divide the axis."""
    for kw in (dict(max_evals=8), dict(max_evals=16, batch_size=4, trial_axis=None)):
        assert callable(compile_fmin(DL.t_quad, DL.quad_space(thp), mesh=virtual_mesh(4),
                                     cand_axis="cand", device="cpu", **kw))
    runner = compile_fmin(AS.t_objective(), AS.space(thp), mesh=virtual_mesh(3, "trial"),
                          device="cpu", **AS.KW)
    assert runner._asha_submesh_devices == 1


def test_a_mesh_over_processes_is_refused():
    """A mesh over several processes runs its ``trial`` blocks, its
    ``cand`` slabs and its ASHA rungs as captured graphs with host gathers
    between them, given the process group that holds its ranks: without
    one, each raises naming ``multihost.initialize``.  A mesh that is not
    a RankMesh is refused."""
    procs = RankMesh((2,), ("cand",), (0, 1))
    with pytest.raises(RuntimeError, match="is not one of its ranks"):
        compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=8, mesh=procs, cand_axis="cand",
                     device="cpu")
    with pytest.raises(RuntimeError, match="is not one of its ranks"):
        compile_fmin(AS.t_objective(), AS.space(thp), mesh=RankMesh((2,), ("trial",), (0, 1)),
                     device="cpu", **AS.KW)
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=8, batch_size=2,
                     mesh=RankMesh((2,), ("trial",), (0, 1)), device="cpu")
    one_rank = compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=24,
                            mesh=RankMesh((1,), ("cand",), (0,)), cand_axis="cand",
                            device="cpu", **KW)(seed=1)
    # one rank is the unsharded step at the key fold_in(k, 0): its own stream
    assert np.isfinite(one_rank["losses"]).all()
    with pytest.raises(TypeError, match="RankMesh"):
        compile_fmin(DL.t_quad, DL.quad_space(thp), max_evals=8, mesh=j_mesh((4,), ("cand",)),
                     cand_axis="cand", device="cpu")
