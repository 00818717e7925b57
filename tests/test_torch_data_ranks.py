"""The models' data axis over ranks: ``make_population_train_step(mesh=)``
and ``population_objective(mesh=)`` of TinyLM and ResNet with the batch
split over the ``cand`` ranks, the ranks simulated by threads inside this
process (``test_torch_population_ranks.ThreadRanks``: ``process_line``
names each thread's line, ``fetch_global`` joins the line's blocks and
counts the gathers).

Each rank runs the gradient half on its rows, meets its line in one
gather of the gradients and losses per step, and runs the update half on
the combined gradients (the mean of the slices' means, in rank order).
Every rank of a line must be bitwise the in-process twin
(``_population.split_twin``) on its member block, and the twin is held,
from weights carried over by ``convert``, against the port's unsharded
step and against the reference's ``make_population_train_step`` on the
same inputs.  The split batch sums in another order than the whole one,
so those two holds are tolerances, the model test files' own:

* PARAM_ATOL 1e-6 on parameters and momenta after two steps (measured
  1.5e-7 against the unsharded step, 2.8e-7 against the reference, at
  n = 2 and 4);
* LOSS_RTOL 1e-5 on the losses (measured 1.5e-7 and 5.8e-7).

Sizes are the test files' small ones: TinyLM vocab 16, d_model 16, two
heads, one layer, 16 sequences of 16; ResNet ``stage_sizes=(1, 1, 1)``,
width 8, 16 images of 8x8; populations of four, their weights and data
drawn with numpy (the reference's init is held in the model test files).  The spawned ``gloo``
ranks of ``dcn_check`` stage I (``tests/test_torch_parallel.py``) and J
(``-m slow`` here) check the real collective.
"""

import functools

import numpy as np
import pytest

import jax
import torch

from hyperopt_tpu.models import resnet as JR
from hyperopt_tpu.models import transformer as JT
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch.models import _population as TP
from hyperopt_tpu_torch.models import resnet as TR
from hyperopt_tpu_torch.models import transformer as TT
from hyperopt_tpu_torch.parallel import dcn_check as t_dcn, mesh as TM

from test_torch_population_ranks import thread_ranks  # noqa: F401 -- the fixture

PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
LM = dict(vocab=16, d_model=16, n_heads=2, n_layers=1, max_len=16)
NET = dict(stage_sizes=(1, 1, 1), width=8)
POP, STEPS = 4, 2
LR = np.array([0.3, 0.1, 0.03, 0.01], np.float32)
WD = np.array([1e-5, 1e-4, 1e-3, 1e-2], np.float32)
TWO_D = ("trial", "cand")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _carried(jm, dummy, seed):
    """Four members of ``jm``'s parameters in the reference's layout, drawn
    with numpy from its parameter shapes (kernels and embeddings normal at
    1/sqrt(fan-in), biases zero, norm scales one): the weights both
    packages are given."""
    shapes = jax.eval_shape(lambda k: jm.init(k, dummy)["params"], jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "embedding"):
            fan_in = s.shape[-1] if name == "embedding" else int(np.prod(s.shape[:-1]))
            return (rng.standard_normal((POP,) + s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.full((POP,) + s.shape, 1.0 if name == "scale" else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tinylm():
    """The reference TinyLM, four members and 16 sequences of 16 tokens."""
    jm = JT.TinyLM(**LM)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, LM["vocab"], (16, 16)).astype(np.int32)
    return dict(jm=jm, pop=_carried(jm, np.zeros((1, 16), np.int32), 0), data=(tokens,),
                convert=convert.tinylm_params_from_numpy, port=TT, model=lambda: TT.TinyLM(**LM),
                dtypes=(torch.int64,))


@pytest.fixture(scope="module")
def resnet():
    """The reference tiny ResNet, four members and 16 labelled 8x8 images."""
    jm = JR.ResNet(**NET)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (16,)).astype(np.int32)
    return dict(jm=jm, pop=_carried(jm, np.zeros((1, 8, 8, 3), np.float32), 0),
                data=(images, labels), convert=convert.resnet_params_from_numpy, port=TR,
                model=lambda: TR.ResNet(**NET), dtypes=(None, torch.int64))


def _port_data(fam):
    return tuple(_t(d, dt) for d, dt in zip(fam["data"], fam["dtypes"]))


def _run(step, params, lr, wd, data, n_steps=STEPS):
    """``n_steps`` of ``step`` from ``params`` and zero momenta: the final
    params and momenta and each step's losses."""
    momentum = TP.zeros_like(params)
    losses = []
    for _ in range(n_steps):
        params, momentum, loss = step(params, momentum, lr, wd, *data)
        losses.append(loss)
    return params, momentum, losses


def _block(tree, n_blocks, b):
    w = next(iter(tree.values())).shape[0] // n_blocks
    return {k: v[b * w:(b + 1) * w] for k, v in tree.items()}


def _equal(a, b):
    (pa, ma, la), (pb, mb, lb) = a, b
    return (all(torch.equal(pa[k], pb[k]) and torch.equal(ma[k], mb[k]) for k in pa)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def _close(got, want, what):
    (gp, gm, gl), (wp, wm, wl) = got, want
    for k in wp:
        for g, w, label in ((gp[k], wp[k], "params"), (gm[k], wm[k], "momentum")):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what}: {label} {k}")
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=LOSS_RTOL,
                                   err_msg=f"{what}: losses")


def _reference(fam):
    """The reference's unsharded steps from the same weights, in the
    port's layout (computed once per family)."""
    if "reference" not in fam:
        jstep = JR.make_population_train_step(fam["jm"]) if fam["port"] is TR else \
            JT.make_population_train_step(fam["jm"])
        jp, jmom, losses = fam["pop"], jax.tree.map(np.zeros_like, fam["pop"]), []
        for _ in range(STEPS):
            jp, jmom, jl = _np(jstep(jp, jmom, LR, WD, *fam["data"]))
            losses.append(jl)
        fam["reference"] = (fam["convert"](jp, device="cpu"), fam["convert"](jmom, device="cpu"),
                            losses)
    return fam["reference"]


@pytest.mark.parametrize("family,shape", [
    ("tinylm", (1, 2)), ("tinylm", (2, 2)),
    # ResNet's step over real ranks runs in the fast tier as stage I
    # (tests/test_torch_parallel.py): bitwise its twin, within DATA_TOL of
    # the unsharded step
    pytest.param("resnet", (1, 2), marks=pytest.mark.slow)])
def test_the_step_over_data_ranks_is_its_twin(thread_ranks, request, family, shape):
    """Over a ``trial`` x ``cand`` mesh of thread ranks each rank passes its
    member block and splits the batch over its ``cand`` line: every rank
    bitwise the twin on its block, the ranks of a line bitwise each other,
    one gather per step on every rank and none other; the twin (all
    blocks) within the tolerances of the port's unsharded step and of the
    reference's."""
    fam = request.getfixturevalue(family)
    n_trial, n_data = shape
    mesh = TM.RankMesh(shape, TWO_D, range(n_trial * n_data))
    params = fam["convert"](fam["pop"], device="cpu")
    data = _port_data(fam)
    lr, wd = _t(LR), _t(WD)
    ranks = thread_ranks(mesh.size)

    def rank_run():
        b = mesh.axis_index("trial", ranks.local.rank)
        step = fam["port"].make_population_train_step(fam["model"](), mesh=mesh, device="cpu")
        return b, _run(step, _block(params, n_trial, b), _block({"x": lr}, n_trial, b)["x"],
                       _block({"x": wd}, n_trial, b)["x"], data)

    got = ranks.run(rank_run)
    assert ranks.gathers == [STEPS] * mesh.size
    assert sum(ranks.line_gathers.values()) == STEPS * mesh.size
    assert all(len(line) == n_data for _, line in ranks.line_gathers)
    plain = fam["port"].make_population_train_step(fam["model"](), device="cpu")
    twin = TP.split_twin(plain, n_data)
    blocks = [_run(twin, _block(params, n_trial, b), _block({"x": lr}, n_trial, b)["x"],
                   _block({"x": wd}, n_trial, b)["x"], data) for b in range(n_trial)]
    for b, out in got:
        assert _equal(out, blocks[b])
    # the twin over the whole population (one block is all of it), against
    # the unsharded steps
    whole = blocks[0]
    if n_trial > 1:
        whole = _run(twin, params, lr, wd, data)
        assert all(torch.equal(whole[0][k], torch.cat([blk[0][k] for blk in blocks]))
                   for k in params)
    unsharded = _run(plain, params, lr, wd, data)
    assert not _equal(whole, unsharded)  # the split really summed in another order
    _close(whole, unsharded, "against the port's unsharded step")
    _close(whole, _reference(fam), "against the reference's step")


@pytest.mark.parametrize("family,shape", [
    ("tinylm", (1, 2)), ("tinylm", (2, 2)),
    # ResNet's objective over real ranks runs in the fast tier as stage I's
    # fmin (tests/test_torch_parallel.py)
    pytest.param("resnet", (1, 2), marks=pytest.mark.slow)])
def test_population_objective_over_data_ranks(thread_ranks, family, shape):
    """``population_objective(mesh=)`` in every rank: the same float on
    each (a population of one, each ``trial`` row passing its own), that of
    the objective on the twin, within LOSS_RTOL of the unsharded
    objective; one gather per step."""
    port = TT if family == "tinylm" else TR
    kw = dict(n_steps=2, batch_size=16, seed=3, device="cpu",
              **({"image_size": 8} if family == "resnet" else {}))
    mesh = TM.RankMesh(shape, TWO_D, range(shape[0] * shape[1]))
    cfg = {"lr": 0.05, "wd": 1e-4}
    ranks = thread_ranks(mesh.size)
    got = ranks.run(lambda: port.population_objective(mesh=mesh, **kw)(cfg))
    assert len(set(got)) == 1 and ranks.gathers == [2] * mesh.size
    twin = port.population_objective(wrap_step=functools.partial(TP.split_twin, n=shape[1]),
                                     **kw)
    assert got[0] == twin(cfg)
    np.testing.assert_allclose(got[0], port.population_objective(**kw)(cfg), rtol=LOSS_RTOL)


def test_the_twin_on_one_slice_is_the_unsharded_step(tinylm):
    """``split_twin(step, 1)`` is the step itself, bit for bit: the halves
    compute what the fused step computes."""
    plain = TT.make_population_train_step(TT.TinyLM(**LM), device="cpu")
    params = convert.tinylm_params_from_numpy(tinylm["pop"], device="cpu")
    data = _port_data(tinylm)
    assert _equal(_run(TP.split_twin(plain, 1), params, _t(LR), _t(WD), data),
                  _run(plain, params, _t(LR), _t(WD), data))


@pytest.mark.parametrize("name", ["I_tinylm", pytest.param("I_resnet", marks=pytest.mark.slow)])
def test_a_combine_that_drops_a_slice_breaks_the_tolerance(name):
    """``dcn_check.data_probe`` at the CPU's sizes: the split step within
    DATA_TOL of the unsharded step, a combine that keeps one slice's
    gradients and drops the other's far outside it (measured 0.17 for
    TinyLM, 0.54 for ResNet, against 1.2e-7 and 2.5e-7 for the split), and
    the first step's combined gradients within 1e-5 of the largest
    gradient from the whole batch's (measured 4.6e-7 and 7.8e-7 of it)."""
    probe = t_dcn.data_probe(torch.device("cpu"), name)
    atol = t_dcn.DATA_TOL["cpu"][name.split("_", 1)[1]][0]
    assert probe["split"] <= atol < probe["fault"], probe
    assert probe["grad0"] <= 1e-5 * probe["grad0_scale"], probe


def test_a_failed_gather_raises(monkeypatch, tinylm):
    """A gather that fails raises out of the step: no rank falls back to
    the whole batch."""
    from hyperopt_tpu_torch.parallel import multihost as TMH

    def broken(tree, sharded=False, group=None):
        raise RuntimeError("the line's gather failed")

    monkeypatch.setattr(TM, "process_line", lambda mesh, axis, what: (2, 0, (0, 1)))
    monkeypatch.setattr(TMH, "fetch_global", broken)
    step = TT.make_population_train_step(TT.TinyLM(**LM), mesh=TM.RankMesh((1, 2), TWO_D, (0, 1)),
                                         device="cpu")
    params = convert.tinylm_params_from_numpy(tinylm["pop"], device="cpu")
    with pytest.raises(RuntimeError, match="the line's gather failed"):
        step(params, TP.zeros_like(params), _t(LR), _t(WD), *_port_data(tinylm))


@pytest.mark.slow
def test_four_spawned_ranks_split_the_batch_bitwise(tmp_path):
    """Stage J on four ``gloo`` ranks: TinyLM's step on the ``(2, 2)``
    mesh, member blocks on ``trial`` and batch halves on ``cand``, each
    run twice, every rank bitwise the twin on its block and its line
    partner, one all_gather per step and no other collective; the values
    those of the twin in this process."""
    out = t_dcn.launch(world=4, timeout=400, device="cpu", workdir=tmp_path, stages="J")
    result = next(ln for ln in out.splitlines() if ln.startswith("DCN RESULT"))
    for field in ("data_axis={'J': (2, 2)}", "data_gathers={'J_tinylm': 2}",
                  "data_matches_twin=True", "data_deterministic=True", "data_lines_agree=True",
                  "ranks_agree=True"):
        assert field in result, (field, result)
    assert t_dcn.parse_values(out) == t_dcn.data_twin_values(torch.device("cpu"), "J")


@pytest.mark.slow
def test_four_way_split_against_the_references_sharded_step(thread_ranks, tinylm):
    """The port's step over eight thread ranks of a ``(2, 4)`` ``trial`` x
    ``cand`` mesh (member blocks of two, the 16 sequences in four slices)
    against the reference's sharded step on ``mesh_from_spec((2, 4),
    ("trial", "cand"))`` of the 8 forced host devices, the reference's
    ``test_transformer_population_sharded_step`` layout: within the
    file's tolerances."""
    from hyperopt_tpu.parallel.mesh import mesh_from_spec

    jstep = JT.make_population_train_step(tinylm["jm"], mesh=mesh_from_spec((2, 4), TWO_D))
    jp, jmom, jl = tinylm["pop"], jax.tree.map(np.zeros_like, tinylm["pop"]), []
    for _ in range(STEPS):
        jp, jmom, loss = _np(jstep(jp, jmom, LR, WD, *tinylm["data"]))
        jl.append(loss)
    mesh = TM.RankMesh((2, 4), TWO_D, range(8))
    params = convert.tinylm_params_from_numpy(tinylm["pop"], device="cpu")
    data = _port_data(tinylm)
    ranks = thread_ranks(8)

    def rank_run():
        b = mesh.axis_index("trial", ranks.local.rank)
        step = TT.make_population_train_step(TT.TinyLM(**LM), mesh=mesh, device="cpu")
        return b, _run(step, _block(params, 2, b), _t(LR[2 * b:2 * b + 2]),
                       _t(WD[2 * b:2 * b + 2]), data)

    got = dict(ranks.run(rank_run))
    assert ranks.gathers == [STEPS] * 8
    whole = tuple([{k: torch.cat([got[b][i][k] for b in (0, 1)]) for k in params}
                   for i in (0, 1)]) + ([torch.cat([got[0][2][s], got[1][2][s]])
                                         for s in range(STEPS)],)
    _close(whole, (convert.tinylm_params_from_numpy(jp, device="cpu"),
                   convert.tinylm_params_from_numpy(jmom, device="cpu"), jl),
           "against the reference's sharded step")
