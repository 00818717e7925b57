"""The real-rank paths of the port's population runners, with the ranks
simulated by threads inside this process.

Over a ``trial`` mesh of real ranks (a ``RankMesh`` that is not virtual)
``compile_pbt``, ``compile_sha`` and ``compile_fmin`` give rank ``r``
member (or batch) block ``r`` and meet in ``parallel.multihost.
fetch_global`` between two graphs.  Here ``process_block`` names each
thread's rank and ``fetch_global`` exchanges the blocks of a line's ranks
through shared slots between two barriers, so two, three and four ranks
run without a process group (the spawned ``gloo`` ranks of ``tests/test_torch_parallel.py``
and ``dcn_check`` stages C-E check the real collective).  On the
reference's elementwise ``train_fn`` and objective every rank's result
is bitwise the single-process run, with one gather of the losses (and
one of the member states) per boundary: per loop step, rung and exploit.
"""

import collections
import threading

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.device_loop import compile_fmin
from hyperopt_tpu_torch.hyperband import compile_sha
from hyperopt_tpu_torch.parallel import dcn_check, mesh as TM, multihost as TMH
from hyperopt_tpu_torch.pbt import compile_pbt
from hyperopt_tpu_torch.utils import tree_map

BOUNDS = {"lr": (1e-3, 1.0)}
THETA0 = np.linspace(0.5, 5.0, 8, dtype=np.float32)


class ThreadRanks:
    """``n`` ranks as threads: ``process_block`` and ``process_line`` give
    each thread its own rank's width, position and line (the tuple of the
    line's ranks stands for its process group), and ``fetch_global(...,
    sharded=True, group=line)`` joins the blocks of the line's ranks in
    line order, between barriers keyed by the line (and counts the
    gathers per rank, and per rank and line)."""

    def __init__(self, n):
        self.n = n
        self.lock = threading.Lock()
        self.barriers, self.slots = {}, {}
        self.gathers = [0] * n
        self.line_gathers = collections.Counter()
        self.local = threading.local()
        self.real_fetch = TMH.fetch_global

    def process_block(self, mesh, axis, what):
        rank = self.local.rank
        return int(mesh.shape[axis]), mesh.axis_index(axis, rank), mesh.axis_ranks(axis, rank)

    def _line(self, line):
        with self.lock:
            if line not in self.barriers:
                self.barriers[line] = threading.Barrier(len(line), timeout=120)
                self.slots[line] = [None] * len(line)
            return self.barriers[line], self.slots[line]

    def fetch_global(self, tree, sharded=False, group=None):
        if sharded is False:
            return self.real_fetch(tree)
        assert sharded is True and isinstance(group, tuple)
        rank = self.local.rank
        barrier, slots = self._line(group)
        slots[group.index(rank)] = tree_map(lambda x: x.detach().cpu().clone(), tree)
        self.gathers[rank] += 1
        self.line_gathers[rank, group] += 1
        barrier.wait()
        out = tree_map(lambda *xs: torch.cat(xs).numpy(), *slots)
        barrier.wait()
        return out

    def run(self, make_and_run):
        """``make_and_run()`` on every rank at once: each rank's result."""
        results, errors = [None] * self.n, []

        def rank_main(rank):
            self.local.rank = rank
            try:
                results[rank] = make_and_run()
            except BaseException as e:  # noqa: BLE001 -- reported below
                errors.append(e)
                with self.lock:
                    for barrier in self.barriers.values():
                        barrier.abort()

        threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise errors[0]
        return results


@pytest.fixture
def thread_ranks(monkeypatch):
    def make(n):
        ranks = ThreadRanks(n)
        monkeypatch.setattr(TM, "process_block", ranks.process_block)
        monkeypatch.setattr(TM, "process_line", ranks.process_block)
        monkeypatch.setattr(TMH, "fetch_global", ranks.fetch_global)
        return ranks

    return make


def rank_mesh(n):
    return TM.RankMesh((n,), (TM.TRIAL_AXIS,), range(n))


def assert_trees_equal(a, b):
    assert tree_map(lambda x, y: torch.equal(torch.as_tensor(x), torch.as_tensor(y)), a, b) \
        == tree_map(lambda _: True, a)


def nested_train_fn(state, hypers, key):
    """Several leaves of several dtypes, elementwise per member."""
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
    return {"theta": theta, "aux": (state["aux"][0] + 1, state["aux"][1] * 0.5)}, \
        (theta - 0.7) ** 2


def nested_state(n):
    return {"theta": torch.from_numpy(np.linspace(0.5, 5.0, n, dtype=np.float32)),
            "aux": (torch.arange(n, dtype=torch.int32),
                    torch.ones((n, 3), dtype=torch.float32))}


# ---------------------------------------------------------------------------
# compile_pbt
# ---------------------------------------------------------------------------

PBT_KW = dict(pop_size=8, exploit_every=2, n_rounds=4, device="cpu")


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_pbt_over_ranks_is_bitwise_the_unsharded_schedule(thread_ranks, n_ranks):
    ranks = thread_ranks(n_ranks)
    want = compile_pbt(dcn_check.member_train_fn, {"theta": THETA0}, BOUNDS, **PBT_KW)(seed=13)
    outs = ranks.run(lambda: compile_pbt(dcn_check.member_train_fn, {"theta": THETA0}, BOUNDS,
                                         mesh=rank_mesh(n_ranks), **PBT_KW)(seed=13))
    for out in outs:
        np.testing.assert_array_equal(out["loss_history"], want["loss_history"])
        np.testing.assert_array_equal(out["log_hypers"], want["log_hypers"])
        assert out["best_index"] == want["best_index"]
        # every rank holds the whole final population
        assert torch.equal(out["state"]["theta"], want["state"]["theta"])
    assert ranks.gathers == [2 * PBT_KW["n_rounds"]] * n_ranks


def test_pbt_over_ranks_on_a_nested_state_and_a_resumed_segment(thread_ranks):
    ranks = thread_ranks(2)
    plain = compile_pbt(nested_train_fn, nested_state(8), BOUNDS, **PBT_KW)
    want = plain(seed=3)
    want2 = plain(seed=3, init=want)

    def both_segments():
        runner = compile_pbt(nested_train_fn, nested_state(8), BOUNDS, mesh=rank_mesh(2),
                             **PBT_KW)
        first = runner(seed=3)
        return first, runner(seed=3, init=first)

    for first, second in ranks.run(both_segments):
        assert_trees_equal(first["state"], want["state"])
        np.testing.assert_array_equal(second["loss_history"], want2["loss_history"])
        assert_trees_equal(second["state"], want2["state"])
    assert ranks.gathers == [4 * PBT_KW["n_rounds"]] * 2


# ---------------------------------------------------------------------------
# compile_sha
# ---------------------------------------------------------------------------

SHA_KW = dict(n_configs=8, eta=2, steps_per_rung=2, device="cpu")


@pytest.mark.parametrize("n_ranks,replicas", [(2, 1), (4, 1), (4, 2), (3, 1)])
def test_sha_over_ranks_is_bitwise_the_unsharded_ladder(thread_ranks, n_ranks, replicas):
    """Each rung on its gcd sub-mesh of the ranks (8 -> 4 -> 2 -> 1 configs:
    the ranks it leaves out wait the rung out; at 3 ranks every rung runs on
    rank 0), the ranking and the survivors replicated on every rank."""
    ranks = thread_ranks(n_ranks)
    init = {"theta": np.linspace(0.5, 5.0, 8 * replicas, dtype=np.float32)}
    kw = dict(SHA_KW, replicas=replicas)
    want = compile_sha(dcn_check.member_train_fn, init, BOUNDS, **kw)(seed=9)
    runners = []

    def run():
        runner = compile_sha(dcn_check.member_train_fn, init, BOUNDS, mesh=rank_mesh(n_ranks),
                             **kw)
        runners.append(runner)
        return runner(seed=9)

    for out in ranks.run(run):
        for key in ("best_loss", "best_hypers", "best_index", "rungs", "replica_bests"):
            assert out[key] == want[key], key
        assert torch.equal(out["state"]["theta"], want["state"]["theta"])
    assert [m.size for m in runners[0]._rung_meshes] == [
        np.gcd(replicas * p, n_ranks) for p, _, _ in runners[0]._ladder]
    assert ranks.gathers == [2 * len(runners[0]._ladder)] * n_ranks


def test_sha_over_ranks_refuses_a_checkpoint(thread_ranks, tmp_path):
    """Durable mode is single-process, as in the reference."""
    ranks = thread_ranks(2)

    def run():
        runner = compile_sha(dcn_check.member_train_fn, {"theta": THETA0}, BOUNDS,
                             mesh=rank_mesh(2), **SHA_KW)
        with pytest.raises(ValueError, match="single-process"):
            runner(seed=9, checkpoint=str(tmp_path / "sha.npz"))
        return True

    assert ranks.run(run) == [True, True]
    assert ranks.gathers == [0, 0]


# ---------------------------------------------------------------------------
# compile_fmin's trial axis
# ---------------------------------------------------------------------------

def quad_space():
    return dcn_check.cont_space(hp)


def fmin_run(variant, mesh):
    """One ``compile_fmin`` run of ``variant`` at batch 4 (over ``mesh``, or
    unsharded with None), as comparable arrays."""
    kw = dict(max_evals=40, batch_size=4, device="cpu", n_startup_jobs=8)
    if mesh is not None:
        kw.update(mesh=mesh, trial_axis=TM.TRIAL_AXIS)
    if variant == "tpe":
        out = compile_fmin(dcn_check.loop_fn, quad_space(), **kw)(seed=2)
    elif variant == "anneal":
        out = compile_fmin(dcn_check.loop_fn, quad_space(), algo="anneal", **kw)(seed=2)
    elif variant == "seeds":
        outs = compile_fmin(dcn_check.loop_fn, quad_space(), **kw)(seed=[2, 5])
        return [(o["losses"], o["values"], o["n_evals"]) for o in outs]
    elif variant == "early_stop":
        out = compile_fmin(dcn_check.loop_fn, quad_space(), loss_threshold=0.5, **kw)(seed=2)
    else:  # chunked, resumed from its own bundle
        out = compile_fmin(dcn_check.loop_fn, quad_space(), chunk_size=12, **kw)(seed=2)
    return out["losses"], out["values"], out["n_evals"]


@pytest.mark.parametrize("variant", ["tpe", "anneal", "seeds", "early_stop", "chunked"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_fmin_trial_axis_over_ranks_is_bitwise_the_unsharded_loop(thread_ranks, n_ranks,
                                                                  variant):
    """Every rank draws the same batch, evaluates its ``4 / n`` columns,
    and writes the same history after one gather per step: the stream is
    the unsharded one, bit for bit (a seed sweep, an early stop and a
    chunked run too)."""
    ranks = thread_ranks(n_ranks)
    want = fmin_run(variant, None)
    for got in ranks.run(lambda: fmin_run(variant, rank_mesh(n_ranks))):
        for g, w in zip(np.asarray(got, dtype=object).ravel(),
                        np.asarray(want, dtype=object).ravel()):
            np.testing.assert_array_equal(g, w)
    n_steps = want[0][2] // 4 if variant == "seeds" else want[2] // 4
    if variant == "early_stop":
        assert n_steps < 10 and all(g >= n_steps for g in ranks.gathers)
    else:
        assert ranks.gathers == [10] * n_ranks, ranks.gathers


def test_fmin_trial_axis_over_ranks_refusals():
    """Over processes, the batch must divide by the ranks, and without the
    process group that holds the ranks the loop does not build -- a
    ``trial`` x ``cand`` mesh no more than a ``trial`` one."""
    with pytest.raises(ValueError, match="must be a multiple of mesh axis 'trial' size 2"):
        compile_fmin(dcn_check.loop_fn, quad_space(), max_evals=8, batch_size=3,
                     mesh=rank_mesh(2), device="cpu")
    with pytest.raises(RuntimeError, match="rank 0 of 1\\) is not one of its ranks"):
        compile_fmin(dcn_check.loop_fn, quad_space(), max_evals=8, batch_size=2,
                     mesh=TM.RankMesh((2, 2), ("trial", "cand"), range(4)), cand_axis="cand",
                     device="cpu")
    with pytest.raises(RuntimeError, match="is not one of its ranks"):
        compile_fmin(dcn_check.loop_fn, quad_space(), max_evals=8, batch_size=2,
                     mesh=rank_mesh(2), device="cpu")


# ---------------------------------------------------------------------------
# the mesh helpers and the models' placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,spans", [
    (None, False),
    (TM.virtual_mesh(2, TM.TRIAL_AXIS), False),
    (TM.RankMesh((1,), (TM.TRIAL_AXIS,), (0,)), False),
    (TM.RankMesh((2,), (TM.TRIAL_AXIS,), (0, 1)), True),
])
def test_over_processes(mesh, spans):
    assert TM.over_processes(mesh) is spans


@pytest.mark.parametrize("mesh,axis,error,match", [
    (TM.RankMesh((2,), ("cand",), (0, 1)), TM.TRIAL_AXIS, ValueError, "has no 'trial' axis"),
    (TM.RankMesh((2, 2), ("trial", "cand"), range(4)), "cand", RuntimeError,
     "rank 0 of 1\\) is not one of its ranks"),
    (TM.RankMesh((2,), ("trial",), (0, 1)), TM.TRIAL_AXIS, RuntimeError,
     "rank 0 of 1\\) is not one of its ranks"),
])
def test_process_block_refusals(mesh, axis, error, match):
    """A missing axis, and a mesh (of one axis or two) whose ranks this
    process's group does not hold."""
    with pytest.raises(error, match=match):
        TM.process_block(mesh, axis, "x")
    with pytest.raises(error, match=match):
        TM.process_line(mesh, axis, "x")


@pytest.mark.parametrize("rank", range(4))
def test_process_block_and_line_on_a_two_axis_mesh(monkeypatch, rank):
    """On a ``trial`` x ``cand`` mesh of four ranks each rank's block is its
    ``trial`` coordinate and its slab its ``cand`` coordinate, each with
    the group of the line through it (a proper line: a group of its own
    ranks, built here as a stand-in)."""
    mesh = TM.RankMesh((2, 2), ("trial", "cand"), range(4))
    monkeypatch.setattr(TM, "process_count", lambda: 4)
    monkeypatch.setattr(TM, "process_index", lambda: rank)
    for line in ((0, 2), (1, 3), (0, 1), (2, 3)):
        mesh._groups[line] = ("group", line)
    trial, cand = TM.process_block(mesh, "trial", "x"), TM.process_line(mesh, "cand", "x")
    assert trial == (2, rank // 2, ("group", (rank % 2, rank % 2 + 2)))
    assert cand == (2, rank % 2, ("group", (rank - rank % 2, rank - rank % 2 + 1)))


def _echo_step(pop_params, pop_momentum, lr, wd, *data):
    return pop_params, pop_momentum, lr + wd


@pytest.mark.parametrize("mesh,axes,pop,batch,error,match", [
    (TM.virtual_mesh((2, 4), ("trial", "cand")), ("trial", "cand"), 4, 8, None, None),
    (TM.virtual_mesh((2, 4), ("trial", "cand")), ("trial", "cand"), 3, 8, ValueError,
     "population's dimension 0 \\(3\\) must divide by the 'trial' mesh axis size 2"),
    (TM.virtual_mesh((2, 4), ("trial", "cand")), ("trial", "cand"), 4, 6, ValueError,
     "data batch's dimension 0 \\(6\\) must divide by the 'cand' mesh axis size 4"),
    (TM.virtual_mesh(2, "trial"), ("trial", None), 2, 5, None, None),
    (TM.virtual_mesh(2, "trial"), ("trial", "cand"), 2, 4, ValueError,
     "data_axis 'cand' is not an axis of the mesh"),
    (TM.RankMesh((2,), ("trial",), (0, 1)), ("trial", None), 3, 5, None, None),
    (TM.RankMesh((2, 1), ("trial", "cand"), (0, 1)), ("trial", "cand"), 3, 5, None, None),
    (TM.RankMesh((1, 2), ("trial", "cand"), (0, 1)), ("trial", "cand"), 2, 4,
     RuntimeError, "is not one of its ranks: join a process group"),
    (object(), ("trial", "cand"), 2, 4, TypeError, "RankMesh"),
])
def test_the_models_placement_on_a_mesh(mesh, axes, pop, batch, error, match):
    """``mesh=`` of the models' population steps: the reference's axes and
    divisibility, the unsharded step on a virtual mesh, a rank's own block
    of members over processes (no width to divide), and a data axis over
    processes refused outside a process group of its ranks."""
    from hyperopt_tpu_torch.models._population import on_mesh

    params = {"w": torch.arange(pop * 2, dtype=torch.float32).reshape(pop, 2)}
    args = (params, params, torch.ones(pop), torch.ones(pop), torch.zeros(batch, 3),
            torch.zeros(batch, dtype=torch.int64))
    if error is not None:
        with pytest.raises(error, match=match):
            on_mesh(_echo_step, mesh, *axes, "step")(*args)
        return
    assert on_mesh(_echo_step, mesh, *axes, "step")(*args)[0] is params
    assert on_mesh(_echo_step, None, *axes, "step") is _echo_step


@pytest.mark.parametrize("stages", ["", "ABX"])
def test_dcn_check_refuses_unknown_stages(stages):
    with pytest.raises(SystemExit):
        dcn_check.main(["0", "2", "file:///nowhere", "--device", "cpu", "--stages", stages])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("stage", ["C", "D", "E"])
def test_dcn_population_stages_on_a_virtual_trial_mesh(stage):
    """Stages C-E on ``virtual_mesh(2, "trial")`` in this process (the
    reference's default ``"constraint"`` mode: the placed, unsharded
    program) bitwise the unsharded runs the spawned ranks are held to."""
    runner = dcn_check.population_runners("cpu", 2, TM.virtual_mesh(2, TM.TRIAL_AXIS))[stage]
    got = dcn_check.population_values(stage, runner(seed=dcn_check.POP_SEEDS[stage]))
    assert got == dcn_check.unsharded_population("cpu", 2, stage)[stage]
