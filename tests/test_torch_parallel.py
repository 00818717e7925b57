"""The port's rank-sharded suggest (``hyperopt_tpu_torch.parallel``) against
the reference's device-sharded one (``hyperopt_tpu.parallel``) on the CPU.

The reference shards over a sub-mesh of the 8 forced host devices
(``tests/conftest.py``); the port's ranks are processes, or the ranks of
a ``virtual_mesh`` computed in turn inside this one.  The histories are
the reference's ``dcn_check`` histories (40 completed trials of a
continuous and of a mixed space), made once by the reference and carried
into the port's ``Trials`` doc for doc, so both packages fit the same
history.

* The mesh helpers, ``per_device_count``, ``shard_ids_for_host`` and the
  single-process ``multihost`` give the reference's results.
* The fold-in identity: a one-rank step at key ``k`` is the unsharded
  step at ``fold_in(k, 0)`` with the same counts and above cap, bitwise,
  in the reference and in the port.
* One rank against the reference's one-device mesh, two virtual ranks
  against its two-device sub-mesh (B=4, 32 candidates per rank): the
  docs equal but for the suggested values, the categorical values and
  every ``active`` equal, the continuous values within the TPE parity
  tolerance of ``tests/test_torch_tpe.py`` (CONT_RTOL/CONT_ATOL: the
  port's candidate draws are the reference's up to float32 roundings of
  ndtri, exp and log, which the draws amplify past 2 ulp), so every
  winning candidate is the reference's.
* ``fmin`` with ``algo=sharded_suggest``: plain, speculative, and the
  saturation warning on an all-categorical space.
* One spawned two-rank ``gloo`` run (``dcn_check.launch``, a ``file://``
  store under ``tmp_path``) of stages A and B: rank 0's suggestions
  bitwise the two virtual ranks', one ``all_gather`` and no other
  collective per step, and nothing of ``torch.distributed`` left in this
  process.  A second of stages C-E (``compile_fmin``'s ``trial`` axis,
  ``compile_sha`` and ``compile_pbt`` over the two ranks): every stage
  bitwise its unsharded run in this process, one gather of the losses
  (and one of the states) per boundary.  The full check (B=256, the KS
  line, stages C-E) runs under ``-m slow``.
* ``fetch_global`` across two spawned ranks: the marked leaves tiled in
  rank order by one ``all_gather``, the others local; in one process,
  the local fetch whatever is marked.
"""

import copy
import json
import os
import threading
import warnings
from functools import partial

import numpy as np
import pytest

import jax
import torch

import hyperopt_tpu_torch as H
from hyperopt_tpu import tpe_jax
from hyperopt_tpu.jax_trials import (host_key, obs_buffer_for as j_buffer,
                                     packed_space_for as j_space)
from hyperopt_tpu.parallel import dcn_check as j_dcn, mesh as JM, multihost as JMH
from hyperopt_tpu.parallel import sharded as JS
from hyperopt_tpu_torch import hp as thp, random as R, tpe as T
from hyperopt_tpu_torch.parallel import dcn_check as t_dcn, mesh as TM, multihost as TMH
from hyperopt_tpu_torch.parallel import sharded as TS
from hyperopt_tpu_torch.torch_trials import (obs_buffer_for as t_buffer,
                                             packed_space_for as t_space)

# tests/test_torch_tpe.py's parity tolerance for continuous picks
CONT_RTOL, CONT_ATOL = 5e-5, 1e-6
B, N_PER_RANK = 4, 32
KINDS = {"cont": (j_dcn._seeded_history, t_dcn.cont_space, t_dcn.CONT_LABELS),
         "mixed": (j_dcn._seeded_history_mixed, t_dcn.mixed_space, t_dcn.MIXED_LABELS)}
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def _histories(kind):
    """The reference's seeded history and the same docs in the port."""
    make, space, labels = KINDS[kind]
    j_domain, j_trials = make()
    t_domain = H.Domain(lambda cfg: 0.0, space(thp), device="cpu")
    t_trials = H.Trials()
    t_trials.insert_trial_docs(copy.deepcopy(j_trials.trials))
    t_trials.refresh()
    return j_domain, j_trials, t_domain, t_trials, labels


def _j_mesh(n):
    return JM.mesh_from_spec((n,), ("cand",), devices=jax.devices()[:n])


def _assert_docs_match(j_docs, t_docs, t_domain):
    """Docs equal but for the values; categorical values equal,
    continuous ones within the TPE parity tolerance."""
    ps = t_space(t_domain)
    cat = {ps.labels[d] for d in ps.cat_idx}
    strip = lambda docs: [dict(d, misc=dict(d["misc"], vals=None)) for d in docs]  # noqa: E731
    assert strip(j_docs) == strip(t_docs)
    for jd, td in zip(j_docs, t_docs):
        jv, tv = jd["misc"]["vals"], td["misc"]["vals"]
        assert jv.keys() == tv.keys()
        for lab in jv:
            assert len(jv[lab]) == len(tv[lab])
            if lab in cat:
                assert jv[lab] == tv[lab], lab
            else:
                np.testing.assert_allclose(tv[lab], jv[lab], rtol=CONT_RTOL, atol=CONT_ATOL)


def test_mesh_helpers_match_the_references():
    ranks = range(8)
    tm = TM.mesh_from_spec((2, 4), ("trial", "cand"), ranks=ranks)
    jm = JM.mesh_from_spec((2, 4), ("trial", "cand"))
    assert dict(jm.shape) == tm.shape == {"trial": 2, "cand": 4}
    assert np.array_equal(np.vectorize(lambda d: d.id)(jm.devices), tm.devices)
    assert tm.axis_ranks("cand", 5) == (4, 5, 6, 7) and tm.axis_index("cand", 5) == 1
    assert tm.axis_ranks("trial", 5) == (1, 5) and tm.axis_index("trial", 5) == 1
    with pytest.raises(ValueError):
        TM.mesh_from_spec((4, 4), ("trial", "cand"), ranks=ranks)
    with pytest.raises(ValueError):
        JM.mesh_from_spec((4, 4), ("trial", "cand"))
    assert dict(JM.default_mesh().shape) == TM.default_mesh(ranks=ranks).shape == {"cand": 8}
    assert dict(JM.study_mesh(3).shape) == TM.study_mesh(3, ranks=ranks).shape == {"study": 3}
    with pytest.raises(ValueError):
        TM.study_mesh(9, ranks=ranks)
    for members in range(1, 13):
        (jsub, jk), (tsub, tk) = (JM.rung_submesh(JM.default_mesh(), "cand", members),
                                  TM.rung_submesh(TM.default_mesh(ranks=ranks), "cand", members))
        assert jk == tk and [d.id for d in jsub.devices.flat] == list(tsub.ranks)
    assert (TM.CAND_AXIS, TM.TRIAL_AXIS, TM.STUDY_AXIS) == (
        JM.CAND_AXIS, JM.TRIAL_AXIS, JM.STUDY_AXIS)


def test_counts_and_shard_ids_match_the_references():
    for total in (1, 7, 24, 128, 1000):
        for n in (1, 2, 3, 8):
            assert TS.per_device_count(total, n) == JS.per_device_count(total, n)
    ids = list(range(11))
    for count in (1, 2, 3):
        for index in range(count):
            assert (TMH.shard_ids_for_host(ids, index, count)
                    == JMH.shard_ids_for_host(ids, index, count))


def test_multihost_single_process_degenerates():
    assert not torch.distributed.is_initialized()
    assert not TMH.is_multihost()
    assert TMH.process_index() == 0 and TMH.process_count() == 1
    assert TM.device_count() == 1 and TM.default_mesh().shape == {"cand": 1}
    v = np.ones((2, 3))
    a = np.ones((2, 3), bool)
    v2, a2 = TMH.broadcast_configs(v, a)
    np.testing.assert_array_equal(np.asarray(v2), v)
    np.testing.assert_array_equal(np.asarray(a2), a)
    assert TMH.shard_ids_for_host([1, 2, 3, 4], 0, 2) == [1, 3]
    assert TMH.shard_ids_for_host([1, 2, 3, 4], 1, 2) == [2, 4]
    assert TMH.shard_ids_for_host([1, 2, 3]) == [1, 2, 3]
    assert TMH.initialize() is False and TMH.initialize("file:///nowhere", 1, 0) is False
    tree = {"a": torch.arange(3), "b": [torch.ones(2, dtype=torch.bool), 1.5], "c": None}
    got = TMH.fetch_global(tree)
    want = JMH.fetch_global({"a": jax.numpy.arange(3), "b": [jax.numpy.ones(2, bool), 1.5],
                             "c": None})
    assert got["c"] is None and want["c"] is None
    for g, w in ((got["a"], want["a"]), (got["b"][0], want["b"][0]), (got["b"][1], want["b"][1])):
        assert isinstance(g, np.ndarray) and np.array_equal(g, w)
    assert not torch.distributed.is_initialized()


def test_a_mesh_of_two_ranks_needs_a_process_group():
    _, _, t_domain, t_trials, _ = _histories("cont")
    fn = TS.build_sharded_suggest_fn(t_space(t_domain), TM.default_mesh(ranks=range(2)), 8,
                                     0.25, 25, 1.0)
    with pytest.raises(RuntimeError, match="virtual_mesh"):
        fn(R.key(0), *t_buffer(t_domain, t_trials).device_arrays(), 2)


def _sharded_docs(kind, n_ranks):
    """``sharded_suggest`` at seed 5 on the reference's n-device sub-mesh
    and on n ranks of the port (a virtual mesh for two)."""
    j_domain, j_trials, t_domain, t_trials, labels = _histories(kind)
    ids = j_trials.new_trial_ids(B)
    j_docs = JS.sharded_suggest(ids, j_domain, j_trials, seed=5, mesh=_j_mesh(n_ranks),
                                n_EI_per_device=N_PER_RANK)
    t_mesh = TM.default_mesh() if n_ranks == 1 else TM.virtual_mesh(n_ranks)
    t_docs = TS.sharded_suggest(ids, t_domain, t_trials, seed=5, mesh=t_mesh,
                                n_EI_per_device=N_PER_RANK)
    _assert_docs_match(j_docs, t_docs, t_domain)
    return (j_domain, j_trials, t_domain, t_trials, labels), ids, t_docs


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_rank_against_the_references_one_device_mesh(kind):
    """One rank against the reference's one-device mesh: the same
    winners, the same docs.  Then the fold-in identity on the steps those
    asks ran: one rank at key k is the unsharded step at fold_in(k, 0)
    with the same counts and above cap, bitwise -- in the reference
    (against ``tpe_jax.build_suggest_fn``), then in the port (against
    ``tpe.build_suggest_fn``)."""
    (j_domain, j_trials, t_domain, t_trials, _), _, _ = _sharded_docs(kind, 1)
    a_cap = tpe_jax._resolve_above_cap(None)
    (j_sh,) = j_domain._sharded_tpe_cache.values()
    (t_sh,) = t_domain._sharded_tpe_cache.values()
    j_arrays = j_buffer(j_domain, j_trials).device_arrays(pow2_cap=a_cap)
    j_un = tpe_jax.build_suggest_fn(j_space(j_domain), N_PER_RANK, 0.25, 25, 1.0,
                                    n_cand_cat=24, above_cap=a_cap)
    k = host_key(5)
    jv, ja = (np.asarray(x) for x in j_sh(k, *j_arrays, batch=B))
    jv0, ja0 = (np.asarray(x) for x in j_un(jax.random.fold_in(k, 0), *j_arrays, batch=B))
    assert np.array_equal(jv, jv0) and np.array_equal(ja, ja0)

    t_arrays = t_buffer(t_domain, t_trials).device_arrays(pow2_cap=a_cap)
    t_un = T.build_suggest_fn(t_space(t_domain), N_PER_RANK, 0.25, 25, 1.0, n_cand_cat=24,
                              above_cap=a_cap)
    tk = R.key(5)
    tv, ta = t_sh(tk, *t_arrays, B)
    tv0, ta0 = t_un(R.fold_in(tk, 0), *t_arrays, B)
    assert torch.equal(tv, tv0) and torch.equal(ta, ta0)
    assert np.array_equal(ja, ta.numpy())
    np.testing.assert_allclose(tv.numpy(), jv, rtol=CONT_RTOL, atol=CONT_ATOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_two_virtual_ranks_against_the_references_two_device_sub_mesh(kind):
    """Two virtual ranks against the reference's two-device sub-mesh: the
    same winners, the same docs; and the second rank's slab won
    somewhere (one rank alone suggests otherwise)."""
    (_, _, t_domain, t_trials, labels), ids, t_docs = _sharded_docs(kind, 2)
    one = TS.sharded_suggest(ids, t_domain, t_trials, seed=5, mesh=TM.default_mesh(),
                             n_EI_per_device=N_PER_RANK)
    assert t_dcn.doc_values(one, labels) != t_dcn.doc_values(t_docs, labels)


def _fmin(algo, space, n, seed=0):
    trials = H.Trials()
    best = H.fmin(space[1] if isinstance(space, tuple) else (lambda x: (x - 3.0) ** 2),
                  space[0] if isinstance(space, tuple) else space, algo=algo, max_evals=n,
                  trials=trials, rstate=np.random.default_rng(seed), device="cpu",
                  show_progressbar=False)
    return best, trials


@pytest.mark.parametrize("speculative", [0, 4])
def test_sharded_suggest_end_to_end(speculative):
    best, trials = _fmin(partial(TS.sharded_suggest, speculative=speculative),
                         thp.uniform("x", -10, 10), 45)
    assert len(trials) == 45
    assert trials.best_trial["result"]["loss"] < 2.5
    assert "x" in best
    assert H.parallel.suggest is TS.sharded_suggest is H.parallel.sharded_suggest


def test_sharded_suggest_mixed_conditional_space():
    space = thp.choice("c", [
        {"kind": "a", "lr": thp.loguniform("lr_a", -5, 0)},
        {"kind": "b", "x": thp.uniform("x_b", 0, 1), "n": thp.randint("n_b", 5)},
    ])

    def obj(cfg):
        return cfg["lr"] if cfg["kind"] == "a" else cfg["x"]

    _, trials = _fmin(TS.sharded_suggest, (space, obj), 40, seed=1)
    for t in trials.trials:
        vals = t["misc"]["vals"]
        if vals["c"][0] == 0:
            assert vals["lr_a"] and not vals["x_b"]
        else:
            assert vals["x_b"] and vals["n_b"]
    assert np.isfinite(trials.best_trial["result"]["loss"])


def test_speculative_degrades_on_saturated_categorical():
    """The saturation guard, judged on the TOTAL categorical draw: on the
    all-categorical NAS-Bench space speculation turns off with one
    warning, and the asks are the plain sharded path's."""
    from hyperopt_tpu_torch.models import nasbench

    domain = H.Domain(nasbench.objective, nasbench.space(), device="cpu")
    trials = H.Trials()
    docs = H.rand.suggest(trials.new_trial_ids(25), domain, trials, seed=0)
    for doc in docs:
        doc["state"] = H.JOB_STATE_DONE
        cfg = {k: v[0] for k, v in doc["misc"]["vals"].items()}
        doc["result"] = {"status": "ok", "loss": nasbench.objective(cfg)}
    trials.insert_trial_docs(docs)
    trials.refresh()
    algo = partial(TS.sharded_suggest, speculative=8)
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            (d,) = algo(trials.new_trial_ids(1), domain, trials, seed=50 + i)
            out.append(d["misc"]["vals"])
    assert len([w for w in caught if "speculative" in str(w.message)]) == 1
    plain = [TS.sharded_suggest(trials.new_trial_ids(1), domain, trials, seed=50 + i)[0]
             ["misc"]["vals"] for i in range(3)]
    assert out == plain


def _no_distributed_state():
    return not torch.distributed.is_initialized() and not any(k in os.environ for k in DIST_ENV)


def test_two_spawned_ranks_are_bitwise_the_virtual_ranks(tmp_path):
    """Two ``gloo`` ranks in two processes (stages A and B at B=16, 8
    candidates per rank): rank 0's suggestions bitwise the two virtual
    ranks' of this process, one all_gather and no other collective per
    step (counted inside the ranks), the ranks agreeing, and no process
    group or rendezvous variable left in this process."""
    assert _no_distributed_state()
    out = t_dcn.launch(world=2, timeout=120, device="cpu", batch=16, n_per_rank=8,
                       workdir=tmp_path, stages="AB")
    assert "gathers_per_step=[1, 1, 1]" in out and "ranks_agree=True" in out, out[-2000:]
    spawned = t_dcn.parse_values(out)
    virtual, _, _ = t_dcn.run_stages("cpu", 16, 8, TM.virtual_mesh(2))
    assert spawned == {k: virtual[k] for k in ("A", "B")}
    # one rank's slab alone gives other suggestions: both ranks took part
    alone, _, _ = t_dcn.run_stages("cpu", 16, 8, TM.default_mesh())
    assert alone["A"] != virtual["A"]
    assert _no_distributed_state()


def test_two_spawned_ranks_run_the_populations_bitwise(tmp_path):
    """Stages C-G and I on two ``gloo`` ranks: C-E at the reference's sizes
    (every population two wide): ``compile_fmin``'s trial axis (64
    evaluations, each rank one column of every batch), ``compile_sha``
    and ``compile_pbt`` over the ranks, each run twice and bitwise the
    unsharded run of the same program in this process; one all_gather
    of the losses per loop step, one of the losses and one of the states
    per rung and per exploit.  F, ``compile_fmin``'s ``cand`` axis over
    the ranks for TPE and ATPE (one all_gather of the packed winners per
    model step, 44 of 64), and G, ``asha=`` over the ``trial`` axis (two
    per rung, 18 in 3 brackets), each run twice and bitwise its
    ``virtual_mesh`` run, which the ranks run too.  I, the models' data
    axis over the ranks of a ``(1, 2)`` mesh: TinyLM's and ResNet's steps
    (one all_gather per step) bitwise their in-process twin, in the ranks
    and here, and within the tolerances of the unsharded step, and
    ``fmin`` over ResNet's ``population_objective(mesh=)`` in both ranks
    (one all_gather per population step) bitwise the same ``fmin`` over
    the twin's objective here, its losses within DATA_FMIN_RTOL (1e-5) of
    the unsharded objective's at the ranks' configurations.  No other collective
    (counted inside the ranks); nothing of ``torch.distributed`` left
    here."""
    assert _no_distributed_state()
    cpu = torch.device("cpu")
    here = {}

    def twins():  # I's twins and the unsharded objective, here while the ranks run
        here["twin"] = t_dcn.data_twin_values(cpu, "I")
        here["diff"] = t_dcn.data_unsharded_diff(cpu, here["twin"]["I_fmin"])

    beside = threading.Thread(target=twins)
    beside.start()
    try:
        out = t_dcn.launch(world=2, timeout=300, device="cpu", workdir=tmp_path,
                           stages="CDEFGI")
    finally:
        beside.join()
    result = next(ln for ln in out.splitlines() if ln.startswith("DCN RESULT"))
    for field in ("loop_matches_unsharded=True", "sha_matches_unsharded=True",
                  "pbt_matches_unsharded=True", "loop_deterministic=True",
                  "sha_deterministic=True", "pbt_deterministic=True", "ranks_agree=True",
                  "boundaries={'C': 32, 'D': 2, 'E': 4}",
                  "gathers_by_stage={'C': 32, 'D': 4, 'E': 8}", "loop_launches_by_rank=[0, 0]",
                  "cand_matches_virtual=True", "cand_deterministic=True",
                  "asha_matches_virtual=True", "asha_deterministic=True",
                  "mesh_gathers={'F_tpe': 44, 'F_atpe': 44, 'G': 18}",
                  "mesh_launches_by_rank={'F_tpe': [0, 0], 'F_atpe': [0, 0], 'G': [0, 0]}",
                  "data_axis={'I': (1, 2)}",
                  "data_gathers={'I_tinylm': 2, 'I_resnet': 2, 'I_fmin': 12}",
                  "data_launches_by_rank={'I_fmin': [0, 0]}", "data_matches_twin=True",
                  "data_deterministic=True", "data_lines_agree=True"):
        assert field in result, (field, result)
    assert "ks=" not in result  # stages A and B did not run
    spawned = t_dcn.parse_values(out)
    assert {st: spawned[st] for st in "CDE"} == t_dcn.unsharded_population("cpu", 2)
    assert sorted(spawned) == ["C", "D", "E", "F_atpe", "F_tpe", "G", "I_fmin", "I_resnet",
                               "I_tinylm"]
    # the twins' fmin configurations are the ranks' once the values agree
    assert {k: spawned[k] for k in ("I_tinylm", "I_resnet", "I_fmin")} == here["twin"]
    assert here["diff"] <= t_dcn.DATA_FMIN_RTOL["cpu"]
    # the PBT schedule really exploited across the ranks: both members
    # end on the rank-0 or rank-1 member that won
    assert len(set(spawned["E"]["state"])) == 1
    assert _no_distributed_state()


FETCH_RANK = """
import json, sys
import torch
from hyperopt_tpu_torch.parallel import dcn_check, multihost

rank = int(sys.argv[1])
assert multihost.initialize(sys.argv[2], num_processes=2, process_id=rank)
tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank,
        "b": [torch.tensor([rank == 0, True]), torch.full((2,), float(rank))],
        "c": None, "d": 1.5, "e": torch.arange(3, dtype=torch.int64)[None] * (rank + 1)}
marks = {"a": True, "b": [True, False], "c": False, "d": False, "e": True}
counter = dcn_check.CollectiveCounter().install()
out, counts = counter.step(lambda: multihost.fetch_global(tree, sharded=marks))
local, local_counts = counter.step(lambda: multihost.fetch_global(tree))
counter.uninstall()
print("FETCH " + json.dumps({
    "a": out["a"].tolist(), "b0": out["b"][0].tolist(), "b1": out["b"][1].tolist(),
    "c": out["c"], "d": float(out["d"]), "e": out["e"].tolist(), "e_dtype": str(out["e"].dtype),
    "counts": counts, "local_a": local["a"].tolist(), "local_counts": local_counts}))
torch.distributed.destroy_process_group()
"""


def test_fetch_global_tiles_the_marked_leaves_across_two_spawned_ranks(tmp_path):
    """Two ``gloo`` ranks each fetch a tree of their blocks: the marked
    leaves come back joined along the leading axis in rank order (float,
    bool and int64 blocks through one ``all_gather`` of one byte buffer),
    the unmarked leaves are the rank's own, None and scalars pass
    through, and a fetch with nothing marked makes no collective."""
    import subprocess
    import sys

    script = tmp_path / "fetch_rank.py"
    script.write_text(FETCH_RANK)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(next(ln for ln in o.splitlines() if ln.startswith("FETCH "))[6:])
           for o in outs]
    blocks = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(2)]
    for rank, g in enumerate(got):
        assert g["a"] == np.concatenate(blocks).tolist()
        assert g["b0"] == [True, True, False, True]
        assert g["b1"] == [float(rank)] * 2  # unmarked: the rank's own
        assert g["c"] is None and g["d"] == 1.5
        assert g["e"] == [[0, 1, 2], [0, 2, 4]] and g["e_dtype"] == "int64"
        assert g["counts"] == [1, 0] and g["local_counts"] == [0, 0]
        assert g["local_a"] == blocks[rank].tolist()


def test_fetch_global_in_one_process_is_the_local_fetch():
    """With no process group every leaf is fetched locally, marked or not,
    in new memory."""
    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, dtype=torch.bool), 2.5], "c": None}
    for sharded in (True, {"a": True, "b": [True, False], "c": False}):
        got = TMH.fetch_global(tree, sharded=sharded)
        assert np.array_equal(got["a"], tree["a"].numpy()) and got["c"] is None
        assert np.array_equal(got["b"][0], [True, True]) and got["b"][1] == 2.5
        got["a"][0] = 7.0
        assert tree["a"][0] == 0.0  # not an alias of the tensor


@pytest.mark.slow
def test_four_spawned_ranks_run_the_two_axis_mesh_bitwise(tmp_path):
    """Stage H on four ``gloo`` ranks: the ``trial`` 2 x ``cand`` 2 mesh,
    its line groups built by their own ranks; ``compile_fmin`` at B=2
    (a model step gathers on the rank's ``cand`` line, then on its
    ``trial`` line: 2 x 22 + 10 startup steps), ``compile_sha`` and
    ``compile_pbt`` over the ``trial`` axis (two per rung and per
    exploit), each run twice and bitwise its ``virtual_mesh((2, 2))``
    run, which the ranks and this process both run."""
    assert _no_distributed_state()
    out = t_dcn.launch(world=4, timeout=400, device="cpu", workdir=tmp_path, stages="H")
    result = next(ln for ln in out.splitlines() if ln.startswith("DCN RESULT"))
    for field in ("two_axes_matches_virtual=True", "two_axes_deterministic=True",
                  "ranks_agree=True", "mesh_gathers={'H_fmin': 54, 'H_sha': 6, 'H_pbt': 8}"):
        assert field in result, (field, result)
    assert t_dcn.parse_values(out) == t_dcn.virtual_mesh_values("cpu", 4, "H")
    assert _no_distributed_state()


@pytest.mark.slow
def test_two_spawned_ranks_full_check():
    """``dcn_check.launch()`` at the reference's size: stages A and B at
    B=256, 32 candidates per rank, the KS distances against the
    unsharded path under 0.2; stages C-E bitwise their unsharded runs."""
    out = t_dcn.launch(world=2, timeout=300, device="cpu")
    assert "DCN RESULT procs=2 stages=ABCDE mesh={cand: 2} batch=256" in out, out[-2000:]
    assert "ks=" in out and "mixed_ks=" in out and "deterministic=True" in out
    for field in ("loop_matches_unsharded=True", "sha_matches_unsharded=True",
                  "pbt_matches_unsharded=True"):
        assert field in out, field
