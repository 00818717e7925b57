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
  store under ``tmp_path``): rank 0's suggestions bitwise the two
  virtual ranks', one ``all_gather`` and no other collective per step,
  and nothing of ``torch.distributed`` left in this process.  The full
  check at B=256 with its KS line runs under ``-m slow``.
"""

import copy
import os
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
                       workdir=tmp_path)
    assert "gathers_per_step=[1, 1, 1]" in out and "ranks_agree=True" in out, out[-2000:]
    spawned = t_dcn.parse_values(out)
    virtual, _, _ = t_dcn.run_stages("cpu", 16, 8, TM.virtual_mesh(2))
    assert spawned == {k: virtual[k] for k in ("A", "B")}
    # one rank's slab alone gives other suggestions: both ranks took part
    alone, _, _ = t_dcn.run_stages("cpu", 16, 8, TM.default_mesh())
    assert alone["A"] != virtual["A"]
    assert _no_distributed_state()


@pytest.mark.slow
def test_two_spawned_ranks_full_check():
    """``dcn_check.launch()`` at the reference's size: B=256, 32
    candidates per rank, the KS distances against the unsharded path
    under 0.2."""
    out = t_dcn.launch(world=2, timeout=300, device="cpu")
    assert "DCN RESULT procs=2 mesh={cand: 2} batch=256" in out, out[-2000:]
    assert "ks=" in out and "mixed_ks=" in out and "deterministic=True" in out
