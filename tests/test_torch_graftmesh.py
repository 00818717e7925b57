"""The study and population axes of the port inside one process, against
the port's own unsharded engine and the JAX reference's ``graftmesh``
(``tests/test_graftmesh.py``).

The port shards with :func:`hyperopt_tpu_torch.parallel.mesh.virtual_mesh`
(a shard is a block of slots or members owned by this process); the
reference runs on the ``cpu_mesh`` fixture's forced host devices.

* Serve: the reference's scenario cut to 24 studies (churn, an
  out-of-order tell, a multi-tell backlog and a NaN tenant), at 1, 2, 3
  and 4 shards, is bitwise the port's unsharded service, with the same
  evictions and round dispatches; past one shard it restacks single
  shards and uploads fewer bytes.  Against the reference's sharded
  service the streams agree at ``test_torch_serve_batched.py``'s rule (a
  warm pick may part only where the reference's own llr margin is below
  NEAR_TIE; prior draws are the reference's bits on this space, which
  has no log-space dim), before the backlog's drain round, for the
  reason stated there.
* ``slot_capacity(shards=)`` and the striped slot picks are the
  reference's; a clean shard keeps its tensors across a restack.
* ``compile_pbt`` and ``compile_sha`` with ``shard_mode="shard_map"`` are
  bitwise their unsharded schedules under the reference's elementwise
  ``train_fn``, and meet ``test_torch_pbt.py``'s rule against the
  reference's sharded runs; the rungs' shard counts are the reference's.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu import hp as jhp
from hyperopt_tpu.exceptions import StudyPoisoned as JStudyPoisoned
from hyperopt_tpu.exceptions import StudyQuarantined as JStudyQuarantined
from hyperopt_tpu.hyperband import compile_sha as j_compile_sha
from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer, host_key
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu.pbt import compile_pbt as j_compile_pbt
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu.serve.batched import slot_capacity as j_slot_capacity
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.exceptions import StudyPoisoned, StudyQuarantined
from hyperopt_tpu_torch.hyperband import compile_sha
from hyperopt_tpu_torch.parallel.mesh import (STUDY_AXIS, TRIAL_AXIS, RankMesh,
                                              in_process_shards, shard_devices, virtual_mesh)
from hyperopt_tpu_torch import pbt as t_pbt_module
from hyperopt_tpu_torch.pbt import compile_pbt
from hyperopt_tpu_torch.serve import SuggestService
from hyperopt_tpu_torch.serve.batched import ShardedBatchState, slot_capacity

from test_torch_pbt import BOUNDS, assert_match, quad_train_fn
from test_torch_serve import NEAR_TIE
from test_torch_serve_batched import CONT_ATOL, CONT_RTOL

SPACE = {"x": hp.uniform("x", -5.0, 5.0), "c": hp.choice("c", [0, 1, 2])}
J_SPACE = {"x": jhp.uniform("x", -5.0, 5.0), "c": jhp.choice("c", [0, 1, 2])}
ALGO_KW = dict(n_cand=8, n_cand_cat=4)
N_STARTUP = 2
N_STUDIES = 24
MAX_BATCH = 32
#: rounds of the scenario before the backlog's drain round
ROUNDS_BEFORE_DRAIN = 4
POISON = (StudyPoisoned, StudyQuarantined, JStudyPoisoned, JStudyQuarantined)


def loss_fn(vals):
    return (vals["x"] - 1.0) ** 2 / 10 + 0.1 * vals["c"]


def t_service(mesh, max_batch=MAX_BATCH):
    return SuggestService(SPACE, max_batch=max_batch, background=False,
                          n_startup_jobs=N_STARTUP, mesh=mesh, device="cpu", **ALGO_KW)


def j_service(mesh, max_batch=MAX_BATCH):
    return JService(J_SPACE, max_batch=max_batch, background=False, n_startup_jobs=N_STARTUP,
                    mesh=mesh, **ALGO_KW)


def serve_scenario(svc, n_studies=N_STUDIES):
    """The reference's acceptance scenario (``tests/test_graftmesh.py``)
    on ``svc``: churn, an out-of-order tell, a multi-tell backlog and a
    NaN tenant.  Returns ``(log, counters, quarantined)``; ``log`` maps
    each study to its (history count, suggestion) per ask, and tags the
    asks of the rounds before the drain."""
    log = {}
    n_round = [0]

    def drive(handles, rounds):
        for _ in range(rounds):
            n_round[0] += 1
            before = {h.name: svc.scheduler.study(h.name).buf.count for h in handles}
            futs = [(h, h.ask_async()) for h in handles]
            svc.pump()
            for h, f in futs:
                tid, vals = f.result(timeout=60)
                log.setdefault(h.name, []).append(
                    (before[h.name], vals, n_round[0] <= ROUNDS_BEFORE_DRAIN))
                h.tell(tid, loss_fn(vals))

    handles = [svc.create_study(f"s{i:02d}", seed=400 + i) for i in range(n_studies)]
    drive(handles, 2)
    # churn: a quarter leaves mid-run, replacements join on the freed slots
    for h in handles[: n_studies // 4]:
        h.close()
    survivors = handles[n_studies // 4:]
    joined = [svc.create_study(f"j{i:02d}", seed=600 + i) for i in range(n_studies // 4)]
    drive(survivors + joined, 2)
    assert n_round[0] == ROUNDS_BEFORE_DRAIN
    # an out-of-order tell dirties its slot
    ooo = survivors[0]
    st = svc.scheduler.study(ooo.name)
    t_hi = st.next_tid
    ooo.tell(t_hi + 1, 0.9, vals={"x": 0.5, "c": 1})
    ooo.tell(t_hi, 0.7, vals={"x": -0.5, "c": 0})
    st.next_tid = t_hi + 2
    assert st.dirty
    # a multi-tell backlog on another study
    blg = survivors[1]
    st_b = svc.scheduler.study(blg.name)
    base = st_b.next_tid
    for k in range(3):
        blg.tell(base + k, 0.5 + 0.1 * k, vals={"x": 0.1 * k, "c": 0})
    st_b.next_tid = base + 3
    drive(survivors + joined, 2)
    # a NaN tenant trips the finite check until it is evicted
    bad = svc.create_study("bad", seed=999)
    st_bad = svc.scheduler.study("bad")
    bad.tell(st_bad.next_tid, float("nan"), vals={"x": 0.0, "c": 0})
    st_bad.next_tid += 1
    for _ in range(4):
        if st_bad.quarantined:
            break
        try:
            f = bad.ask_async()
            svc.pump()
            f.exception(timeout=60)
        except POISON:
            break
    drive(survivors + joined, 1)
    counters = dict(svc.counters)
    quarantined = st_bad.quarantined
    svc.shutdown()
    return log, counters, quarantined


_PORT_UNSHARDED = {}


def port_unsharded():
    if not _PORT_UNSHARDED:
        _PORT_UNSHARDED["out"] = serve_scenario(t_service(None))
    return _PORT_UNSHARDED["out"]


def round_dispatches(counters):
    # a sharded run may pay masked-delta drains that a full
    # re-materialization absorbed in the unsharded run
    return counters["dispatch_count"] - counters["delta_drain_dispatches"]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_service_is_bitwise_the_unsharded_service(n_shards):
    ref_log, ref_c, ref_q = port_unsharded()
    log, c, q = serve_scenario(t_service(virtual_mesh(n_shards, STUDY_AXIS)))
    assert q and ref_q
    assert c["evictions"] == ref_c["evictions"] == 1
    assert (c["mesh_shards"], ref_c["mesh_shards"]) == (n_shards, 1)
    assert round_dispatches(c) == round_dispatches(ref_c)
    assert {n: [v for _, v, _ in s] for n, s in log.items()} == \
           {n: [v for _, v, _ in s] for n, s in ref_log.items()}
    if n_shards > 1:
        assert c["shard_restacks"] > 0
        assert c["upload_bytes"] < ref_c["upload_bytes"]
    else:
        assert c["shard_restacks"] == 0 and c["upload_bytes"] == ref_c["upload_bytes"]


_CANDS = {}


def ref_margins(jps, arrays, key):
    """The reference's margin [D] of every pick of one ask at this file's
    ``n_cand``: its winning llr minus the best llr of a candidate with
    another value (``test_torch_serve_batched.ref_margins`` at other
    candidate counts)."""
    if id(jps) not in _CANDS:
        c = jps._consts
        dc, dk = len(jps.cont_idx), len(jps.cat_idx)

        def fn(key, values, active, losses, valid):
            fits = JK.fit_all_dims(c, values, active, losses, valid, 0.25, 25.0, 1.0,
                                   above_cap=JK.DEFAULT_ABOVE_CAP)
            keys = jax.random.split(key, dc + dk)
            cv, cl = JK.ei_sweep_cont_scores(jps.q, c, keys[:dc].reshape(1, dc),
                                             fits["cont"], ALGO_KW["n_cand"])
            kv, kl = JK.ei_sweep_cat_scores(keys[dc:].reshape(1, dk), *fits["cat"],
                                            ALGO_KW["n_cand_cat"])
            return cv, cl, kv, kl

        _CANDS[id(jps)] = jax.jit(fn)
    cv, cl, kv, kl = (np.asarray(a)[0] for a in _CANDS[id(jps)](key, *arrays))

    def margins(vals, llr):
        best = llr.argmax(-1)
        win_v = np.take_along_axis(vals, best[:, None], -1)
        other = np.where(vals != win_v, llr, -np.inf).max(-1)
        return np.take_along_axis(llr, best[:, None], -1)[:, 0] - other

    out = np.empty(jps.n_dims)
    out[jps.cont_idx] = margins(cv, cl)
    out[jps.cat_idx] = margins(kv, kl)
    return out


def assert_streams_agree(j_log, t_log, seeds):
    """Every study's asks before the drain: prior draws equal, warm picks
    equal up to a first divergence that is a near-tie of the reference's
    own ask."""
    jps = j_compile(J_SPACE)
    cat = np.zeros(jps.n_dims, bool)
    cat[jps.cat_idx] = True
    assert set(j_log) == set(t_log)
    n_warm = 0
    for name, j_stream in j_log.items():
        rng = np.random.default_rng(seeds[name])
        told = []
        for (n, jvals, early), (tn, tvals, _) in zip(j_stream, t_log[name]):
            seed = int(rng.integers(2**31 - 1))
            if not early:
                break
            assert n == tn == len(told), name
            if n < N_STARTUP:
                assert jvals == tvals, (name, n)
            else:
                n_warm += 1
                jv = np.array([jvals[lb] for lb in jps.labels], np.float32)
                tv = np.array([tvals[lb] for lb in jps.labels], np.float32)
                differ = ~np.where(cat, jv == tv,
                                   np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL))
                if differ.any():
                    buf = JObsBuffer(jps)
                    for vals in told:
                        buf.add(dict(vals), loss_fn(vals))
                    arrays = tuple(a[..., : buf._device_bucket(JK.DEFAULT_ABOVE_CAP)]
                                   for a in buf.arrays())
                    margins = ref_margins(jps, arrays, host_key(seed % (2**31 - 1)))
                    assert np.all(margins[differ] < NEAR_TIE), (name, n, margins, differ)
                    break
            told.append(jvals)
    assert n_warm > 0  # the warm regime was compared, not only the priors


def scenario_seeds(n_studies=N_STUDIES):
    seeds = {f"s{i:02d}": 400 + i for i in range(n_studies)}
    seeds.update({f"j{i:02d}": 600 + i for i in range(n_studies // 4)})
    seeds["bad"] = 999
    return seeds


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_service_agrees_with_the_references_sharded_service(cpu_mesh, n_shards):
    j_log, j_c, j_q = serve_scenario(j_service(cpu_mesh(n_shards)))
    t_log, t_c, t_q = serve_scenario(t_service(virtual_mesh(n_shards, STUDY_AXIS)))
    assert j_q and t_q
    for key in ("evictions", "mesh_shards", "joins"):
        assert t_c[key] == j_c[key], key
    assert round_dispatches(t_c) == round_dispatches(j_c)
    assert_streams_agree(j_log, t_log, scenario_seeds())


def uneven_churn(svc):
    """Five studies on a 3-shard mesh, one closed before the first round
    (survivors keep high slots), three rounds."""
    handles = [svc.create_study(f"u{i}", seed=50 + i) for i in range(5)]
    handles[0].close()
    log = {}
    for r in range(3):
        before = {h.name: svc.scheduler.study(h.name).buf.count for h in handles[1:]}
        futs = [(h, h.ask_async()) for h in handles[1:]]
        svc.pump()
        for h, f in futs:
            tid, vals = f.result(timeout=60)
            log.setdefault(h.name, []).append((before[h.name], vals, True))
            h.tell(tid, loss_fn(vals))
    return log


def test_uneven_churn_on_three_shards(cpu_mesh):
    """The non-pow2 regression of the reference: capacities round up to a
    multiple of 3, the pad slots stay invisible, the streams are the
    unsharded service's bitwise and the reference's at the rule."""
    svc = t_service(virtual_mesh(3, STUDY_AXIS), max_batch=16)
    log = uneven_churn(svc)
    sched = svc.scheduler
    assert sched._slot_cap % 3 == 0
    assert sum(t.shape[0] for t in sched._state.values) == sched._slot_cap
    assert svc.counters["mesh_shards"] == 3
    svc.shutdown()
    plain = t_service(None, max_batch=16)
    assert uneven_churn(plain) == log
    plain.shutdown()
    jsvc = j_service(cpu_mesh(3), max_batch=16)
    j_log = uneven_churn(jsvc)
    jsvc.shutdown()
    assert_streams_agree(j_log, log, {f"u{i}": 50 + i for i in range(5)})


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5, 6, 8])
def test_slot_capacity_matches_the_reference(shards):
    for n in (0, 1, 3, 4, 5, 9, 17, 33, 64, 100):
        for max_batch in (2, 4, 16, 64):
            assert slot_capacity(n, max_batch, shards=shards) == \
                j_slot_capacity(n, max_batch, shards=shards), (n, max_batch)
    assert slot_capacity(5, 64) == j_slot_capacity(5, 64)


def churn_slots(svc):
    """Slots of a join/leave sequence: after each step, study -> slot."""
    picks = []
    names = [f"p{i}" for i in range(6)]
    for name in names:
        svc.create_study(name, seed=1)
        picks.append({st.name: st.slot for st in svc.scheduler._slots.values()})
    for name in ("p1", "p4"):
        svc.close_study(name)
    for name in ("q0", "q1", "q2"):
        svc.create_study(name, seed=2)
        picks.append({st.name: st.slot for st in svc.scheduler._slots.values()})
    svc.shutdown()
    return picks


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_striped_slot_picks_match_the_reference(cpu_mesh, n_shards):
    t = churn_slots(t_service(virtual_mesh(n_shards, STUDY_AXIS), max_batch=16))
    j = churn_slots(j_service(cpu_mesh(n_shards), max_batch=16))
    assert t == j
    if n_shards == 4:
        # the first four studies take one shard each
        blk = slot_capacity(4, 16, shards=4) // 4
        assert sorted(s // blk for s in t[3].values()) == [0, 1, 2, 3]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_a_clean_shard_keeps_its_tensors_across_a_restack(n_shards):
    svc = t_service(virtual_mesh(n_shards, STUDY_AXIS), max_batch=8)
    handles = [svc.create_study(f"c{i}", seed=i) for i in range(8)]
    for _ in range(2):
        futs = [(h, h.ask_async()) for h in handles]
        svc.pump()
        for h, f in futs:
            tid, vals = f.result(timeout=60)
            h.tell(tid, loss_fn(vals))
    sched = svc.scheduler
    ooo = sched.study("c0")
    ooo_h = handles[0]
    t_hi = ooo.next_tid
    ooo_h.tell(t_hi + 1, 0.9, vals={"x": 0.5, "c": 1})
    ooo_h.tell(t_hi, 0.7, vals={"x": -0.5, "c": 0})
    ooo.next_tid = t_hi + 2
    state = sched._state
    assert isinstance(state, ShardedBatchState) and state.n_shards == n_shards
    blk = sched._slot_cap // n_shards
    dirty = ooo.slot // blk
    before = [[(t.data_ptr(), t.numpy().tobytes()) for t in state.shard(k)]
              for k in range(n_shards)]
    restacks, uploaded = sched.shard_restacks, sched.upload_bytes
    with sched._lock:
        sched._maintain()
    after = sched._state
    assert sched.shard_restacks == restacks + 1
    assert sched.upload_bytes - uploaded == sum(t.numpy().nbytes for t in after.shard(dirty))
    for k in range(n_shards):
        now = [(t.data_ptr(), t.numpy().tobytes()) for t in after.shard(k)]
        if k == dirty:
            assert all(a[0] != b[0] for a, b in zip(now, before[k]))
        else:
            assert now == before[k], k
    # no shard aliases the host mirror it was built from
    for st in sched._slots.values():
        for t in after.shard(st.slot // blk):
            for a in (st.buf.values, st.buf.active, st.buf.losses, st.buf.valid):
                assert not np.shares_memory(t.numpy(), a)
    svc.shutdown()


def test_the_mesh_helpers():
    """In-process shards: a virtual or one-rank 1-D mesh; a mesh over
    several processes or of several axes is refused naming its item; on
    the CPU every shard shares the caller's device."""
    assert in_process_shards(virtual_mesh(3, STUDY_AXIS), STUDY_AXIS, "x") == 3
    assert in_process_shards(RankMesh((1,), (TRIAL_AXIS,), (0,)), TRIAL_AXIS, "x") == 1
    with pytest.raises(NotImplementedError, match="item 15c"):
        in_process_shards(RankMesh((2,), (STUDY_AXIS,), (0, 1)), STUDY_AXIS, "x")
    with pytest.raises(NotImplementedError, match="item 15c"):
        in_process_shards(RankMesh((2, 2), ("trial", "cand"), range(4), virtual=True),
                          TRIAL_AXIS, "x")
    with pytest.raises(ValueError, match="no 'study' axis"):
        in_process_shards(virtual_mesh(2, TRIAL_AXIS), STUDY_AXIS, "x")
    assert shard_devices(4, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="1-D"):
        t_service(RankMesh((2, 1), ("study", "cand"), range(2), virtual=True))


def test_shards_on_several_cards_are_refused(monkeypatch):
    """Shard ``k`` on ``cuda:k`` (a process that sees as many cards as
    shards) has no check yet and is refused naming its item; with fewer
    cards every shard shares the caller's card."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for n in (2, 4):
        with pytest.raises(NotImplementedError, match="item 15c"):
            shard_devices(n, cuda)
        with pytest.raises(NotImplementedError, match="item 15c"):
            in_process_shards(virtual_mesh(n, STUDY_AXIS), STUDY_AXIS, "x", cuda)
    assert shard_devices(1, cuda) == [cuda]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shard_devices(4, cuda) == [cuda] * 4
    assert in_process_shards(virtual_mesh(4, STUDY_AXIS), STUDY_AXIS, "x", cuda) == 4


# ---------------------------------------------------------------------------
# the population axis: compile_pbt and compile_sha
# ---------------------------------------------------------------------------


def j_train_fn(state, hypers, key):
    # the reference's graftmesh train_fn: noise shared by every member
    # from the step key, and per-member elementwise math
    noise = jax.random.normal(key, (), dtype=jnp.float32) * 0.01
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7) + noise
    return {"theta": theta}, (theta - 0.7) ** 2


def t_train_fn(state, hypers, key):
    noise = R.normal(key, ()) * 0.01
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7) + noise
    return {"theta": theta}, (theta - 0.7) ** 2


PBT_KW = dict(hyper_bounds={"lr": (1e-3, 1.0)}, pop_size=16, exploit_every=3, n_rounds=4)
THETA0 = np.linspace(0.0, 5.0, 16, dtype=np.float32)


def t_pbt(mesh=None):
    kw = {} if mesh is None else dict(mesh=mesh, trial_axis=TRIAL_AXIS, shard_mode="shard_map")
    return compile_pbt(t_train_fn, {"theta": THETA0}, device="cpu", **kw, **PBT_KW)


def assert_pbt_equal(a, b):
    np.testing.assert_array_equal(a["loss_history"], b["loss_history"])
    for n in b["hypers"]:
        np.testing.assert_array_equal(a["hypers"][n], b["hypers"][n])
    np.testing.assert_array_equal(a["state"]["theta"].numpy(), b["state"]["theta"].numpy())
    assert (a["best_loss"], a["best_index"]) == (b["best_loss"], b["best_index"])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pbt_shard_map_is_bitwise_the_unsharded_schedule(monkeypatch, n_shards):
    plain = t_pbt()
    ref = plain(seed=7)
    ref2 = plain(seed=7, init=ref)
    sharded = t_pbt(virtual_mesh(n_shards, TRIAL_AXIS))
    assert sharded._shard_mode == "shard_map"
    joined = []  # the blocks each gather joins
    gather = t_pbt_module._gather
    monkeypatch.setattr(t_pbt_module, "_gather",
                        lambda dst, blocks: joined.append(len(blocks)) or gather(dst, blocks))
    out = sharded(seed=7)
    assert_pbt_equal(out, ref)
    # one loss gather and one member-state gather per exploit, each of
    # every shard's block
    assert joined == [n_shards] * (2 * PBT_KW["n_rounds"])
    out2 = sharded(seed=7, init=out)
    assert_pbt_equal(out2, ref2)
    assert joined == [n_shards] * (4 * PBT_KW["n_rounds"])


def nested_train_fn(state, hypers, key):
    """A step over a nested state of several leaves (a dict in a dict, a
    tuple, an integer counter), each member's math elementwise, and a
    loss that reads every leaf: a gather, scatter or leaf order that goes
    wrong shows in the losses and so in the schedule."""
    noise = R.normal(key, ()) * 0.01
    lr = hypers["lr"]
    w = state["layer"]["w"] - lr[:, None] * (state["layer"]["w"] - 0.3) + noise
    b = state["layer"]["b"] * (1.0 - lr) + 0.1 * w[:, 0]
    extra = (state["extra"][0] * 0.9 + b[:, None],)
    n = state["n"] + 1
    loss = (w[:, 0] ** 2 + w[:, 1] ** 2 + w[:, 2] ** 2 + (b - 0.5) ** 2
            + 1e-3 * (extra[0][:, 0] - extra[0][:, 1]) + 1e-4 * n.to(torch.float32))
    return {"layer": {"w": w, "b": b}, "extra": extra, "n": n}, loss


def nested_state(pop):
    rng = np.random.default_rng(5)
    return {"layer": {"w": rng.uniform(-2, 2, (pop, 3)).astype(np.float32),
                      "b": rng.uniform(-1, 1, pop).astype(np.float32)},
            "extra": (rng.uniform(0, 1, (pop, 2)).astype(np.float32),),
            "n": np.arange(pop, dtype=np.int32)}


def assert_trees_equal(a, b):
    np.testing.assert_array_equal(a["layer"]["w"].numpy(), b["layer"]["w"].numpy())
    np.testing.assert_array_equal(a["layer"]["b"].numpy(), b["layer"]["b"].numpy())
    np.testing.assert_array_equal(a["extra"][0].numpy(), b["extra"][0].numpy())
    np.testing.assert_array_equal(a["n"].numpy(), b["n"].numpy())
    assert a["n"].dtype == torch.int32


@pytest.mark.parametrize("what", ["pbt", "sha"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_a_nested_state_of_several_leaves_shards_bitwise(what, n_shards):
    """The sharded schedules over a state of several leaves, bitwise the
    unsharded ones: losses, hypers, rung orders and every leaf of the
    final population (the resumed PBT segment too)."""
    mesh = dict(mesh=virtual_mesh(n_shards, TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                shard_mode="shard_map")
    if what == "pbt":
        make = lambda **kw: compile_pbt(nested_train_fn, nested_state(16), device="cpu",
                                        **kw, **PBT_KW)
        plain, sharded = make(), make(**mesh)
        ref, out = plain(seed=3), sharded(seed=3)
        np.testing.assert_array_equal(out["log_hypers"], ref["log_hypers"])
        np.testing.assert_array_equal(out["loss_history"], ref["loss_history"])
        assert_trees_equal(out["state"], ref["state"])
        ref2, out2 = plain(seed=3, init=ref), sharded(seed=3, init=out)
        np.testing.assert_array_equal(out2["loss_history"], ref2["loss_history"])
        assert_trees_equal(out2["state"], ref2["state"])
    else:
        make = lambda **kw: compile_sha(nested_train_fn, nested_state(8), device="cpu",
                                        **kw, **SHA_KW)
        ref, out = make()(seed=3), make(**mesh)(seed=3)
        for key in ("best_loss", "best_hypers", "best_index", "rungs", "replica_bests"):
            assert out[key] == ref[key], key
        assert_trees_equal(out["state"], ref["state"])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pbt_shard_map_meets_the_references_sharded_run(cpu_mesh, n_shards):
    """``test_torch_pbt.py``'s rule on its own ``train_fn`` and population
    (``_both``'s): hypers bitwise, losses within LOSS_RTOL, the same
    winner, the resumed segment too."""
    theta0 = np.linspace(2.0, 5.0, 8).astype(np.float32)
    opts = dict(pop_size=8, exploit_every=3, n_rounds=6, trial_axis=TRIAL_AXIS,
                shard_mode="shard_map")
    j_run = j_compile_pbt(quad_train_fn, {"theta": jnp.asarray(theta0)}, BOUNDS,
                          mesh=cpu_mesh(n_shards, axis=TRIAL_AXIS), **opts)
    t_run = compile_pbt(quad_train_fn, {"theta": theta0}, BOUNDS,
                        mesh=virtual_mesh(n_shards, TRIAL_AXIS), device="cpu", **opts)
    j, t = j_run(seed=3), t_run(seed=3)
    assert_match(j, t)
    assert_match(j_run(seed=3, init=j), t_run(seed=3, init=t))


def test_pbt_graftmesh_train_fn_parts_from_the_reference_as_unsharded(cpu_mesh):
    """On the reference's graftmesh ``train_fn`` the hypers and the final
    states are the reference's bits, sharded or not; its losses near 0
    (``(theta - 0.7) ** 2``) part from the reference's by up to about
    1.4e-5 relative already unsharded, and the sharded runs part by
    exactly the same amounts."""
    j_kw = dict(mesh=cpu_mesh(4, axis=TRIAL_AXIS), trial_axis=TRIAL_AXIS, shard_mode="shard_map")
    j_plain = j_compile_pbt(j_train_fn, {"theta": jnp.asarray(THETA0)}, **PBT_KW)(seed=7)
    j_sh = j_compile_pbt(j_train_fn, {"theta": jnp.asarray(THETA0)}, **j_kw, **PBT_KW)(seed=7)
    t_plain = t_pbt()(seed=7)
    t_sh = t_pbt(virtual_mesh(4, TRIAL_AXIS))(seed=7)
    for j, t in ((j_plain, t_plain), (j_sh, t_sh)):
        for n in j["hypers"]:
            np.testing.assert_array_equal(t["hypers"][n], np.asarray(j["hypers"][n]))
        np.testing.assert_array_equal(t["state"]["theta"].numpy(), np.asarray(j["state"]["theta"]))
        assert t["best_index"] == j["best_index"]
    np.testing.assert_array_equal(t_sh["loss_history"] - np.asarray(j_sh["loss_history"]),
                                  t_plain["loss_history"] - np.asarray(j_plain["loss_history"]))


def test_constraint_mode_runs_the_same_blocks():
    """PyTorch has no GSPMD: a mesh with the default ``shard_mode`` is the
    reference's ``"constraint"``, which runs the per-block program."""
    runner = compile_pbt(t_train_fn, {"theta": THETA0}, device="cpu",
                         mesh=virtual_mesh(2, TRIAL_AXIS), trial_axis=TRIAL_AXIS, **PBT_KW)
    assert runner._shard_mode == "constraint"
    assert_pbt_equal(runner(seed=7), t_pbt()(seed=7))


SHA_KW = dict(hyper_bounds={"lr": (1e-3, 1.0)}, n_configs=8, eta=2, steps_per_rung=2)
SHA_THETA0 = np.linspace(0.5, 5.0, 8, dtype=np.float32)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sha_shard_map_is_bitwise_the_unsharded_ladder(cpu_mesh, n_shards):
    ref = compile_sha(t_train_fn, {"theta": SHA_THETA0}, device="cpu", **SHA_KW)(seed=9)
    runner = compile_sha(t_train_fn, {"theta": SHA_THETA0}, device="cpu",
                         mesh=virtual_mesh(n_shards, TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                         shard_mode="shard_map", **SHA_KW)
    out = runner(seed=9)
    for key in ("best_loss", "best_hypers", "best_index", "rungs", "replica_bests"):
        assert out[key] == ref[key], key
    np.testing.assert_array_equal(out["state"]["theta"].numpy(), ref["state"]["theta"].numpy())
    sizes = [m.size for m in runner._rung_meshes]
    assert sizes == [math.gcd(8 // 2**r, n_shards) for r in range(4)]
    j_runner = j_compile_sha(j_train_fn, {"theta": jnp.asarray(SHA_THETA0)},
                             mesh=cpu_mesh(n_shards, axis=TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                             shard_mode="shard_map", **SHA_KW)
    assert sizes == [int(np.prod(list(s.mesh.shape.values())))
                     for s in j_runner._rung_shardings]


def test_sha_shard_map_resumes_from_a_rung_snapshot(tmp_path):
    runner = compile_sha(t_train_fn, {"theta": SHA_THETA0}, device="cpu",
                         mesh=virtual_mesh(4, TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                         shard_mode="shard_map", **SHA_KW)
    ref = runner(seed=9)
    path = str(tmp_path / "sha.npz")
    assert runner(seed=9, checkpoint=path)["rungs"] == ref["rungs"]
    # a finished snapshot answers with no device work, the same result
    again = runner(seed=9, checkpoint=path)
    assert (again["best_loss"], again["best_hypers"]) == (ref["best_loss"], ref["best_hypers"])


@pytest.mark.parametrize("what, n_shards, mode, match", [
    ("pbt", None, "shard_map", "requires mesh"),
    ("pbt", 4, "nonsense", "shard_mode"),
    ("pbt", 4, "shard_map", "divide"),
    ("sha", None, "shard_map", "requires mesh"),
    ("sha", 4, "nonsense", "shard_mode"),
])
def test_sharding_validation_matches_the_reference(cpu_mesh, what, n_shards, mode, match):
    t_mesh = None if n_shards is None else virtual_mesh(n_shards, TRIAL_AXIS)
    j_mesh = None if n_shards is None else cpu_mesh(n_shards, axis=TRIAL_AXIS)
    pop = 6 if match == "divide" else 8
    theta = np.zeros(pop, np.float32)
    if what == "pbt":
        t_call = lambda: compile_pbt(t_train_fn, {"theta": theta}, {"lr": (1e-3, 1.0)}, pop,
                                     mesh=t_mesh, trial_axis=TRIAL_AXIS, shard_mode=mode,
                                     device="cpu")
        j_call = lambda: j_compile_pbt(j_train_fn, {"theta": jnp.asarray(theta)},
                                       {"lr": (1e-3, 1.0)}, pop, mesh=j_mesh,
                                       trial_axis=TRIAL_AXIS, shard_mode=mode)
    else:
        t_call = lambda: compile_sha(t_train_fn, {"theta": theta}, {"lr": (1e-3, 1.0)}, pop,
                                     mesh=t_mesh, trial_axis=TRIAL_AXIS, shard_mode=mode,
                                     device="cpu")
        j_call = lambda: j_compile_sha(j_train_fn, {"theta": jnp.asarray(theta)},
                                       {"lr": (1e-3, 1.0)}, pop, mesh=j_mesh,
                                       trial_axis=TRIAL_AXIS, shard_mode=mode)
    with pytest.raises(ValueError, match=match) as t_err:
        t_call()
    with pytest.raises(ValueError, match=match) as j_err:
        j_call()
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12])
def test_pbt_and_sha_shard_map_on_more_seeds(seed):
    plain = t_pbt()(seed=seed)
    assert_pbt_equal(t_pbt(virtual_mesh(4, TRIAL_AXIS))(seed=seed), plain)
    ref = compile_sha(t_train_fn, {"theta": SHA_THETA0}, device="cpu", **SHA_KW)(seed=seed)
    out = compile_sha(t_train_fn, {"theta": SHA_THETA0}, device="cpu",
                      mesh=virtual_mesh(2, TRIAL_AXIS), trial_axis=TRIAL_AXIS,
                      shard_mode="shard_map", **SHA_KW)(seed=seed)
    assert (out["best_loss"], out["rungs"]) == (ref["best_loss"], ref["rungs"])
