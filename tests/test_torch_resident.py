"""The port's resident history: O(D) delta tells and the fused tell+ask.

The port's twin of ``tests/test_resident.py``.  The resident mirror and
the fused driver (with its ask-ahead hook) must give a suggestion stream
BITWISE equal to the port's own re-upload stream; the four buffer
counters must equal the JAX package's for the same driver run; and no
device view may share memory with the host arrays, also on the CPU
(where ``torch.from_numpy(a).to("cpu")`` would be ``a`` itself).
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import tpe_jax
from hyperopt_tpu.fmin import FMinIter as JFMinIter, partial as jpartial
from hyperopt_tpu.jax_trials import JaxTrials
from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu_torch import tpe as T
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.fmin import FMinIter, partial
from hyperopt_tpu_torch.ops import kernels as TK
from hyperopt_tpu_torch.ops.compile import compile_space
from hyperopt_tpu_torch.torch_trials import (
    MAX_PENDING_DELTAS,
    MIN_CAPACITY,
    ObsBuffer,
    TorchTrials,
    obs_buffer_for,
)


def _mixed(hp):
    """Uniform + log + quantized + a conditional branch with a nested
    uniform / randint: every dim family the packer knows."""
    return {
        "x": hp.uniform("x", -5, 5),
        "lr": hp.loguniform("lr", -5, 0),
        "q": hp.quniform("q", 0, 10, 1),
        "c": hp.choice("c", [
            {"k": 0, "a": hp.uniform("a", 0, 1)},
            {"k": 1, "b": hp.randint("b", 3)},
        ]),
    }


MIXED = _mixed(H.hp)


def mixed_obj(cfg):
    base = (cfg["x"] - 1) ** 2 / 10 + abs(np.log(cfg["lr"]) + 2) / 3 + abs(cfg["q"] - 4) / 5
    return base + (cfg["c"]["a"] if cfg["c"]["k"] == 0 else 0.1 * cfg["c"]["b"])


def run_stream(algo, trials, n, seed=7, obj=mixed_obj, space=MIXED):
    H.fmin(obj, space, algo=algo, max_evals=n, trials=trials,
           rstate=np.random.default_rng(seed), return_argmin=False, device="cpu")
    return [t["misc"]["vals"] for t in trials.trials]


def _three_streams(n):
    kw = dict(n_EI_candidates=16)
    base = run_stream(partial(T.suggest, **kw), H.Trials(), n)
    resident = run_stream(partial(T.suggest, resident=True, **kw), H.Trials(), n)
    fused = run_stream(partial(T.suggest, fused=True, **kw), TorchTrials(resident=True), n)
    return base, resident, fused


def test_resident_and_fused_streams_equal_reupload():
    """60 trials: the re-upload, resident-delta and fused ask-ahead
    streams are bitwise equal (boundary crossings: the slow twin and the
    buffer-level tests below)."""
    base, resident, fused = _three_streams(60)
    assert len(base) == 60
    assert base == resident == fused


@pytest.mark.slow
def test_resident_and_fused_streams_equal_reupload_200():
    """200 trials: past the capacity growth (count 128) and the bucket
    growth (count 129)."""
    base, resident, fused = _three_streams(200)
    assert len(base) == 200
    assert base == resident == fused


def _counters(buf):
    return (buf.dispatch_count, buf.full_uploads, buf.delta_tells, buf.transfer_bytes_total)


def test_fused_counters_equal_reference():
    """The sequential driver with the fused ask: the port's four buffer
    counters equal the JAX package's -- one dispatch per trial plus the
    trailing ask-ahead pre-dispatch, one full upload (the cold mirror),
    every warm tell an O(D) delta of 5*D+8 bytes."""
    jt = JaxTrials(resident=True)
    JFMinIter(jpartial(tpe_jax.suggest, fused=True, n_EI_candidates=16),
              J.base.Domain(mixed_obj, _mixed(J.hp)), jt, rstate=np.random.default_rng(3),
              max_evals=60, show_progressbar=False).exhaust()
    tt = TorchTrials(resident=True)
    it = FMinIter(partial(T.suggest, fused=True, n_EI_candidates=16),
                  Domain(mixed_obj, MIXED, device="cpu"), tt, rstate=np.random.default_rng(3),
                  max_evals=60)
    it.exhaust()
    (jbuf,), (tbuf,) = jt._buffers.values(), tt._buffers.values()
    assert _counters(tbuf) == _counters(jbuf)
    D = tbuf.space.n_dims
    assert (tbuf.dispatch_count, tbuf.full_uploads, tbuf.delta_tells) == (61, 1, 40)
    full = tbuf._device_bucket() * (4 * D + D + 4 + 1)
    assert tbuf.transfer_bytes_total == full + 40 * (5 * D + 8)
    # every warm ask took the draw the ask-ahead hook pre-dispatched
    assert it.domain._ask_ahead_hook is not None
    assert it.domain._ask_ahead_state["taken"] == 59


def test_delta_bytes_flat_in_history_size():
    """The per-tell upload is O(D), whatever the observation count."""
    ps = compile_space(MIXED, device="cpu")
    per_tell = {}
    for n_obs in (40, 3 * MIN_CAPACITY):
        buf = ObsBuffer(ps, resident=True)
        for i in range(n_obs):
            buf.add({"x": float(i % 7), "q": 1.0}, float(i % 5))
        buf.device_arrays()  # settle the mirror
        b0 = buf.transfer_bytes_total
        buf.add({"x": 0.5, "q": 2.0}, 0.25)
        buf.device_arrays()
        per_tell[n_obs] = buf.transfer_bytes_total - b0
    assert per_tell[40] == per_tell[3 * MIN_CAPACITY] == 5 * ps.n_dims + 8


def test_mirror_matches_host_across_regimes():
    """The resident view equals the re-upload view bitwise after in-order
    appends, a backlog past MAX_PENDING_DELTAS, bucket growth, capacity
    growth and a late insert that forces a re-materialization."""
    ps = compile_space(MIXED, device="cpu")
    res, ref = ObsBuffer(ps, resident=True), ObsBuffer(ps)

    def check():
        for x, y in zip(res.device_arrays(), ref.device_arrays()):
            assert torch.equal(x, y)

    def add_both(vals, loss, tid):
        res.add(dict(vals), loss, tid=tid)
        ref.add(dict(vals), loss, tid=tid)

    tid = 0
    for i in range(MIN_CAPACITY + 10):
        add_both({"x": float(i % 9), "lr": 0.1}, float(i % 4), tid)
        tid += 2  # leave odd tids free for the late insert below
        if i % 3 == 0:
            check()
    check()
    assert res.capacity > MIN_CAPACITY and res._device_bucket() > MIN_CAPACITY
    deltas = res.delta_tells
    for i in range(MAX_PENDING_DELTAS + 1):  # a backlog past the crossover
        add_both({"x": 0.25 * i}, 0.5, tid)
        tid += 2
    assert res._resident_full and not res._pending_deltas
    check()
    assert res.delta_tells == deltas  # re-materialized, not 33 deltas
    add_both({"x": -1.0, "lr": 0.5}, 9.9, 5)  # late completion
    assert res._resident_full
    check()


def test_buffer_pickles_without_device_state():
    ps = compile_space(MIXED, device="cpu")
    buf = ObsBuffer(ps, resident=True)
    for i in range(8):
        buf.add({"x": float(i)}, float(i))
    buf.device_arrays()
    clone = pickle.loads(pickle.dumps(buf))
    assert clone.resident and clone._resident is None and clone._pending_deltas == []
    for x, y in zip(clone.device_arrays(), buf.device_arrays()):
        assert torch.equal(x, y)


def test_set_resident_flips_safely_mid_run():
    """Flipping to the resident view between asks changes no suggestion."""
    seeds = np.random.default_rng(0).integers(2**31 - 1, size=40)
    streams = []
    for flip in (True, False):
        domain, trials, stream = Domain(mixed_obj, MIXED, device="cpu"), H.Trials(), []
        for i, s in enumerate(seeds):
            if flip and i == 25:  # once warm, mid-run
                obs_buffer_for(domain, trials, resident=True)
            (doc,) = T.suggest(trials.new_trial_ids(1), domain, trials, int(s),
                               n_EI_candidates=16)
            stream.append({k: list(v) for k, v in doc["misc"]["vals"].items()})
            doc["state"] = 2  # JOB_STATE_DONE
            doc["result"] = {"status": "ok", "loss": float(i % 7)}
            trials.insert_trial_docs([doc])
            trials.refresh()
        streams.append(stream)
    assert streams[0] == streams[1]


def _state(seed, D=5, cap=16, n=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(D, cap)).astype(np.float32), rng.random((D, cap)) < 0.5,
            rng.normal(size=cap).astype(np.float32), np.arange(cap) < n)


def _delta(seed, D=5):
    rng = np.random.default_rng(100 + seed)
    return (rng.normal(size=D).astype(np.float32), rng.random(D) < 0.5,
            np.float32(rng.normal()))


@pytest.mark.parametrize("slot", [0, 9, 15])
def test_apply_delta_matches_reference(slot):
    """Bitwise the reference's ``apply_delta``; in place on the port's
    tensors, with a host int slot."""
    state, (vcol, acol, loss) = _state(slot), _delta(slot)
    want = JK.apply_delta(*state, vcol, acol, loss, np.int32(slot))
    got = [torch.from_numpy(a.copy()) for a in state]
    out = TK.apply_delta(*got, vcol, acol, loss, slot)
    for w, g, o in zip(want, got, out):
        assert o is g  # written in place
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("apply", [True, False])
def test_apply_delta_masked_matches_reference(apply):
    state, (vcol, acol, loss) = _state(3), _delta(3)
    want = JK.apply_delta_masked(*state, vcol, acol, loss, np.int32(9), apply)
    got = [torch.from_numpy(a.copy()) for a in state]
    TK.apply_delta_masked(*got, vcol, acol, loss, 9, torch.tensor(apply))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("resident", [False, True])
def test_cpu_mirror_does_not_alias_host(resident):
    """A device view on the CPU is a copy: a late insert (a tail shift of
    the host arrays) and direct writes to the host ``values``, ``losses``
    and ``valid`` leave it unchanged."""
    ps = compile_space(MIXED, device="cpu")
    buf = ObsBuffer(ps, resident=resident)
    for i in range(100):  # bucket == capacity: every slice is contiguous
        buf.add({"x": float(i % 9), "q": 1.0}, float(i % 5), tid=2 * i)
    view = buf.device_arrays()
    assert view.losses.shape[0] == buf.capacity
    before = [t.clone() for t in view]
    buf.add({"x": 4.5}, 0.125, tid=3)  # shifts the tail of every array
    buf.values[:, 0] = 99.0
    buf.losses[:] = -1.0
    buf.valid[:] = False
    for t, b in zip(view, before):
        assert torch.equal(t, b)
    for t, a in zip(view, buf.arrays()):
        assert t.data_ptr() != a.ctypes.data


def test_resident_counts_deltas_outside_a_fused_ask():
    """Tells settled by device_arrays (not fused) are deltas and dispatches
    each; the fused ask's delta is a delta but one dispatch with its draw."""
    ps = compile_space(MIXED, device="cpu")
    buf = ObsBuffer(ps, resident=True)
    buf.add({"x": 1.0}, 1.0)
    buf.device_arrays()
    assert (buf.full_uploads, buf.delta_tells, buf.dispatch_count) == (1, 0, 0)
    buf.add({"x": 2.0}, 2.0)
    buf.add({"x": 3.0}, 3.0)
    buf.device_arrays()
    assert (buf.full_uploads, buf.delta_tells, buf.dispatch_count) == (1, 2, 2)
    buf.add({"x": 4.0}, 4.0)
    state, (vcol, acol, loss, slot) = buf.take_fusable_delta()
    assert slot == 3 and loss == 4.0 and buf.delta_tells == 3
    assert buf.take_fusable_delta() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        buf.commit_resident(TK.apply_delta(*state, vcol, acol, loss, slot))
    np.testing.assert_array_equal(buf.device_arrays().losses.numpy()[:4], [1, 2, 3, 4])
