"""The port's annealing (``anneal.suggest``) against ``anneal_jax``.

Teacher-forced: the same 200-obs history of ``mixed_space()`` and the
same key through both packages' ``build_anneal_fn`` at B=8.  The anchor
rank is ``floor(log(u) / log1p(-p))``; the port evaluates both logs as
XLA does (``random._log``/``_log1p``), so the anchors are equal unless
that quotient lies within ANCHOR_EDGE of an integer, where one last bit
may flip the floor (a fault anywhere else).  Where the anchors agree,
categorical picks and active masks are equal and continuous values
agree within CONT_RTOL: the anchor's latent value goes through
PyTorch's ``log``/``exp`` (a few ulp from XLA's), the rest is the
reference's arithmetic with its multiply-add contractions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import anneal_jax
from hyperopt_tpu.fmin import FMinIter as JFMinIter, partial as jpartial
from hyperopt_tpu.jax_trials import obs_buffer_for as j_buf
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu_torch import anneal as A, convert
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from hyperopt_tpu_torch.ops.compile import compile_space as t_compile
from hyperopt_tpu_torch.torch_trials import obs_buffer_for as t_buf

CONT_RTOL, CONT_ATOL = 2e-6, 1e-7
ANCHOR_EDGE = 1e-5
BATCH = 8


def _history(jps, n_obs, cap, seed):
    values, active = (np.asarray(a) for a in jps.sample_prior(jax.random.key(seed), cap))
    cat = set(jps.cat_idx.tolist())
    losses = np.array([
        mixed_space_fn({label: int(values[d, i]) if d in cat else float(values[d, i])
                        for d, label in enumerate(jps.labels)})
        for i in range(cap)
    ], np.float32)
    return values, active, losses, np.arange(cap) < n_obs


def _close(jps, jv, tv):
    """[D, B] mask of picks that agree: categorical equal, continuous close."""
    cat = np.zeros(jps.n_dims, bool)
    cat[jps.cat_idx] = True
    return np.where(cat[:, None], jv == tv, np.isclose(tv, jv, rtol=CONT_RTOL, atol=CONT_ATOL))


@pytest.mark.parametrize("seed", [0, pytest.param(1, marks=pytest.mark.slow)])
def test_teacher_forced_anneal(seed):
    jps, tps = j_compile(j_mixed_space()), t_compile(t_mixed_space(), device="cpu")
    arrays = _history(jps, 200, 256, seed)
    key = jax.random.key(300 + seed)
    jv, ja = (np.asarray(a) for a in anneal_jax.build_anneal_fn(jps, 2.0, 0.1)(
        key, *arrays, batch=BATCH))
    state = convert.history_from_numpy(*arrays, device="cpu")
    tkey = convert.key_from_numpy(jax.random.key_data(key), device="cpu")
    tv, ta = (a.numpy() for a in A.build_anneal_fn(tps, 2.0, 0.1)(tkey, *state, BATCH))

    # the anchor rank's quotient, in both packages
    u = jax.random.uniform(jax.random.split(key, 5)[0], (BATCH,), dtype=jnp.float32,
                           minval=1e-12, maxval=1.0)
    jq = np.asarray(jnp.log(u) / jnp.log1p(-0.5))
    tu = R.uniform(R.split(tkey, 5)[0], (BATCH,), 1e-12, 1.0)
    tq = (R._log(tu) / R._log1p(torch.tensor(-0.5))).numpy()
    same_anchor = np.floor(jq) == np.floor(tq)
    edge = np.abs(jq - np.round(jq)) < ANCHOR_EDGE
    assert np.all(same_anchor | edge), (jq, tq)

    close = _close(jps, jv, tv)
    assert np.all(close[:, same_anchor]), np.argwhere(~close[:, same_anchor])
    assert np.array_equal(ja[:, same_anchor], ta[:, same_anchor])


def test_uniform_with_nonzero_minval_is_bitwise():
    """Annealing draws its anchor uniforms on [1e-12, 1): bit for bit
    ``jax.random.uniform``'s at that minval."""
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jax.random.uniform(key, (4096,), dtype=jnp.float32,
                                             minval=1e-12, maxval=1.0))
        tkey = convert.key_from_numpy(jax.random.key_data(key), device="cpu")
        np.testing.assert_array_equal(R.uniform(tkey, (4096,), 1e-12, 1.0).numpy(), want)


def _streams(jalgo, talgo, n, seed):
    jd, jt = J.Domain(mixed_space_fn, j_mixed_space()), J.Trials()
    JFMinIter(jalgo, jd, jt, rstate=np.random.default_rng(seed), max_evals=n,
              show_progressbar=False).exhaust()
    td, tt = H.Domain(mixed_space_fn, t_mixed_space(), device="cpu"), H.Trials()
    FMinIter(talgo, td, tt, rstate=np.random.default_rng(seed), max_evals=n).exhaust()
    return (jd, jt), (td, tt)


def _assert_streams_close(jt, tt):
    """Every trial: the same active labels, categorical values equal,
    continuous values within CONT_RTOL."""
    assert len(jt.trials) == len(tt.trials)
    for a, b in zip(jt.trials, tt.trials):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert {k for k, v in va.items() if v} == {k for k, v in vb.items() if v}
        for label, x in va.items():
            if x and isinstance(x[0], int):
                assert vb[label] == x, (a["tid"], label)
            elif x:
                assert np.isclose(vb[label][0], x[0], rtol=CONT_RTOL, atol=CONT_ATOL), \
                    (a["tid"], label, x, vb[label])


def test_anneal_stream_matches_reference():
    """60 sequential trials through both packages' drivers."""
    (_, jt), (_, tt) = _streams(anneal_jax.suggest, A.suggest, 60, 2)
    _assert_streams_close(jt, tt)


def test_anneal_speculative_matches_reference():
    """``speculative=4``: the same stream (k-wide draws of the annealing
    step) and the same number of draws through each buffer."""
    (jd, jt), (td, tt) = _streams(jpartial(anneal_jax.suggest, speculative=4),
                                  H.partial(A.suggest, speculative=4), 40, 4)
    _assert_streams_close(jt, tt)
    # the prior draw at ask 0, the regime flip at ask 1, then every 4th ask
    assert j_buf(jd, jt).dispatch_count == t_buf(td, tt).dispatch_count == 11


def test_anneal_resident_parity():
    """The resident mirror (fused tell+ask) gives the re-upload stream,
    bitwise."""
    streams = {}
    for resident in (None, True):
        trials = H.Trials()
        H.fmin(mixed_space_fn, t_mixed_space(), algo=H.partial(A.suggest, resident=resident),
               max_evals=60, trials=trials, rstate=np.random.default_rng(6), device="cpu")
        streams[resident] = [t["misc"]["vals"] for t in trials.trials]
    assert streams[None] == streams[True]
