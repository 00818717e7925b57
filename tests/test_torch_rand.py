"""The port's random search (``rand.suggest``) against ``rand_jax``, and
its host sampler (``VectorizeHelper``) against the reference's.

Prior draws: threefry bits are the reference's, uniform dims are
``low + u * (high - low)`` contracted as XLA contracts it, and log-space
dims go through PyTorch's ``exp``, within 1 ulp of XLA's: categorical
values equal, continuous within 2 ulp.
"""

import numpy as np
import pytest

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu import rand_jax
from hyperopt_tpu.fmin import FMinIter as JFMinIter, partial as jpartial
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space, mixed_space_fn
from hyperopt_tpu.vectorize import VectorizeHelper as JHelper
from hyperopt_tpu_torch import rand as T
from hyperopt_tpu_torch.fmin import FMinIter
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from hyperopt_tpu_torch.vectorize import VectorizeHelper as THelper

ULPS = 2


def _conditional(hp):
    return {"x": hp.uniform("x", -2, 2), "lr": hp.loguniform("lr", -6, 0),
            "n": hp.qnormal("n", 10, 3, 1),
            "arch": hp.choice("arch", [{"d": hp.randint("d", 2, 9)},
                                       {"w": hp.normal("w", 0.5, 0.2)}])}


def _streams(jalgo, talgo, n, seed):
    jd, jt = J.Domain(mixed_space_fn, j_mixed_space()), J.Trials()
    JFMinIter(jalgo, jd, jt, rstate=np.random.default_rng(seed), max_evals=n,
              show_progressbar=False).exhaust()
    td, tt = H.Domain(mixed_space_fn, t_mixed_space(), device="cpu"), H.Trials()
    FMinIter(talgo, td, tt, rstate=np.random.default_rng(seed), max_evals=n).exhaust()
    return (jd, jt), (td, tt)


def _assert_same_draws(jt, tt):
    for a, b in zip(jt.trials, tt.trials, strict=True):
        va, vb = a["misc"]["vals"], b["misc"]["vals"]
        assert va.keys() == vb.keys()
        for label, x in va.items():
            if x and isinstance(x[0], int):
                assert vb[label] == x
            elif x:
                want = np.float32(x[0])
                assert abs(np.float32(vb[label][0]) - want) <= ULPS * np.spacing(abs(want)), label


@pytest.mark.parametrize("seed", [0, pytest.param(5, marks=pytest.mark.slow)])
def test_rand_stream_matches_reference(seed):
    (_, jt), (_, tt) = _streams(rand_jax.suggest, T.suggest, 30, seed)
    _assert_same_draws(jt, tt)


def test_rand_speculative_one_draw_per_four_asks():
    """``speculative=4``: the reference's stream, and one prior draw
    for every four sequential asks."""
    (_, jt), (td, tt) = _streams(jpartial(rand_jax.suggest, speculative=4),
                                 H.partial(T.suggest, speculative=4), 30, 2)
    _assert_same_draws(jt, tt)
    assert td._rand_draws == 8  # ceil(30 / 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorize_helper_sample_one_equals_reference(seed):
    """The host sampler ATPE's restarts use: the same config from the
    same numpy rng, on a conditional space."""
    jh, th = JHelper(_conditional(J.hp)), THelper(_conditional(H.hp))
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        assert th.sample_one(tr) == jh.sample_one(jr)
