"""The port's space compiler (hyperopt_tpu_torch.ops.compile) against the
reference's: packed fields equal, prior draws equal.

Each space is built twice, once with each package's ``hp`` (the packages
have separate pyll scopes).  Prior draws: ``active`` and categorical
values exactly equal; continuous values within rtol/atol 1e-6 -- one
float32 rounding, because XLA contracts ``low + u * (high - low)`` into an
FMA and its ``exp`` differs from PyTorch's in the last bit.
"""

import numpy as np
import pytest

import jax
import torch

import hyperopt_tpu as J
import hyperopt_tpu_torch as H
from hyperopt_tpu.models.synthetic import mixed_space as j_mixed_space
from hyperopt_tpu.ops.compile import compile_space as j_compile
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.models.synthetic import mixed_space as t_mixed_space
from hyperopt_tpu_torch.ops.compile import CONST_FIELDS, compile_space as t_compile

NUMPY_FIELDS = CONST_FIELDS + ("kind", "k_max", "a_max", "c_max", "unconditional")


def nested_space(hp):
    """Conditional space: a choice whose branches hold further choices,
    a normal-family (unbounded) dim, a log dim and a quantized one."""
    return hp.choice("model", [
        {"kind": "a", "x": hp.uniform("x", -3, 3), "lr": hp.loguniform("lr", -6, 0)},
        {"kind": "b", "depth": hp.quniform("depth", 1, 10, 1),
         "act": hp.choice("act", [{"noise": hp.normal("noise", 0, 2)}, "tanh"])},
        {"kind": "c", "w": hp.pchoice("w", [(0.2, "s"), (0.8, "l")]),
         "n": hp.randint("n", 3, 9)},
    ])


SPACES = {
    "mixed": (lambda: j_mixed_space(), lambda: t_mixed_space()),
    "nested": (lambda: nested_space(J.hp), lambda: nested_space(H.hp)),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_packed_fields_equal(name):
    jbuild, tbuild = SPACES[name]
    jps, tps = j_compile(jbuild()), t_compile(tbuild(), device="cpu")
    assert jps.labels == tps.labels
    for f in NUMPY_FIELDS:
        a, b = getattr(jps, f), getattr(tps, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
    for f in CONST_FIELDS:  # the device copies hold the same values
        assert np.array_equal(np.asarray(getattr(jps, f)), tps.consts[f].numpy()), f


@pytest.mark.parametrize("name", sorted(SPACES))
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_prior_draws_match(name, seed):
    jbuild, tbuild = SPACES[name]
    jps, tps = j_compile(jbuild()), t_compile(tbuild(), device="cpu")
    n = 64
    jv, ja = jps.sample_prior(jax.random.key(seed), n)
    tv, ta = tps.sample_prior(R.key(seed, device="cpu"), n)
    jv, ja, tv, ta = np.asarray(jv), np.asarray(ja), tv.numpy(), ta.numpy()
    assert np.array_equal(ja, ta)
    assert np.array_equal(jv[jps.cat_idx], tv[tps.cat_idx])
    np.testing.assert_allclose(tv[tps.cont_idx], jv[jps.cont_idx], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_active_fn_matches(seed):
    """active_fn on arbitrary dense values (choice indices drawn at
    random, including out-of-branch combinations)."""
    jps, tps = j_compile(nested_space(J.hp)), t_compile(nested_space(H.hp), device="cpu")
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, size=(jps.n_dims, 200)).astype(np.float32)
    want = np.asarray(jps.active_fn(jax.numpy.asarray(vals)))
    got = tps.active_fn(torch.from_numpy(vals)).numpy()
    assert np.array_equal(want, got)
