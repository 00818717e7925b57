"""The fixed-order reductions of the port's TPE math (``tree_sum``,
``ladder_cumsum``) and the compiled loop's ``history_summary``.

On the card, ``ops/kernels.py`` sums and scans along a history or
component axis with these helpers, so that a study's slice of a stacked
state carries the bits of the same study alone (PyTorch's CUDA
reductions pick their order from the whole tensor's shape).  The order
is a function of the row's length only, which the CPU shows as well as
the card: a slice of an ``[N, ...]`` input gives the bits of that slice
alone, for N in {1, 7, 64}.  Against ``torch.sum``/``torch.cumsum`` (a
different order) the results agree within ORDER_RTOL.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu_torch.ops import kernels as TK

# float32 sums of up to 1025 positive terms in two orders: a few ulp of
# the sum each way
ORDER_RTOL = 1e-5


def _rows(n, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (n,) + shape).astype(np.float32))


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("shape,dim", [((3, 513), -1), ((3, 17), -1), ((3, 1025, 5), -2),
                                       ((2, 8), -1)])
def test_tree_sum_slices_are_bitwise_alone(n, shape, dim):
    x = _rows(n, shape, seed=n)
    full = TK.tree_sum(x, dim=dim)
    for i in range(n):
        assert torch.equal(full[i], TK.tree_sum(x[i], dim=dim)), i
    np.testing.assert_allclose(full.numpy(), torch.sum(x, dim=dim).numpy(), rtol=ORDER_RTOL)
    kept = TK.tree_sum(x, dim=dim, keepdim=True)
    assert kept.shape == torch.sum(x, dim=dim, keepdim=True).shape


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("shape,dim", [((3, 513), -1), ((3, 1025, 5), -2), ((2, 8), -1)])
def test_ladder_cumsum_slices_are_bitwise_alone(n, shape, dim):
    x = _rows(n, shape, seed=100 + n)
    full = TK.ladder_cumsum(x, dim=dim)
    for i in range(n):
        assert torch.equal(full[i], TK.ladder_cumsum(x[i], dim=dim)), i
    np.testing.assert_allclose(full.numpy(), torch.cumsum(x, dim=dim).numpy(), rtol=ORDER_RTOL)


def test_tree_sum_edges():
    assert TK.tree_sum(torch.zeros(4, 0)).shape == (4,)
    assert torch.equal(TK.tree_sum(torch.zeros(4, 0)), torch.zeros(4))
    x = torch.tensor([[1.0], [2.0]])
    assert torch.equal(TK.tree_sum(x), torch.tensor([1.0, 2.0]))
    assert torch.equal(TK.ladder_cumsum(x), x)


def test_cpu_keeps_torch_reductions():
    """On CPU tensors the fits keep ``torch.sum``/``torch.cumsum``, so
    the CPU parity with the reference does not move."""
    x = _rows(5, (3, 513), seed=9)
    assert torch.equal(TK.sum_rows(x, dim=-1), torch.sum(x, dim=-1))
    assert torch.equal(TK.cumsum_rows(x, dim=-1), torch.cumsum(x, dim=-1))


@pytest.mark.parametrize("n_valid,n_fail", [(0, 0), (10, 3), (10, 10)])
def test_history_summary_matches_reference(n_valid, n_fail):
    rng = np.random.default_rng(n_valid + n_fail)
    cap = 32
    losses = rng.normal(size=cap).astype(np.float32)
    losses[:n_fail] = np.nan
    valid = np.arange(cap) < n_valid
    st = TK.HistoryState(torch.zeros(2, cap), torch.zeros(2, cap, dtype=torch.bool),
                         torch.from_numpy(losses), torch.from_numpy(valid))
    best, done = TK.history_summary(st)
    j_best, j_done = JK.history_summary(JK.HistoryState(
        jnp.zeros((2, cap)), jnp.zeros((2, cap), bool), jnp.asarray(losses), jnp.asarray(valid)))
    assert int(done) == int(j_done) == n_valid
    assert float(best) == float(j_best)
