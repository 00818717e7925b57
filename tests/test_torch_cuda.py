"""Tests of the port that need the card (marker ``cuda``).

They skip, inside the test, where ``torch.cuda.is_available()`` is false.
They import no JAX, so the machine with the card runs them with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.ops import kernels as TK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def subnormal_band_case(k=512, device="cpu"):
    """Every term of the above mixture lies below 2**-126 (t about
    -88.5) while their sum, some ``k * 3.7e-39``, is far above 1e-38: a
    flushed exp would take the fallback where the plain version takes
    the log of the sum, log(k) apart."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    rng = np.random.default_rng(5)
    mu = rng.uniform(-0.01, 0.01, (1, k))
    inf = np.full(1, np.inf)
    pre_a = TK.gmm_precompute(f(np.full((1, k), 1.0 / k)), f(mu), f(np.ones((1, k))),
                              f(-inf), f(inf))
    pre_b = TK.gmm_precompute(f([[1.0]]), f([[13.0]]), f([[1.0]]), f(-inf), f(inf))
    x = f(np.linspace(13.29, 13.32, 8))[None, None]
    return (x, torch.zeros(1, dtype=torch.bool, device=device),
            {k_: pre_b[k_].contiguous() for k_ in G._PRE_KEYS},
            {k_: pre_a[k_].contiguous() for k_ in G._PRE_KEYS})


def _inputs(device, B=64, Dg=12, S=128, Kb=9, Ka=512, seed=3):
    """One unquantized group at the main path's shapes for a 500-obs
    history of the 20-dim mixed space: 8 uniform and 4 log-space dims."""
    rng = np.random.default_rng(seed)
    logspace = np.arange(Dg) % 3 == 1
    low = np.full(Dg, -5.0, np.float32)
    high = np.where(logspace, 2.0, 5.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    pres = []
    for k in (Kb, Ka):
        w = rng.uniform(0.05, 1.0, (Dg, k))
        w[:, k - 2:] = 0.0  # zero-weight padding
        w /= w.sum(-1, keepdims=True)
        mu = rng.uniform(low[:, None], high[:, None], (Dg, k))
        sig = rng.uniform(0.05, 3.0, (Dg, k))
        pre = TK.gmm_precompute(t(w), t(mu), t(sig), t(low), t(high))
        pres.append({k_: pre[k_].contiguous() for k_ in G._PRE_KEYS})
    lo = np.where(logspace, np.exp(low), low)[None, :, None]
    hi = np.where(logspace, np.exp(high), high)[None, :, None]
    x = t(rng.uniform(lo, hi, (B, Dg, S)))
    return x, torch.from_numpy(logspace).to(device), pres[0], pres[1]


def _assert_close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Dg,S,Kb,Ka", [
    (64, 12, 128, 9, 512),   # suggest_batch at B=64
    (3, 12, 100, 9, 1300),   # a ragged edge, both mixtures past one staging
    (1, 12, 7, 9, 1),        # a one-component mixture
    (1, 12, 128, 17, 512),   # the sequential ask
    (2, 3, 64, 9, 5000),     # the above mixture staged in three chunks
    (5, 1, 37, 9, 40),       # one dim, a ragged S
])
def test_cuda_kernel_matches_plain(cuda, B, Dg, S, Kb, Ka):
    """The hand-written kernel against the plain version on the card at
    the kernel's stated tolerance (``G.KERNEL_ATOL``: the exp is
    ``ex2.approx`` of a float32 ``t * log2(e)``; derivation in
    ops/gmm_scores.py)."""
    x, ls, pb, pa = _inputs(cuda, B=B, Dg=Dg, S=S, Kb=Kb, Ka=Ka)
    before = G.KERNEL.launches
    got = G.gmm_llr(x, ls, pb, pa)
    torch.cuda.synchronize()
    assert G.KERNEL.launches == before + 1
    _assert_close(got, G.gmm_llr_plain(x, ls, pb, pa))


@pytest.mark.cuda
@pytest.mark.parametrize("config", G.CONFIGS, ids=lambda c: f"k_lanes{c[0]}-rows{c[1]}")
def test_cuda_every_config_matches_plain(cuda, config):
    """Each split the kernel is compiled for, whichever the wrapper would
    pick, on a ragged shape with a chunked above mixture."""
    x, ls, pb, pa = _inputs(cuda, B=3, Dg=4, S=90, Kb=17, Ka=2100)
    out = torch.empty_like(x)
    assert G.launch(x, ls, pb, pa, out, config) == 0
    torch.cuda.synchronize()
    _assert_close(out, G.gmm_llr_plain(x, ls, pb, pa))


@pytest.mark.cuda
def test_cuda_subnormal_band(cuda):
    """Terms each below 2**-126 whose sum is far above 1e-38: the kernel
    takes the log of the sum, as the plain version does, not the
    fallback that a flushed exp would reach (about log(512) away)."""
    x, ls, pb, pa = subnormal_band_case(device=cuda)
    want = G.gmm_llr_plain(x, ls, pb, pa)
    _assert_close(G.gmm_llr(x, ls, pb, pa), want)
    for config in G.CONFIGS:
        out = torch.empty_like(x)
        assert G.launch(x, ls, pb, pa, out, config) == 0
        _assert_close(out, want)


@pytest.mark.cuda
def test_cuda_two_launches_are_bitwise_equal(cuda):
    """No atomics and a fixed combine order: the same inputs give the
    same bits on every launch."""
    for shape in (dict(B=1, Kb=17), dict(B=64), dict(B=3, S=100, Ka=2100)):
        x, ls, pb, pa = _inputs(cuda, **shape)
        first = G.gmm_llr(x, ls, pb, pa)
        second = G.gmm_llr(x, ls, pb, pa)
        assert torch.equal(first, second), shape


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, ls, pb, pa = _inputs(cuda, B=2, S=16)
    with pytest.raises(ValueError):
        G.gmm_llr(x.transpose(0, 2).contiguous().transpose(0, 2), ls, pb, pa)  # strided
    with pytest.raises(ValueError):
        G.gmm_llr(x.double(), ls, pb, pa)
    with pytest.raises(ValueError):
        G.gmm_llr(x, ls, pb, {**pa, "c1max": pa["c1max"].cpu()})


@pytest.mark.cuda
def test_cuda_fmin_runs_through_the_kernel(cuda):
    """A short fmin on the card: one kernel launch per TPE ask."""
    G.KERNEL.launches = 0
    trials = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=30,
           trials=trials, rstate=np.random.default_rng(0))
    assert len(trials.trials) == 30
    assert G.KERNEL.launches == 10
