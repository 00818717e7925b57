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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Ka", [(64, 128, 512), (3, 100, 1300), (1, 7, 1)])
def test_cuda_kernel_matches_plain(cuda, B, S, Ka):
    """The hand-written kernel against the plain version on the card: the
    main path's shapes, a ragged edge with K above one shared-memory
    chunk, and a one-component mixture.  Both round every multiply and
    add separately (the kernel is built with -fmad=false); the order of
    the K-sum and expf/logf's last bits differ: rtol/atol 1e-5."""
    x, ls, pb, pa = _inputs(cuda, B=B, S=S, Ka=Ka)
    before = G.KERNEL.launches
    got = G.gmm_llr(x, ls, pb, pa)
    torch.cuda.synchronize()
    assert G.KERNEL.launches == before + 1
    want = G.gmm_llr_plain(x, ls, pb, pa)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)


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
