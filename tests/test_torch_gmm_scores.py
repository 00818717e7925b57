"""The port's EI scoring kernel (hyperopt_tpu_torch.ops.gmm_scores).

Here, on the CPU, ``gmm_llr`` runs its plain version; that version is
held against (a) the TPU kernel it replaces, Pallas ``ei_scores`` in
interpret mode, on the fixtures and tolerances of tests/test_pallas.py
(rtol/atol 2e-4 and 3e-4, equal argmax), (b) the reference's
``gmm_logpdf_cont_pre`` below minus above -- the function the port's
suggest path replaces with the kernel -- at rtol/atol 1e-5, and (c) a
far-tail case that takes the underflow fallback.  The CUDA kernel itself
is held against the plain version in tests/test_torch_cuda.py, which
needs no JAX and runs only where there is a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.pallas_kernels import ei_scores
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.ops import kernels as TK

# (b): the same formula on the same constants; only exp/log's last bits,
# XLA's FMA contraction and the order of the K-sum differ
PLAIN_RTOL = 1e-5

# the reference functions jitted, as the reference runs them
ref_precompute = jax.jit(jax.vmap(JK.gmm_precompute))
ref_cont_pre = jax.jit(jax.vmap(JK.gmm_logpdf_cont_pre))
ref_cont_pre_batched = jax.jit(jax.vmap(jax.vmap(JK.gmm_logpdf_cont_pre), in_axes=(0, None, None)))


def make_row(rng, n_comp, spread=3.0):
    w = rng.uniform(0.1, 1.0, n_comp)
    w = w / w.sum()
    mu = rng.normal(0, spread, n_comp)
    sigma = rng.uniform(0.3, 2.0, n_comp)
    return w, mu, sigma


def _port_pre(w, mu, sigma, low, high):
    f = lambda a: torch.from_numpy(np.array(a, np.float32))
    return TK.gmm_precompute(f(w), f(mu), f(sigma), f(low), f(high))


def test_plain_matches_pallas_rows():
    """tests/test_pallas.py:37-62 fixture (R=4 rows, S=128, 37 untruncated
    components each, zero-weight padding up to 128 lanes inside Pallas),
    as below-minus-above pairs: rtol/atol 2e-4, equal argmax per row."""
    rng = np.random.default_rng(0)
    R, S, n_comp = 4, 128, 37
    below = [make_row(rng, n_comp) for _ in range(R)]
    above = [make_row(rng, n_comp) for _ in range(R)]
    x = rng.normal(0, 3.0, (R, S)).astype(np.float32)

    def stack(rows):
        return tuple(np.stack([r[i] for r in rows]).astype(np.float32) for i in range(3))

    (wb, mb, sb), (wa, ma, sa) = stack(below), stack(above)
    lm = np.zeros((R, n_comp), np.float32)  # untruncated
    want = np.asarray(ei_scores(
        jnp.asarray(x), tuple(map(jnp.asarray, (wb, mb, sb, lm))),
        tuple(map(jnp.asarray, (wa, ma, sa, lm))), interpret=True))

    inf = np.full(R, np.inf, np.float32)
    got = G.gmm_llr(
        torch.from_numpy(x)[None], torch.zeros(R, dtype=torch.bool),
        _port_pre(wb, mb, sb, -inf, inf), _port_pre(wa, ma, sa, -inf, inf),
    )[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_plain_matches_pallas_parzen_pipeline():
    """tests/test_pallas.py:89-131 fixture: real Parzen fits, truncated to
    [-8, 10], candidates drawn from the below model: rtol/atol 3e-4 and
    the argmax agrees."""
    rng = np.random.default_rng(2)
    cap = 64
    obs = jnp.asarray(rng.normal(1.0, 2.0, cap), jnp.float32)
    below_mask = jnp.asarray(np.arange(cap) < 8)
    above_mask = jnp.asarray((np.arange(cap) >= 8) & (np.arange(cap) < 40))
    pm, psig, pw, lf = (jnp.float32(v) for v in (0.0, 8.0, 1.0, 25.0))
    fit = jax.jit(JK.parzen_fit)
    wb, mb, sb = fit(obs, below_mask, pm, psig, pw, lf)
    wa, ma, sa = fit(obs, above_mask, pm, psig, pw, lf)
    lo, hi = jnp.float32(-8.0), jnp.float32(10.0)
    samples = JK.trunc_gmm_sample(
        jax.random.key(0), wb, mb, sb, lo, hi, jnp.asarray(False), jnp.float32(0.0), 128)

    def lmass(mu, sig):
        from jax.scipy.special import ndtr

        return jnp.log(jnp.maximum(ndtr((10.0 - mu) / sig) - ndtr((-8.0 - mu) / sig), 1e-30))

    want = np.asarray(ei_scores(
        samples[None], (wb[None], mb[None], sb[None], lmass(mb, sb)[None]),
        (wa[None], ma[None], sa[None], lmass(ma, sa)[None]), interpret=True))[0]

    one = lambda v: np.full(1, v, np.float32)
    got = G.gmm_llr(
        torch.from_numpy(np.array(samples))[None, None],
        torch.zeros(1, dtype=torch.bool),
        _port_pre(np.asarray(wb)[None], np.asarray(mb)[None], np.asarray(sb)[None], one(-8), one(10)),
        _port_pre(np.asarray(wa)[None], np.asarray(ma)[None], np.asarray(sa)[None], one(-8), one(10)),
    )[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert int(np.argmax(got)) == int(np.argmax(want))


def _ref_and_port_pre(seed, dims=6, k_b=9, k_a=40):
    """Reference gmm_precompute outputs for below/above mixtures of
    ``dims`` dims (half of them log-space), and the same numbers as the
    port's dicts."""
    rng = np.random.default_rng(seed)
    low = np.array([-5.0, -5.0, -3.0] * (dims // 3), np.float32)
    high = np.array([5.0, 2.0, 8.0] * (dims // 3), np.float32)
    logspace = np.array([False, True, False] * (dims // 3))
    pres = []
    for k in (k_b, k_a):
        w = rng.uniform(0.1, 1, (dims, k)).astype(np.float32)
        w[:, k - 2:] = 0.0  # zero-weight padding
        w /= w.sum(-1, keepdims=True)
        mu = rng.uniform(low[:, None], high[:, None], (dims, k)).astype(np.float32)
        sig = rng.uniform(0.2, 3.0, (dims, k)).astype(np.float32)
        pres.append(ref_precompute(*map(jnp.asarray, (w, mu, sig, low, high))))
    to_port = lambda pre: {k: torch.from_numpy(np.array(pre[k])) for k in G._PRE_KEYS}
    return low, high, logspace, pres, [to_port(p) for p in pres]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_reference_cont_pre(seed):
    """(b) below minus above of the reference's gmm_logpdf_cont_pre, on
    its own precomputed constants, candidates [B=3, Dg=6, S=128]."""
    low, high, logspace, (jb, ja), (tb, ta) = _ref_and_port_pre(seed)
    rng = np.random.default_rng(seed + 10)
    nat_lo = np.where(logspace, np.exp(low), low)
    nat_hi = np.where(logspace, np.exp(high), high)
    x = rng.uniform(nat_lo[None, :, None], nat_hi[None, :, None], (3, 6, 128)).astype(np.float32)
    ls = jnp.asarray(logspace)
    want = np.asarray(ref_cont_pre_batched(jnp.asarray(x), jb, ls)
                      - ref_cont_pre_batched(jnp.asarray(x), ja, ls))
    got = G.gmm_llr(torch.from_numpy(x), torch.from_numpy(logspace), tb, ta).numpy()
    np.testing.assert_allclose(got, want, rtol=PLAIN_RTOL, atol=PLAIN_RTOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_far_tail_underflow_fallback():
    """(c) candidates ~50 sigma from every component: every term
    underflows, the sum fails ``> 1e-38`` and the score falls back to the
    largest shifted term -- as the reference's main path does (the Pallas
    kernel's log(1e-30) floor would flatten these to a constant)."""
    w = np.array([[0.5, 0.5, 0.0]], np.float32)
    mu = np.array([[0.0, 0.1, 0.0]], np.float32)
    sig = np.array([[0.01, 0.02, 1.0]], np.float32)
    lo, hi = np.full(1, -np.inf, np.float32), np.full(1, np.inf, np.float32)
    jpre = ref_precompute(*map(jnp.asarray, (w, mu, sig, lo, hi)))
    x = np.linspace(1.0, 3.0, 16, dtype=np.float32)[None]
    ls = np.zeros(1, bool)
    want = np.asarray(ref_cont_pre(jnp.asarray(x), jpre, jnp.asarray(ls)))
    tpre = {k: torch.from_numpy(np.array(jpre[k])) for k in G._PRE_KEYS}
    got = G.gmm_logpdf_cont_pre(torch.from_numpy(x), tpre, torch.from_numpy(ls)).numpy()
    assert np.all(np.isfinite(got)) and np.all(np.diff(got[0]) < 0)  # ordering kept
    np.testing.assert_allclose(got, want, rtol=PLAIN_RTOL)
    # the llr of two such mixtures stays finite and ordered
    llr = G.gmm_llr(torch.from_numpy(x)[None], torch.from_numpy(ls), tpre,
                    {k: v.clone() for k, v in tpre.items()})
    np.testing.assert_allclose(llr.numpy(), 0.0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    _, _, logspace, _, (tb, ta) = _ref_and_port_pre(0)
    x = torch.rand(2, 6, 16)
    before = G.KERNEL.launches
    out = G.gmm_llr(x, torch.from_numpy(logspace), tb, ta)
    assert G.KERNEL.launches == before
    assert torch.equal(out, G.gmm_llr_plain(x, torch.from_numpy(logspace), tb, ta))
