"""The port's EI scoring kernel (hyperopt_tpu_torch.ops.gmm_scores).

Here, on the CPU, ``gmm_llr`` runs its plain version; that version is
held against (a) the TPU kernel it replaces, Pallas ``ei_scores`` in
interpret mode, on the fixtures and tolerances of tests/test_pallas.py
(rtol/atol 2e-4 and 3e-4, equal argmax), (b) the reference's
``gmm_logpdf_cont_pre`` below minus above -- the function the port's
suggest path replaces with the kernel -- at rtol/atol 1e-5, and (c) a
far-tail case that takes the underflow fallback, and (d) a torch
emulation of the CUDA kernel's arithmetic -- split-K partial sums in its
combine order, ``exp`` as ``ex2.approx.ftz`` of the float32 ``t *
log2(e)``, and its far-tail pass -- at the tolerance the kernel states
(``G.KERNEL_RTOL``/``G.KERNEL_ATOL``).  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py, which needs no
JAX and runs only where there is a card.
"""

import itertools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu.ops.pallas_kernels import ei_scores
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.ops import kernels as TK
from test_torch_cuda import subnormal_band_case

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


# -- (d) the CUDA kernel's arithmetic, emulated ------------------------------

HALF_LOG2E = torch.tensor(math.log2(math.e) / 2, dtype=torch.float32)
TINY_NORMAL = 2.0 ** -126


def _ex2_ftz(a):
    """``ex2.approx.ftz.f32``: 2**a with subnormal results flushed to 0."""
    e = torch.exp2(a)
    return torch.where(e < TINY_NORMAL, 0.0, e)


def _lane_combine(terms, g, op):
    """Lane ``kl`` of ``g`` folds components ``kl, kl + g, ...`` in turn
    from ``init``; the ``g`` partials then meet in the xor butterfly
    (offsets 1, 2, ..., g/2), as the kernel's shuffles do."""
    k = terms.shape[-1]
    init = 0.0 if op is torch.add else -math.inf
    pad = (-k) % g
    if pad:
        terms = torch.cat([terms, terms.new_full((*terms.shape[:-1], pad), init)], -1)
    lanes = terms.reshape(*terms.shape[:-1], -1, g)
    acc = lanes.new_full((*lanes.shape[:-2], g), init)
    for i in range(lanes.shape[-2]):
        acc = op(acc, lanes[..., i, :])
    o = 1
    while o < g:
        acc = op(acc, acc[..., torch.arange(g) ^ o])
        o *= 2
    return acc[..., 0]


def _emulated_ll(lat, pre, g, tail_pass=True):
    """log(sum exp t) (or the largest t) of each candidate ``lat [B, Dg,
    S]`` under one mixture, computed as the kernel computes it."""
    cd2 = 2.0 * (pre["c1"] - pre["c1max"][:, None])
    z = lat[..., None] * pre["inv_s"][:, None, :] - pre["mu_inv_s"][:, None, :]
    u = cd2[:, None, :] - z * z  # 2t, exactly
    a = u * HALF_LOG2E
    sm = _lane_combine(_ex2_ftz(a), g, torch.add)
    ll = torch.log(sm)
    if not tail_pass:
        return torch.where(sm > 1e-38, ll, 0.5 * torch.amax(u, -1))
    k = pre["c1"].shape[-1]
    sm_tail = _lane_combine(_ex2_ftz(a + 64.0), g, torch.add) * 2.0 ** -64
    top = 0.5 * _lane_combine(u, g, torch.maximum)
    ll_tail = torch.where(sm_tail > 1e-38, torch.log(sm_tail), top)
    return torch.where(sm < k * 2.0 ** -100, ll_tail, ll)


def _emulated_llr(x, logspace, pre_b, pre_a, g, tail_pass=True):
    ls = logspace[:, None]
    lat = torch.where(ls, torch.log(torch.clamp(x, min=1e-30)), x)
    jac = torch.where(ls, lat, 0.0)
    ll_b = _emulated_ll(lat, pre_b, g, tail_pass)
    ll_a = _emulated_ll(lat, pre_a, g, tail_pass)
    return ((pre_b["c1max"][:, None] + ll_b - jac)
            - (pre_a["c1max"][:, None] + ll_a - jac))


def _mixtures(seed, dims, k_b, k_a):
    """Below/above constants of ``dims`` dims (every third log-space) as
    the main path makes them, and in-bounds candidates' bounds."""
    rng = np.random.default_rng(seed)
    logspace = np.arange(dims) % 3 == 1
    low = np.full(dims, -5.0, np.float32)
    high = np.where(logspace, 2.0, 5.0).astype(np.float32)
    pres = []
    for k in (k_b, k_a):
        w = rng.uniform(0.05, 1.0, (dims, k))
        if k > 2:
            w[:, k - 2:] = 0.0  # zero-weight padding
        w /= w.sum(-1, keepdims=True)
        mu = rng.uniform(low[:, None], high[:, None], (dims, k))
        sig = rng.uniform(0.05, 3.0, (dims, k))
        pres.append({k_: v.contiguous() for k_, v in _port_pre(w, mu, sig, low, high).items()
                     if k_ in G._PRE_KEYS})
    return rng, logspace, low, high, pres


def _shape_case(B, Dg, S, Ka):
    rng, logspace, low, high, (pb, pa) = _mixtures(B * 1000 + Dg * 100 + S + Ka, Dg, 9, Ka)
    lo = np.where(logspace, np.exp(low), low)[None, :, None]
    hi = np.where(logspace, np.exp(high), high)[None, :, None]
    # a few candidates far outside the bounds, where the sums get small
    x = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (B, Dg, S))
    x = np.where(logspace[None, :, None], np.abs(x), x).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(logspace), pb, pa


def _far_tail_case():
    """test_far_tail_underflow_fallback's mixture, below and above."""
    f = lambda a: torch.from_numpy(np.array(a, np.float32))
    pre = TK.gmm_precompute(f([[0.5, 0.5, 0.0]]), f([[0.0, 0.1, 0.0]]), f([[0.01, 0.02, 1.0]]),
                            f([-np.inf]), f([np.inf]))
    pre_b = {k: pre[k] for k in G._PRE_KEYS}
    pre_a = TK.gmm_precompute(f([[0.3, 0.7]]), f([[-0.05, 0.05]]), f([[0.015, 0.03]]),
                              f([-np.inf]), f([np.inf]))
    x = torch.linspace(1.0, 3.0, 16, dtype=torch.float32)[None, None]
    return x, torch.zeros(1, dtype=torch.bool), pre_b, {k: pre_a[k] for k in G._PRE_KEYS}


_EMU_CASES = [pytest.param(("shape", B, Dg, S, Ka), id=f"B{B}-Dg{Dg}-S{S}-Ka{Ka}")
              for B, Dg, S, Ka in itertools.product((1, 3), (1, 6), (7, 128), (1, 40, 600))]
_EMU_CASES += [pytest.param(("far_tail",), id="far_tail"),
               pytest.param(("subnormal_band",), id="subnormal_band")]
_K_LANES = sorted({g for g, _ in G.CONFIGS})


@pytest.mark.parametrize("case", _EMU_CASES)
def test_kernel_arithmetic_emulated_matches_plain(case):
    """(d) the kernel's arithmetic at every split it is compiled for,
    against the plain version at the kernel's stated tolerance."""
    if case[0] == "shape":
        x, ls, pb, pa = _shape_case(*case[1:])
    elif case[0] == "far_tail":
        x, ls, pb, pa = _far_tail_case()
    else:
        x, ls, pb, pa = subnormal_band_case()
    want = G.gmm_llr_plain(x, ls, pb, pa)
    assert torch.isfinite(want).all()
    for g in _K_LANES:
        got = _emulated_llr(x, ls, pb, pa, g)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL, err_msg=f"k_lanes {g}")
    if case[0] != "shape":
        # the fixture reaches the far-tail pass, and without it the
        # flushed exp would be wrong: by the fallback's gap, about log K
        flushed = _emulated_llr(x, ls, pb, pa, 1, tail_pass=False)
        gap = (flushed - want).abs().max()
        assert gap > 1.0 if case[0] == "subnormal_band" else gap == 0.0


@pytest.mark.parametrize("B,Dg,S", [(1, 12, 128), (64, 12, 128), (4096, 12, 128), (1, 1, 7),
                                    (3, 1, 100)])
def test_launch_config_fills_the_card(B, Dg, S):
    """The split the wrapper picks on a 132-SM H100: the most candidates
    per warp that still give each SM several blocks, and at the
    sequential ask's shape (B=1) blocks on every SM."""
    g, r = G.launch_config(B * S, Dg, 132)
    assert (g, r) in G.CONFIGS
    blocks = lambda g_, r_: -(-B * S // (32 // g_ * r_ * G._WARPS)) * Dg
    if B * S * Dg >= 132 * G._WARPS:
        assert blocks(g, r) >= 132
    for fg, fr in G.CONFIGS:  # every split with more candidates per warp gives too few
        if 32 // fg * fr > 32 // g * r:
            assert blocks(fg, fr) < G._BLOCKS_PER_SM * 132
